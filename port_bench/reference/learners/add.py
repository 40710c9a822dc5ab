"""The plain reference of one training iteration's learning under
``disc_mode: add`` (ADD + PPO), written from the method's semantics and
sharing no code with the program: the obs and disc-difference
normalizers, the actor's log-probabilities of the actions taken, the disc
reward, TD(lambda) returns and normalized advantages, then epochs of
minibatch steps of the clipped PPO loss, the critic loss and the
discriminator loss (BCE, gradient penalty, logit and weight decay), each
followed by a global-norm clip and an Adam step.

Supported: a fixed action std, ``optimizer`` ``adam`` or ``fused_adam``
(one step under two names), ``minibatch_blocks: auto`` and one rank;
anything else raises.

It works in float64.  Where the configuration runs a trunk in bf16
(``mixed_precision`` for the actor and critic, ``disc_mixed_precision``
for the disc), it rounds what bf16 rounds: each hidden layer's input,
weights, bias and output, and through autograd the gradients at the same
points, with the products summed in float64.  Heads, losses, normalizers
and Adam are float64 throughout.

From the program's rollout it reads only what the rollout recorded as it
acted (``TRAJ_KEYS`` and the raw observations); from the benchmark the
initial weights and the minibatch order of each iteration.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TRAJ_KEYS = ("norm_a", "a_logp", "rand_mask", "reward", "done", "disc_diff")
DATA_KEYS = ("adv", "tar_val", "reward")    # what it compares of the program's train data
WIDTHS = {"fc_2layers_1024units": (1024, 512), "fc_3layers_1024units": (1024, 1024, 512)}
FAIL, SUCC = 1, 2           # done flags of a terminal state; 0 is "not done"
F64 = torch.float64


def _bf(x):
    return x.to(torch.bfloat16).to(F64)


def _agent(cfg: dict) -> dict:
    a = dict(cfg["agent"])
    for key, allowed in (("disc_mode", ("add",)), ("actor_std_type", ("fixed",)),
                         ("optimizer", ("adam", "fused_adam")), ("minibatch_blocks", ("auto",))):
        if a.get(key, allowed[0]) not in allowed:
            raise ValueError(f"the reference's add learner takes {key} in {allowed}, "
                             f"not {a[key]!r}")
    return a


def param_shapes(cfg: dict, obs_dim: int, disc_dim: int, act_dim: int) -> list:
    """[(name, shape)] of every parameter, hidden widths by net name."""
    a = _agent(cfg)
    out = []

    def trunk(prefix, net, d):
        for i, w in enumerate(WIDTHS[net]):
            out.extend([(f"{prefix}.layers.{i}.weight", (w, d)), (f"{prefix}.layers.{i}.bias", (w,))])
            d = w
        return d

    h = trunk("actor_trunk", a["actor_net"], obs_dim)
    out += [("actor_mean.weight", (act_dim, h)), ("actor_mean.bias", (act_dim,))]
    h = trunk("critic_trunk", a["critic_net"], obs_dim)
    out += [("critic_out.weight", (1, h)), ("critic_out.bias", (1,))]
    h = trunk("disc_trunk", a["disc_net"], disc_dim)
    out += [("disc_logit.weight", (1, h)), ("disc_logit.bias", (1,))]
    return out


def shuffle_block(rows: int, num_batches: int, env_count: int) -> int:
    """Rows per shuffle block: 32 or else 8 where it tiles a minibatch
    and divides the env count (adjacent envs at one step), else 1."""
    if rows % num_batches == 0:
        mb = rows // num_batches
        for b in (32, 8):
            if mb % b == 0 and env_count % b == 0:
                return b
    return 1


def shuffle_shape(cfg: dict, num_envs: int):
    """(epochs, shuffle blocks) of one iteration's minibatch order."""
    a = _agent(cfg)
    T = int(a["steps_per_iter"])
    nb = math.ceil(T / int(a["batch_size"]))
    return int(a["update_epochs"]), T * num_envs // shuffle_block(T * num_envs, nb, num_envs)


class Learner:
    """The reference's parameters, Adam moments, normalizers and sample
    count, from the initial ``weights`` (name -> tensor)."""

    def __init__(self, cfg: dict, weights: dict, device):
        a = _agent(cfg)
        self.dev = torch.device(device)
        self.c = {k: float(a[k]) for k in (
            "discount", "td_lambda", "ppo_clip_ratio", "norm_adv_clip", "action_bound_weight",
            "action_entropy_weight", "action_reg_weight", "critic_loss_weight",
            "learning_rate", "grad_clip", "disc_loss_weight", "disc_logit_reg",
            "disc_grad_penalty", "disc_weight_decay", "disc_reward_scale",
            "task_reward_weight", "disc_reward_weight", "action_std", "normalizer_samples")}
        self.epochs, self.batch_size = int(a["update_epochs"]), int(a["batch_size"])
        self.bf16 = dict(actor=bool(a.get("mixed_precision", False)),
                         critic=bool(a.get("mixed_precision", False)),
                         disc=bool(a.get("disc_mixed_precision", False)))
        self.p = {n: w.to(self.dev, F64).clone().requires_grad_(True) for n, w in weights.items()}
        self.net = self.p           # the parameters the networks run on
        self.mu = {n: torch.zeros_like(p) for n, p in self.p.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.p.items()}
        self.steps = 0
        self.first_loss = self.first_mu = None    # of the first minibatch step
        obs_dim = self.p["actor_trunk.layers.0.weight"].shape[1]
        disc_dim = self.p["disc_trunk.layers.0.weight"].shape[1]
        z = lambda d: torch.zeros(d, dtype=F64, device=self.dev)
        self.obs_norm = dict(count=z(()), mean=z(obs_dim), mean_sq=z(obs_dim) + 1.0)
        self.diff_norm = dict(count=z(()), mean_abs=z(disc_dim) + 1.0)
        self.sample_count = 0

    # ------------------------------------------------------------ networks

    def _trunk(self, prefix, x, bf16):
        i = 0
        while f"{prefix}.layers.{i}.weight" in self.net:
            w, b = self.net[f"{prefix}.layers.{i}.weight"], self.net[f"{prefix}.layers.{i}.bias"]
            if bf16:
                x = F.relu(_bf(_bf(x) @ _bf(w).T + _bf(b)))
            else:
                x = F.relu(x @ w.T + b)
            i += 1
        return x

    def _head(self, name, h):
        return h @ self.net[f"{name}.weight"].T + self.net[f"{name}.bias"]

    def actor_mean(self, x):
        return self._head("actor_mean", self._trunk("actor_trunk", x, self.bf16["actor"]))

    def critic(self, x):
        return self._head("critic_out", self._trunk("critic_trunk", x, self.bf16["critic"]))[..., 0]

    def disc(self, x):
        return self._head("disc_logit", self._trunk("disc_trunk", x, self.bf16["disc"]))[..., 0]

    def log_prob(self, mean, a):
        """Diagonal Gaussian with the fixed std."""
        logstd = math.log(self.c["action_std"])
        z = (a - mean) / self.c["action_std"]
        d = mean.shape[-1]
        return -0.5 * (z * z).sum(-1) - 0.5 * d * math.log(2 * math.pi) - d * logstd

    # --------------------------------------------------------- normalizers

    def norm_obs(self, x):
        n = self.obs_norm
        var = torch.clamp_min(n["mean_sq"] - n["mean"] * n["mean"], 1e-8)
        return (x.to(self.dev, F64) - n["mean"]) / torch.sqrt(var)

    def norm_diff(self, x):
        return x.to(self.dev, F64) / torch.clamp_min(self.diff_norm["mean_abs"], 1e-4)

    # ---------------------------------------------------------- train data

    @torch.no_grad()
    def train_data(self, obs, next_obs, traj, params=None) -> dict:
        """The iteration's train data from the rollout: ``obs`` and
        ``next_obs`` [T, N, obs_dim] (the observations acted on and those
        after each step, before any reset), ``traj`` the recorded
        ``TRAJ_KEYS`` [T, N, ...], with the networks on ``params`` (name
        -> tensor) where given, else on the reference's own.  Returns the
        normalized obs as the rollout stores them, the actions, the
        reference's log-probs, rewards, returns and advantages, the disc
        input, and the obs statistics of the iteration."""
        if params is not None:
            self.net = {n: w.to(self.dev, F64) for n, w in params.items()}
        try:
            return self._train_data(obs, next_obs, traj)
        finally:
            self.net = self.p

    def _train_data(self, obs, next_obs, traj) -> dict:
        c = self.c
        T, N = traj["reward"].shape
        keep = _bf if self.bf16["actor"] else (lambda x: x)
        stored, logp, vals, next_vals, s1, s2 = [], [], [], [], 0.0, 0.0
        for t in range(T):
            o = obs[t].to(self.dev, F64)
            no = self.norm_obs(o)
            s1, s2 = s1 + o.sum(0), s2 + (o * o).sum(0)
            stored.append(keep(no))
            logp.append(self.log_prob(self.actor_mean(no), traj["norm_a"][t].to(self.dev, F64)))
            vals.append(self.critic(stored[-1]))
            next_vals.append(self.critic(keep(self.norm_obs(next_obs[t]))))
        vals, next_vals = torch.stack(vals), torch.stack(next_vals)
        done = traj["done"].to(self.dev)
        next_vals = torch.where((done == FAIL) | (done == SUCC), 0.0, next_vals)

        disc_in = self.norm_diff(traj["disc_diff"])
        prob = torch.sigmoid(torch.cat([self.disc(disc_in[t]) for t in range(T)]).reshape(T, N))
        disc_r = -torch.log(torch.clamp_min(1.0 - prob, 1e-4)) * c["disc_reward_scale"]
        reward = (c["task_reward_weight"] * traj["reward"].to(self.dev, F64)
                  + c["disc_reward_weight"] * disc_r)

        # TD(lambda): an episode's end (any done flag) cuts the trace
        cont = (done == 0).to(F64)
        ret = torch.empty_like(reward)
        ret[T - 1] = reward[T - 1] + c["discount"] * next_vals[T - 1]
        for t in range(T - 2, -1, -1):
            lam = c["td_lambda"] * cont[t]
            ret[t] = reward[t] + c["discount"] * ((1.0 - lam) * next_vals[t] + lam * ret[t + 1])
        adv = ret - vals
        mask = (traj["rand_mask"].to(self.dev) == 1.0).to(F64)
        cnt = torch.clamp_min(mask.sum(), 1.0)
        mean = (adv * mask).sum() / cnt
        std = torch.sqrt(((adv - mean) ** 2 * mask).sum() / torch.clamp_min(cnt - 1.0, 1.0))
        adv = torch.clamp((adv - mean) / torch.clamp_min(std, 1e-5),
                          -c["norm_adv_clip"], c["norm_adv_clip"])
        return dict(norm_obs=torch.stack(stored), norm_a=traj["norm_a"].to(self.dev, F64),
                    a_logp=torch.stack(logp), rand_mask=mask, tar_val=ret, adv=adv,
                    reward=reward, disc_in=disc_in, disc_diff=traj["disc_diff"],
                    obs_stats=(float(T * N), s1, s2))

    # -------------------------------------------------------------- update

    def loss(self, b):
        c = self.c
        critic_loss = torch.mean((b["tar_val"] - self.critic(b["norm_obs"])) ** 2)

        mean = self.actor_mean(b["norm_obs"])
        mask = b["rand_mask"]
        cnt = torch.clamp_min(mask.sum(), 1.0)
        ratio = torch.exp(self.log_prob(mean, b["norm_a"]) - b["a_logp"])
        surr = torch.minimum(b["adv"] * ratio, b["adv"] * torch.clamp(
            ratio, 1.0 - c["ppo_clip_ratio"], 1.0 + c["ppo_clip_ratio"]))
        actor_loss = -(surr * mask).sum() / cnt
        out_of_bounds = (torch.clamp_max(mean + 1.0, 0.0) ** 2 + torch.clamp_min(mean - 1.0, 0.0) ** 2)
        actor_loss = actor_loss + c["action_bound_weight"] * (out_of_bounds.sum(-1) * mask).sum() / cnt
        d = mean.shape[-1]
        entropy = d * math.log(c["action_std"]) + 0.5 * d * (math.log(2 * math.pi) + 1.0)
        actor_loss = (actor_loss - c["action_entropy_weight"] * entropy
                      + c["action_reg_weight"] * (mean * mean).sum(-1).mean())

        # the disc: agent differences are negatives, the zero difference
        # the positive; the penalty pulls |d logit / d input| to 1 there
        x = b["disc_in"].detach().requires_grad_(True)
        neg = self.disc(x)
        grad, = torch.autograd.grad(neg.sum(), x, create_graph=True)
        pos = self.disc(torch.zeros((1, x.shape[-1]), dtype=F64, device=self.dev))
        bce = lambda logit, label: -(label * F.logsigmoid(logit) + (1 - label) * F.logsigmoid(-logit))
        disc_loss = 0.5 * (bce(pos, 0.9).mean() + bce(neg, 0.1).mean())
        w_logit = self.p["disc_logit.weight"]
        penalty = torch.mean((torch.sqrt((grad * grad).sum(-1) + 1e-8) - 1.0) ** 2)
        decay = sum((w * w).sum() for n, w in self.p.items()
                    if n.startswith("disc_trunk.") and n.endswith(".weight")) + (w_logit * w_logit).sum()
        disc_loss = (disc_loss + c["disc_logit_reg"] * (w_logit * w_logit).sum()
                     + c["disc_grad_penalty"] * penalty + c["disc_weight_decay"] * decay)
        return actor_loss + c["critic_loss_weight"] * critic_loss + c["disc_loss_weight"] * disc_loss

    def _adam(self, grads):
        c, b1, b2 = self.c, 0.9, 0.999
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = c["grad_clip"] / torch.clamp_min(norm, c["grad_clip"])
        self.steps += 1
        with torch.no_grad():
            for n, p in self.p.items():
                g = grads[n] * scale
                self.mu[n] = b1 * self.mu[n] + (1 - b1) * g
                self.nu[n] = b2 * self.nu[n] + (1 - b2) * g * g
                m_hat = self.mu[n] / (1 - b1 ** self.steps)
                v_hat = self.nu[n] / (1 - b2 ** self.steps)
                p -= c["learning_rate"] * m_hat / (torch.sqrt(v_hat) + 1e-8)

    def update(self, data: dict, perms) -> float:
        """Epochs of minibatch steps in the order ``perms`` [epochs,
        blocks] gives (a permutation of shuffle blocks of the flat,
        time-major rows, cut into minibatches); returns the mean loss."""
        T, N = data["reward"].shape
        rows = T * N
        nb = math.ceil(T / self.batch_size)
        B = shuffle_block(rows, nb, N)
        per = rows // nb // B
        flat = {k: data[k].reshape((rows,) + data[k].shape[2:])
                for k in ("norm_obs", "norm_a", "a_logp", "rand_mask", "tar_val", "adv", "disc_in")}
        names = list(self.p)
        losses = []
        for e in range(self.epochs):
            perm = perms[e].to(self.dev)
            for k in range(nb):
                blocks = perm[k * per:(k + 1) * per]
                idx = (blocks[:, None] * B + torch.arange(B, device=self.dev)).reshape(-1)
                loss = self.loss({n: v[idx] for n, v in flat.items()})
                grads = torch.autograd.grad(loss, [self.p[n] for n in names])
                self._adam(dict(zip(names, grads)))
                losses.append(float(loss.detach()))
                if self.first_mu is None:
                    self.first_loss = losses[0]
                    self.first_mu = {n: m.detach().cpu() for n, m in self.mu.items()}
        return sum(losses) / len(losses)

    @torch.no_grad()
    def end_iteration(self, data: dict) -> None:
        """The normalizers take this iteration's samples while the sample
        count is under ``normalizer_samples``; the count grows."""
        T, N = data["reward"].shape
        if self.sample_count < self.c["normalizer_samples"]:
            n, s1, s2 = data["obs_stats"]
            o = self.obs_norm
            total = o["count"] + n
            self.obs_norm = dict(count=total, mean=o["count"] / total * o["mean"] + s1 / total,
                                 mean_sq=o["count"] / total * o["mean_sq"] + s2 / total)
            d = self.diff_norm
            diff = data["disc_diff"].to(self.dev, F64).reshape(T * N, -1)
            total = d["count"] + T * N
            self.diff_norm = dict(count=total, mean_abs=d["count"] / total * d["mean_abs"]
                                  + (T * N) / total * diff.abs().mean(0))
        self.sample_count += T * N

    def params(self) -> dict:
        return {n: p.detach().cpu() for n, p in self.p.items()}

