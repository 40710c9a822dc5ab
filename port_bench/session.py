"""The system under test: add_gym_torch's training iteration
(``ADDAgent.train_iter``: rollout, ``build_train_data``, ``update_model``,
the normalizers) on the cell's composed config, built through
``builder.build_env`` / ``build_agent``.

Set-up builds one env and one agent, gives the network the benchmark's
initial weights, resets every env and drives the same objects through the
first iterations, which the reference follows afterwards: each goes
through ``train_iter`` as the window calls it, while a recorder beside the
env keeps what the reference needs to judge it.  The window then calls
``train_iter`` on the same state until ``--seconds`` have passed.

The benchmark hands the program its inputs: the weights (one draw from
the seed), the generator of the rollout's draws, and each iteration's
minibatch order (``perms``, one permutation of shuffle blocks an epoch),
which the reference takes too.
"""

from __future__ import annotations

import math
import time
from dataclasses import fields, is_dataclass

import torch

from port_bench.reference import learners


def build_program(cfg: dict, device, generator):
    from add_gym_torch.builder import build_agent, build_env

    env = build_env(cfg, device=device)
    return env, build_agent(cfg, env, generator=generator)


def initial_weights(named_shapes, agent_cfg: dict, generator, device) -> dict:
    """The network's first weights by parameter name (the reference
    learner's names and shapes), as the reference's init draws them (zero
    biases; U(+-1/sqrt(fan_in)) hidden and critic weights,
    U(+-actor_init_output_scale) for the actor's mean head, U(+-1) for the
    disc's logit), from one uniform draw on the device."""
    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    weights = [(n, s) for n, s in named_shapes if n.endswith("weight")]
    other = [n for n, _ in named_shapes if not n.endswith(("weight", "bias"))]
    if other:
        raise ValueError(f"no initial value for parameters {other}")
    u = torch.rand(sum(math.prod(s) for _, s in weights), generator=generator, device=device)
    u = u * 2.0 - 1.0
    out, i = {}, 0
    head = float(agent_cfg.get("actor_init_output_scale", 0.01))
    for name, shape in named_shapes:
        if name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
            continue
        if name.startswith(("actor_mean.", "actor_logstd_head.")):
            scale = head
        elif name.startswith("disc_logit."):
            scale = 1.0
        else:
            scale = 1.0 / math.sqrt(shape[1])
        n = math.prod(shape)
        out[name] = (u[i:i + n] * scale).reshape(shape)
        i += n
    return out


def load_weights(net, weights: dict) -> None:
    """The program's parameters set from ``weights``; raises where the
    names or shapes differ from the reference's."""
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    if shapes != {n: tuple(w.shape) for n, w in weights.items()}:
        raise ValueError(f"the program's parameters {shapes} are not the reference's")
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(weights[name].to(p.device))


def draw_perms(shape, generator, device):
    """One iteration's minibatch order: a permutation of the shuffle
    blocks per epoch, [epochs, blocks] int64 (one draw and a sort)."""
    return torch.rand(shape, generator=generator, device=device).argsort(dim=1)


def to_host(x):
    """Every tensor of a state (dataclasses, dicts, lists) on the host, as
    nested dicts and lists."""
    if is_dataclass(x):
        return {f.name: to_host(getattr(x, f.name)) for f in fields(x)}
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


STEP_OUT = ("next_obs", "reward", "done", "disc_obs", "disc_obs_demo")


class StepRecorder:
    """Stands in front of ``env.rollout_step_cached`` during a followed
    iteration: keeps every step's obs after the reset and its pre-reset
    obs, and for the steps in ``keep`` the state it was given, the command,
    the reset draws and what it returned.  ``remove`` puts the env back."""

    def __init__(self, env, keep):
        self.env, self.keep = env, set(keep)
        self.step_fn = env.rollout_step_cached
        self.t = 0
        self.obs_after, self.next_obs, self.kept = [], [], {}
        env.rollout_step_cached = self

    def __call__(self, state, pd_target, aux, ids_f, times_f, dr):
        t = self.t
        self.t += 1
        if t in self.keep:
            given = to_host(dict(state=state, action=pd_target, ids=ids_f, times=times_f, dr=dr))
        state3, obs_after, aux3, out = self.step_fn(state, pd_target, aux, ids_f, times_f, dr)
        self.obs_after.append(obs_after)
        self.next_obs.append(out["next_obs"])
        if t in self.keep:
            given["out"] = to_host(dict(state=state3, obs_after=obs_after,
                                        **{k: out[k] for k in STEP_OUT}))
            self.kept[t] = given
        return state3, obs_after, aux3, out

    def remove(self):
        del self.env.rollout_step_cached


class FirstStepRecorder:
    """Stands in front of the agent's ``_loss`` and ``_opt_step`` during a
    followed iteration and keeps, of the first minibatch step, the loss
    and the optimizer's first moments after it (by parameter name), from
    which the first gradient as the optimizer got it is worked out.
    ``remove`` puts back what was there."""

    def __init__(self, agent):
        self.agent, self.loss, self.mu = agent, None, None
        self.saved = {k: agent.__dict__.get(k) for k in ("_loss", "_opt_step")}
        loss_fn, opt_fn = agent._loss, agent._opt_step

        def _loss(net, batch):
            out = loss_fn(net, batch)
            if self.loss is None:
                self.loss = out[0].detach().clone()
            return out

        def _opt_step(net, grads, opt_state):
            state = opt_fn(net, grads, opt_state)
            if self.mu is None:
                names = [n for n, _ in net.named_parameters()]
                self.mu = {n: m.detach().clone() for n, m in zip(names, state.mu)}
            return state

        agent._loss, agent._opt_step = _loss, _opt_step

    def remove(self):
        for k, v in self.saved.items():
            if v is None:
                delattr(self.agent, k)
            else:
                setattr(self.agent, k, v)


class Session:
    """The program's env, agent and training state, and the benchmark's
    generators: ``prog`` feeds the program's own draws (resets, action
    noise), ``bench`` the weights and the minibatch orders."""

    def __init__(self, cfg: dict, seed: int, device, plant=None, build=None):
        self.cfg, self.device = cfg, torch.device(device)
        self.bench = torch.Generator(device=self.device)
        self.bench.manual_seed(int(seed))
        self.prog = torch.Generator(device=self.device)
        self.prog.manual_seed(int(seed) + 1)
        self.env, self.agent = (build or build_program)(cfg, self.device, self.prog)
        if plant is not None:
            plant(self.env, self.agent)
        acfg = cfg["agent"]
        self.learner = learners.load(cfg)
        self.num_envs = int(cfg["engine"]["num_envs"])
        self.steps = int(acfg["steps_per_iter"])
        self.perm_shape = self.learner.shuffle_shape(cfg, self.num_envs)
        ts = self.agent.init_train_state(generator=self.prog)
        env = self.env
        shapes = self.learner.param_shapes(cfg, env.obs_dim(), env.disc_obs_dim(), env.num_dofs)
        self.weights = initial_weights(shapes, acfg, self.bench, self.device)
        load_weights(ts.params, self.weights)
        n = self.num_envs
        es = self.env.reset_where(self.env.init_state(n),
                                  torch.ones(n, dtype=torch.bool, device=self.device),
                                  ts.sampler, generator=self.prog)
        self.state = [ts, es, self.env.compute_obs(es)]
        self.iter_ms = []          # the last window's iterations on the device timeline

    def iterate(self, hook=None, perms=None):
        """One ``train_iter`` on the session's state; returns its info."""
        if perms is None:
            perms = draw_perms(self.perm_shape, self.bench, self.device)
        ts, es, obs, info = self.agent.train_iter(*self.state, generator=self.prog, perms=perms,
                                                  hook=hook)
        self.state = [ts, es, obs]
        return info

    def followed_iteration(self, keep_steps) -> dict:
        """One iteration through the window's call with a recorder beside
        the env; returns on the host what the reference follows it by."""
        perms = draw_perms(self.perm_shape, self.bench, self.device)
        obs0 = self.state[2]
        got = dict(params=self.params_host())

        def hook(phase, outputs=None):
            if phase == "rollout":
                got["traj"] = {k: outputs[k] for k in self.learner.TRAJ_KEYS}
            elif phase == "data":
                got["data"] = {k: outputs[k] for k in self.learner.DATA_KEYS}
            elif phase == "update":
                got["update"] = dict(outputs)

        rec = StepRecorder(self.env, keep_steps)
        first = FirstStepRecorder(self.agent)
        try:
            info = self.iterate(hook, perms)
        finally:
            rec.remove()
            first.remove()
        out = to_host(dict(
            perms=perms, traj=got["traj"], data=got["data"], update=got["update"], info=info,
            obs=torch.stack([obs0] + rec.obs_after[:-1]), next_obs=torch.stack(rec.next_obs),
            params=got["params"], first_loss=first.loss, first_mu=first.mu))
        out["steps"] = rec.kept
        return out

    def window(self, seconds: float, hook=None, on_start=None, before=None):
        """``train_iter`` until ``seconds`` have passed on the host clock,
        then a synchronize; ``before`` is called before each iteration.
        Returns (iterations, seconds, infos); the seconds run from the
        window's start to the synchronize after the last iteration."""
        cuda = self.device.type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        infos, marks = [], []
        t0 = time.perf_counter()
        if on_start is not None:
            on_start()
        while True:
            if before is not None:
                before()
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            infos.append(self.iterate(hook))
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        sync()
        self.iter_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return len(infos), time.perf_counter() - t0, infos

    def params_host(self) -> dict:
        return {n: p.detach().cpu().clone() for n, p in self.state[0].params.named_parameters()}

