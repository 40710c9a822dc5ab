"""The comparison that decides ``correct``: the plain reference follows the
iterations set-up drove the program through, once the window has closed.

The rollout's physics is chaotic over a hundred steps, so the reference
follows the program step by step from the program's own state, in stages
that are each checked by themselves:

* the control step (kernel, task update, reward, done, observations) at a
  few control steps of each followed iteration, drawn from the seed, from
  the program's state, command and reset draws there, for every env,
  through the reference's env on its reference-layout engine
  (``reference/``): ``step_gap``, the worst field's max |program -
  reference| over its RMS (a done flag that differs sends one side's env
  through a reset, which shows there; the flips are logged), and
  ``step_rms_gap``, the worst field's RMS of the difference over its RMS;
* the train data: the reference's learner (``reference/learners/<disc
  mode>.py``, float64, written apart from the program) takes what the
  program's rollout recorded as it acted (raw observations, actions, task
  rewards, done flags, exploration mask, disc observation differences)
  and the program's parameters at the iteration's start, and works out
  with its own normalizers the log-probs, rewards, returns and
  advantages: ``logp_gap``, ``reward_gap``, ``return_gap``, ``adv_gap``
  (each max |program - reference| over the reference's RMS, worst
  iteration), ``data_gap``, their worst, and ``first_data_gap``, their
  worst in the first iteration;
* the update, from the reference's own parameters and moments, on the
  reference's own train data in the same minibatch order: ``first_loss_gap`` (the first minibatch step's loss, relative),
  ``loss_gap`` (each iteration's mean loss, relative), and by the worst
  leaf, the gap between the program's norm and the reference's over the
  larger of the reference leaf's norm and the median leaf's: for the
  first gradient as the optimizer got it, worked out from its first
  moment after the first minibatch step (``grad_gap`` over the actor's
  and critic's leaves, ``disc_grad_gap`` over the disc's), and for the
  parameters' change over all followed iterations (``change_gap``,
  ``disc_change_gap``; leaves whose first gradient in the reference is
  under a thousandth of the median leaf's are left out).

A cell's ``limits/<workload>.json`` names the numbers it compares.
"""

from __future__ import annotations

import statistics
from dataclasses import fields

import numpy as np
import torch

from port_bench.reference import learners
from port_bench.reference.builder import build_env as ref_build_env
from port_bench.reference.envs.imitation import EnvState
from port_bench.reference.physics.engine import SimState

NUMBERS = ("step_gap", "step_rms_gap", "logp_gap", "reward_gap", "return_gap", "adv_gap",
           "data_gap", "first_data_gap", "first_loss_gap", "loss_gap", "grad_gap",
           "disc_grad_gap", "change_gap", "disc_change_gap")
SIM_FIELDS = [f.name for f in fields(SimState)]
STEP_FIELDS = ("next_obs", "reward", "disc_obs", "disc_obs_demo")


def kept_steps(seed: int, iteration: int, steps: int, count: int):
    """The control steps of a followed iteration that the reference steps
    itself, drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, iteration])
    return sorted(int(t) for t in rng.choice(steps, size=min(count, steps), replace=False))


def _rms(r) -> torch.Tensor:
    return torch.clamp_min(torch.sqrt(torch.mean(r * r)), 1e-6)


def gap(p, r) -> float:
    """max |p - r| over the RMS of r (floored at 1e-6)."""
    p, r = p.double(), r.double()
    return float(torch.max(torch.abs(p - r)) / _rms(r))


def rms_gap(p, r) -> float:
    """RMS of p - r over the RMS of r (floored at 1e-6)."""
    p, r = p.double(), r.double()
    return float(_rms(p - r) / _rms(r)) if p.numel() else 0.0


def leaf_gap(prog: dict, ref: dict, leaves, median_of: dict):
    """(gap, leaf) of the worst leaf: |norm(program) - norm(reference)|
    over the larger of the reference leaf's norm and the median leaf's
    norm in ``median_of``."""
    norm = lambda x: float(torch.linalg.vector_norm(x.double()))
    med = statistics.median(norm(v) for v in median_of.values())
    return max(((abs(norm(prog[n]) - norm(ref[n])) / max(norm(ref[n]), med, 1e-30), n)
                for n in leaves), default=(0.0, None))


def _env_state(d: dict, device) -> EnvState:
    kw = {}
    for f in fields(EnvState):
        v = d[f.name]
        if f.name == "sim":
            kw[f.name] = SimState(**{k: v[k].to(device) for k in SIM_FIELDS})
        elif f.name == "dr":
            kw[f.name] = {k: x.to(device) for k, x in v.items()}
        else:
            kw[f.name] = v.to(device)
    return EnvState(**kw)


def step_check(env, kept: dict) -> dict:
    """``step_gap`` and ``step_rms_gap`` of the kept control steps, with
    the done flips, the env-steps and where each worst gap is."""
    dev = env.device
    out = dict(step_gap=0.0, step_rms_gap=0.0, flips=0, count=0, where={})
    for t, k in sorted(kept.items()):
        st = _env_state(k["state"], dev)
        state3, obs_after, _, ref = env.rollout_step_cached(
            st, k["action"].to(dev), env.motion_aux(st), k["ids"].to(dev), k["times"].to(dev),
            {n: x.to(dev) for n, x in k["dr"].items()})
        p = k["out"]
        flip = p["done"] != ref["done"].cpu()
        out["flips"] += int(flip.sum())
        out["count"] += int(flip.numel())
        pairs = [(n, p[n], ref[n].cpu()) for n in STEP_FIELDS]
        pairs.append(("obs_after", p["obs_after"], obs_after.cpu()))
        pairs += [(n, p["state"]["sim"][n], getattr(state3.sim, n).cpu()) for n in SIM_FIELDS]
        for n, a, b in pairs:
            for name, g in (("step_gap", gap(a, b)), ("step_rms_gap", rms_gap(a, b))):
                if g > out[name]:
                    out[name], out["where"][name] = g, f"{n} at step {t}"
    return out


def follow(cfg: dict, device, weights: dict, recs: list, prog_params: dict, log=print) -> dict:
    """Every number a cell may compare: the reference follows the recorded
    iterations ``recs`` from ``weights``; ``prog_params`` are the
    program's parameters after the last."""
    env = ref_build_env(cfg, device=device)
    learner = learners.load(cfg).Learner(cfg, weights, device)
    p0 = {n: w.cpu() for n, w in weights.items()}
    nums = dict.fromkeys(("step_gap", "step_rms_gap", "logp_gap", "reward_gap", "return_gap",
                          "adv_gap", "loss_gap"), 0.0)
    for k, rec in enumerate(recs):
        st = step_check(env, rec["steps"])
        for n in ("step_gap", "step_rms_gap"):
            nums[n] = max(nums[n], st[n])
        data = learner.train_data(rec["obs"], rec["next_obs"], rec["traj"], params=rec["params"])
        d = rec["data"]
        it = {n: gap(prog, ref.cpu()) for n, prog, ref in (
            ("logp_gap", rec["traj"]["a_logp"], data["a_logp"]),
            ("reward_gap", d["reward"], data["reward"]),
            ("return_gap", d["tar_val"], data["tar_val"]),
            ("adv_gap", d["adv"], data["adv"]))}
        for n, g in it.items():
            nums[n] = max(nums[n], g)
        if k == 0:
            nums["first_data_gap"] = max(it.values())
        ref_loss = learner.update(data, rec["perms"])
        prog_loss = float(rec["update"]["loss"])
        nums["loss_gap"] = max(nums["loss_gap"], abs(prog_loss - ref_loss) / max(abs(ref_loss), 1e-12))
        learner.end_iteration(data)
        del data
        log(f"followed iteration {k + 1}: step gap {st['step_gap']:.3e} "
            f"({st['where'].get('step_gap')}), rms {st['step_rms_gap']:.3e} "
            f"({st['where'].get('step_rms_gap')}), done flips {st['flips']}/{st['count']}, "
            f"loss program {prog_loss:.8g} reference {ref_loss:.8g}, "
            + ", ".join(f"{n} {g:.3e}" for n, g in it.items()))
    nums["data_gap"] = max(nums[n] for n in ("logp_gap", "reward_gap", "return_gap", "adv_gap"))
    first = recs[0]
    nums["first_loss_gap"] = (abs(float(first["first_loss"]) - learner.first_loss)
                              / max(abs(learner.first_loss), 1e-12))
    prog_mu, ref_mu = first["first_mu"], learner.first_mu
    ref_params = learner.params()
    names = list(ref_params)
    mu_norm = {n: float(torch.linalg.vector_norm(ref_mu[n])) for n in names}
    med = statistics.median(mu_norm.values())
    moved = [n for n in names if mu_norm[n] >= 1e-3 * med]
    if len(moved) < len(names):
        log(f"change gaps leave out {sorted(set(names) - set(moved))}: first moment under "
            f"1e-3 of the median leaf's")
    change_p = {n: prog_params[n] - p0[n] for n in names}
    change_r = {n: ref_params[n] - p0[n] for n in names}
    disc = lambda n: n.startswith("disc_")
    worst = {}
    for pre, pick in (("", lambda n: not disc(n)), ("disc_", disc)):
        nums[pre + "grad_gap"], worst[pre + "grad_gap"] = leaf_gap(
            prog_mu, ref_mu, [n for n in names if pick(n)], ref_mu)
        nums[pre + "change_gap"], worst[pre + "change_gap"] = leaf_gap(
            change_p, change_r, [n for n in moved if pick(n)], {n: change_r[n] for n in moved})
    log(f"first loss program {float(first['first_loss']):.9g} reference {learner.first_loss:.9g}; "
        f"worst leaves {worst}")
    return nums


def judge(numbers: dict, limits: dict):
    """(all within their limits, {name: [number, limit]}) over the numbers
    ``limits`` names: a number passes at or under its limit; one that is
    missing or not finite fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        out[name] = [v, lim]
        if v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, out
