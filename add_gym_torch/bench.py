"""Benchmark of the port: the whole ADD+PPO training iteration on one GPU.

    python -m add_gym_torch.bench

The port's counterpart of the repository's ``bench.py``.  It prints ONE
JSON line on standard output (its progress goes to standard error) with
``bench.py``'s keys: ``metric``, ``value``, ``unit``, ``vs_baseline``
(value / 1e6, the BASELINE.json target), ``floor_ratio``,
``derived_ceiling``, ``device_kind`` and ``windows``.  Beside them stand
the card's ``power_limit_w`` (``nvidia-smi``), the host's CPU model and
the per-layer numbers of one more iteration: the rollout /
``build_train_data`` / ``update_model`` / normalizer split (CUDA events at
``train_iter``'s phase hook), the kernel's launches per iteration and its
ms per launch at this shape (CUDA events over 100 launches) beside its
bound, the peak device memory of the timed windows, and the device's busy
share of one iteration under ``torch.profiler`` (taken after the timed
windows, so tracing never overlaps them).

The run: config ``train`` on the G1-shaped fixture and a synthetic
300-frame clip (``physics.testing.slice_config``; the G1's own assets are
not in the repository, and the metric says so), ``torch.Generator``s
from fixed seeds, 2 warm-up iterations, one discarded ramp window, then
the median of ``BENCH_WINDOWS`` windows of ``BENCH_ITERS`` iterations,
each timed on the host clock around work that ends in
``torch.cuda.synchronize()``.

``derived_ceiling`` counts the iteration's matmul operations as
``bench.py`` does (docs/SCALING.md) and divides each trunk's by the peak
of the precision it runs in on this card: actor and critic at bf16 under
``mixed_precision``, the disc at bf16 under ``disc_mixed_precision``, f32
(TF32 off) otherwise.  The physics term is T times the control-step
kernel's bound by operations (``physics.roofline``), not its measured
time, so a faster kernel does not move the yardstick.  A card without
listed peaks gets ``floor_ratio`` and ``derived_ceiling`` null.

It fails, with a non-zero exit and no JSON line, if an info is not
finite, if the parameters did not move, or if any iteration launched
other than ``steps_per_iter`` kernel launches of the variant the config
selects (and none of another: no per-env, narrowphase or sharded launch
on ``train``).  It runs on the card and raises where there is none;
``BENCH_OVERRIDES="device=cpu"`` runs it on the CPU, where it prints
``device_kind: "cpu"`` and null for every number only the card can give.

Env knobs, as ``bench.py``'s: BENCH_NUM_ENVS (4096), BENCH_ITERS (window
length, 5), BENCH_WINDOWS (3), BENCH_STEPS_PER_ITER, BENCH_OVERRIDES
(extra config overrides).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import is_per_env
from add_gym_torch.physics.fused_step import compute_np_ext
from add_gym_torch.physics.roofline import control_step_bound, device_peaks
from add_gym_torch.profile_rollout import device_rows
from add_gym_torch.utils.device import resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(_ROOT, "build", "add_gym_torch", "fixtures")
WARMUP = 2                 # bench.py: two iterations before the ramp window
ITERS = 5                  # iterations a window (BENCH_ITERS)
WINDOWS = 3                # timed windows after the ramp window (BENCH_WINDOWS)
KERNEL_LAUNCHES = 100      # launches timed for the kernel's ms per launch
TARGET = 1e6               # env-steps/s, BASELINE.json's north star
_LABEL = {"add": "ADD+PPO", "amp": "AMP+PPO", "none": "PPO"}


def knobs(environ=os.environ) -> dict:
    """bench.py's env knobs."""
    steps = environ.get("BENCH_STEPS_PER_ITER")
    return dict(num_envs=int(environ.get("BENCH_NUM_ENVS", 4096)),
                iters=int(environ.get("BENCH_ITERS", ITERS)),
                windows=int(environ.get("BENCH_WINDOWS", WINDOWS)),
                steps=int(steps) if steps else None,
                overrides=environ.get("BENCH_OVERRIDES", "").split())


# ------------------------------------------------------------------ ceiling


def trunk_precisions(cfg) -> dict:
    """The precision each trunk's matmuls run in on the card."""
    mixed = "bf16" if cfg.mixed_precision else "f32"
    return dict(actor=mixed, critic=mixed, disc="bf16" if cfg.disc_mixed_precision else "f32")


def trunk_flops(cfg, params: dict, num_envs: int) -> dict:
    """Matmul operations of one ``train_iter`` by trunk, as bench.py counts
    them over M = T x N samples: the update epochs x M x [6 (Pa + Pc) +
    12 Pd] (forward 2P and backward 4P a trunk, the disc twice for the
    gradient penalty's double backward), the rollout's actor M x 2 Pa and
    the data build's M x (4 Pc + 2 Pd)."""
    m, e = cfg.steps_per_iter * num_envs, cfg.update_epochs
    pa, pc, pd = params["actor"], params["critic"], params["disc"]
    return dict(actor=e * m * 6 * pa + m * 2 * pa,
                critic=e * m * 6 * pc + m * 4 * pc,
                disc=e * m * 12 * pd + m * 2 * pd)


def derived_ceiling(agent, num_envs: int, peaks: dict, phys_ms_per_step: float):
    """Ceiling env-steps/s of one ``train_iter`` at ``peaks`` (FLOP/s by
    precision): returns (env-steps/s, seconds, seconds by term), the terms
    being each precision's matmul time and ``physics``, T control steps
    of ``phys_ms_per_step``."""
    cfg = agent.cfg
    prec = trunk_precisions(cfg)
    terms = {}
    for trunk, flops in trunk_flops(cfg, agent.net_params_by_trunk(), num_envs).items():
        terms[prec[trunk]] = terms.get(prec[trunk], 0.0) + flops / peaks[prec[trunk]]
    terms["physics"] = cfg.steps_per_iter * phys_ms_per_step * 1e-3
    floor_s = sum(terms.values())
    return cfg.steps_per_iter * num_envs / floor_s, floor_s, terms


def kernel_bound(env, params, num_envs: int):
    """(bound ms, bound by) of one launch of the kernel variant that
    ``params`` select, over ``num_envs`` envs of ``env``'s model."""
    fbuf, ibuf, counts = cs.pack_model(env._fc, params)
    return control_step_bound(fbuf, ibuf, counts, num_envs, is_per_env(params))


# ------------------------------------------------------------- measurement


def reset_counts():
    cs.cuda_step.launches = 0
    cs.cuda_step.dr_launches = 0
    cs.cuda_step.np_launches = 0
    cs.sharded_cuda_step.launches = 0


def read_counts() -> dict:
    return dict(main=cs.cuda_step.launches, per_env=cs.cuda_step.dr_launches,
                narrowphase=cs.cuda_step.np_launches, sharded=cs.sharded_cuda_step.launches)


def expected_counts(env, steps: int) -> dict:
    """Launches per iteration of each count: ``steps`` of the variant the
    env selects (the main one on ``train``), none of another; none at all
    without the kernel."""
    k = steps if env.kernel else 0
    return dict(main=0 if env.dr.enabled else k, per_env=k if env.dr.enabled else 0,
                narrowphase=k if len(env._fc.np_bodies) else 0, sharded=0)


def split_iteration(agent, state, generator):
    """One more ``train_iter`` on ``state`` = [ts, es, obs] (in place),
    with a CUDA event at each phase boundary (``train_iter``'s hook).
    Returns (ms by phase: rollout, data, update, end; total ms)."""
    marks = []

    def hook(phase, outputs=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((phase, ev))

    hook("start")
    ts, es, obs, info = agent.train_iter(*state, generator=generator, hook=hook)
    state[:] = [ts, es, obs]
    hook("end")
    torch.cuda.synchronize()
    _check_info(info, "split iteration")
    split = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])}
    return split, marks[0][1].elapsed_time(marks[-1][1])


def _check_info(info, where):
    for k, v in info.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{where}: info[{k}] = {v} is not finite")


def time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: one call to warm up, then CUDA events
    around ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(env, es):
    """The kernel's ms per launch on the env's current state (uncounted
    launches)."""
    params = env._effective_params(es)
    np_ext = compute_np_ext(env._fc, params, params.ctrl_dt / params.substeps, es.sim)
    inp = cs.pack_state(es.sim, es.sim.pd_target, params, None, np_ext)
    return time_ms(lambda: cs.launch_control_step(env._fc, params, inp), KERNEL_LAUNCHES)


def _busy_ms(agent, state, generator):
    """Device time of one ``train_iter`` under ``torch.profiler``: the sum
    over every device-side op."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts, es, obs, info = agent.train_iter(*state, generator=generator)
        state[:] = [ts, es, obs]
        torch.cuda.synchronize()
    _check_info(info, "profiled iteration")
    return sum(r[1] for r in device_rows(prof)) / 1e3


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _watts(card: str):
    """The power limit of ``card_line()`` in W (None where nvidia-smi
    cannot read it)."""
    try:
        return float(card.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return None


def host_cpu() -> str:
    """The host's CPU: its model name (or, where the machine hides it, the
    vendor, family and model numbers) and the CPU count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown" and "vendor_id" in info:
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return f"{name}; {os.cpu_count()} CPUs"


def run_protocol(env, agent, num_envs: int, iters: int = ITERS, windows: int = WINDOWS,
                 log=None) -> dict:
    """bench.py's protocol on ``env`` and ``agent`` from a fresh start
    drawn from fixed seeds; returns the JSON object (see the module
    docstring).  Sets the launch counts to 0 just before its first
    iteration; raises on a failed check."""
    log = log or (lambda msg: None)
    cuda = env.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda and not env.kernel:
        raise RuntimeError("on the card the bench runs the control-step kernel (engine.kernel)")
    n, a = num_envs, agent.cfg
    g = torch.Generator(device=env.device)
    g.manual_seed(0)
    ts = agent.init_train_state(generator=g)
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device=env.device),
                         ts.sampler, generator=g)
    state = [ts, es, env.compute_obs(es)]
    g.manual_seed(1)                        # the iterations' draws
    p0 = [p.detach().clone() for p in ts.params.parameters()]
    per_window = iters * a.steps_per_iter * n
    sync()

    def iterations(k, where):
        t0 = time.perf_counter()
        for _ in range(k):
            ts, es, obs, info = agent.train_iter(*state, generator=g)
            state[:] = [ts, es, obs]
        sync()
        dt = time.perf_counter() - t0
        _check_info(info, where)
        return dt

    reset_counts()
    log(f"warm-up: {WARMUP} iterations in {iterations(WARMUP, 'warm-up'):.3f} s")
    log(f"ramp window (discarded): {per_window / iterations(iters, 'ramp window'):.1f} env-steps/s")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rates = []
    for w in range(windows):
        rates.append(per_window / iterations(iters, f"window {w}"))
        log(f"window {w}: {rates[-1]:.1f} env-steps/s")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    done = WARMUP + (1 + windows) * iters
    split = total = busy = None
    if cuda:
        split, total = split_iteration(agent, state, g)
        busy = _busy_ms(agent, state, g) / total
        done += 2
    got, want = read_counts(), expected_counts(env, a.steps_per_iter)
    if got != {k: v * done for k, v in want.items()}:
        raise RuntimeError(f"kernel launches {got} over {done} iterations, expected {want} "
                           "per iteration")
    if all(torch.equal(x, y) for x, y in zip(p0, state[0].params.parameters())):
        raise RuntimeError("train_iter left every parameter unchanged")
    launches = got["per_env" if env.dr.enabled else "main"] // done
    params = env._effective_params(state[1])
    bound_ms, bound_by = kernel_bound(env, params, n)
    kernel_ms = _kernel_ms(env, state[1]) if cuda else None

    kind = torch.cuda.get_device_name(env.device) if cuda else "cpu"
    rate = statistics.median(rates)
    peaks = device_peaks(kind)
    ceiling = terms = None
    if peaks is not None:
        ceiling, _, terms = derived_ceiling(agent, n, peaks, bound_ms)
    card = card_line() if cuda else None
    metric = (f"train env-steps/s @ {n} envs ({_LABEL[a.disc_mode]}, full iter, "
              f"G1-shaped fixture)")
    return {
        "metric": metric if cuda else metric + " [cpu]",
        "value": round(rate, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / TARGET, 4),
        "floor_ratio": round(rate / ceiling, 4) if ceiling else None,
        "derived_ceiling": round(ceiling, 1) if ceiling else None,
        "device_kind": kind,
        "windows": [round(r, 1) for r in rates],
        "power_limit_w": _watts(card) if card else None,
        "host_cpu": host_cpu(),
        "num_envs": n,
        "steps_per_iter": a.steps_per_iter,
        "trunk_precision": trunk_precisions(a),
        "ceiling_ms": {k: v * 1e3 for k, v in terms.items()} if terms else None,
        "split_ms": split,
        "iter_ms": total,
        "kernel_launches_per_iter": launches,
        "kernel_ms_per_launch": kernel_ms,
        "kernel_bound_ms": bound_ms if cuda else None,
        "kernel_bound_by": bound_by if cuda else None,
        "peak_device_bytes": peak,
        "device_busy_share": busy,
    }


def main() -> int:
    k = knobs()
    cfg = fx.slice_config(FIXTURES, "train", k["overrides"])
    device = resolve_device(cfg.get("device", "cuda"))
    cfg["device"] = str(device)
    cfg["engine"]["num_envs"] = k["num_envs"]
    if k["steps"]:
        cfg["agent"]["steps_per_iter"] = k["steps"]
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False      # f32 stays f32: the ceiling's peaks
        torch.backends.cudnn.allow_tf32 = False
    env = build_env(cfg, device=device)
    agent = build_agent(cfg, env)
    out = run_protocol(env, agent, k["num_envs"], k["iters"], k["windows"],
                       log=lambda msg: print(f"bench: {msg}", file=sys.stderr, flush=True))
    if k["steps"]:
        out["metric"] += f" [steps_per_iter={k['steps']}]"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
