"""Where a rollout's, or a whole training iteration's, time goes on the GPU.

    python -m add_gym_torch.profile_rollout            # one rollout_lean
    python -m add_gym_torch.profile_rollout --train    # one train_iter
    python -m add_gym_torch.profile_rollout --train --narrowphase

Builds the slice as ``chip_smoke.py`` does (config ``train``, with
``engine.general_narrowphase`` under ``--narrowphase``, the
G1-shaped fixture and a synthetic clip, 4096 envs, the default agent and
32 steps per rollout), runs two warm-up calls, then one call timed with
CUDA events and one under ``torch.profiler``.  Prints the call's wall
time, the device time summed over all kernels and copies (the device's
busy share of the wall time), the control-step kernel's share, and the
kernels with the most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.physics import testing as fx

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ENVS = 4096
STEPS = 32
TOP = 20


def device_rows(prof):
    """(name, device µs, count) of every device-side op (kernels, copies,
    memsets); host-side aten ops, which the profiler also charges with
    their kernels' time, are left out so nothing counts twice."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, float(us), e.count))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_rollout: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = fx.slice_config(os.path.join(_ROOT, "build", "add_gym_torch", "fixtures"))
    cfg["engine"]["num_envs"] = NUM_ENVS
    cfg["engine"]["general_narrowphase"] = "--narrowphase" in sys.argv[1:]
    env = build_env(cfg, device="cuda")
    agent = build_agent(cfg, env)
    ts = agent.init_train_state()
    n = NUM_ENVS
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                         ts.sampler)
    state = [ts, es, env.compute_obs(es)]
    train = "--train" in sys.argv[1:]
    what = "train_iter" if train else "rollout"

    def call():
        ts, es, obs = state
        if train:
            ts, es, obs, _ = agent.train_iter(ts, es, obs)
        else:
            es, obs, _, _ = agent.rollout_lean(ts, es, obs, STEPS)
        state[:] = [ts, es, obs]

    for _ in range(2):                                          # warm-up
        call()
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    event_ms = start.elapsed_time(end)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows) / 1e3
    kernel_ms = sum(r[1] for r in rows if "agt_control_step" in r[0]) / 1e3
    launches = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"device {torch.cuda.get_device_name(0)}; {n} envs x {STEPS} steps")
    print(f"{what} wall {wall_ms:.3f} ms (host clock), {event_ms:.3f} ms (CUDA events)")
    print(f"profiled {what}: device busy {device_ms:.3f} ms over {launches} device ops; "
          f"control-step kernel {kernel_ms:.3f} ms")
    for key, us, count in rows[: TOP]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:100]}")
    print(json.dumps({
        "what": what, "num_envs": n, "steps": STEPS, "ms_events": event_ms,
        "ms_wall": wall_ms, "device_busy_ms": device_ms,
        # busy share: profiled device time over the unprofiled call's time
        "device_busy_share": device_ms / event_ms, "control_step_kernel_ms": kernel_ms,
        "device_ops": launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
