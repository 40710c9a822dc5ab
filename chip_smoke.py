"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here catches its own error):

1. Build the control-step kernel from ``add_gym_torch/csrc`` with nvcc.
2. Kernel vs plain version on the card: the mini biped (N=256) and the
   G1-shaped fixture (N=4096 and the ragged N=4000), 8 control steps from
   states with ground contact and non-zero velocities; each step runs the
   kernel and ``fused_step`` on the same input state.  Tolerances
   (``add_gym_torch.physics.testing.step_tolerances``): positions and
   quaternions rtol = atol = 1e-5; velocities rtol = 1e-5, atol = 1e-4;
   contact rtol = 1e-5, atol = 5e-2 N.  The contact springs (~2e4 N/m per
   point) turn one f32 ulp of a ~1 m height into ~1e-3 N per point, and
   through a light link's inertia into ~1e-5 of velocity per step.
3. The slice: ``build_env`` / ``build_agent`` from config ``train`` on the
   G1-shaped fixture and a synthetic clip, 4096 envs, the default agent
   (``fc_3layers_1024units``, bf16 mixed precision), 32-step
   ``rollout_lean``: one warm-up and three timed rollouts through the
   kernel, with every traj tensor finite and exactly 32 kernel launches
   per rollout.  Before that, a small check: the same 4-step f32 rollout
   at 64 envs through the kernel and through the plain step agrees.
4. Times: CUDA events over 100 launches at 4096 envs on the G1-shaped
   fixture, beside the plain version and the kernel's bound.
5. The kernel line, the card's name and power limit, and the result line.

It imports nothing of JAX or of the JAX package.  Fixture files and the
kernel library go under ``build/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import EngineParams, SimState
from add_gym_torch.physics.fused_step import FusedModelConstants, fused_step
from add_gym_torch.physics.model import build_physics_model
from add_gym_torch.robot import build_pd_gains
from add_gym_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
FIXTURES = os.path.join(ROOT, "build", "add_gym_torch", "fixtures")
NUM_ENVS = 4096
STEPS = 32
TIMED_ROLLOUTS = 3
TIMING_LAUNCHES = 100
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM rate
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def control_step_flops(nb: int, nd: int, ncp: int, npair: int, substeps: int) -> int:
    """f32 operations per env of one control step, counted from
    csrc/control_step.cuh (a fused multiply-add counts as 2, a sqrt, a
    division or a transcendental as 1)."""
    fk = 45 + (nb - 1) * 134            # root rotation + per-joint FK and velocities
    contact = ncp * 63                  # per point: frame, velocity, normal, friction, torque
    pass1 = nb * 177                    # body velocities, bias forces, external forces
    torque = nd * 20                    # PD, damping, friction, limit springs
    pass2 = (nb - 1) * 728              # U, D, projected inertia, sandwiches, parent updates
    solve6 = 250                        # 6x6 Cholesky + two triangular solves
    pass3 = (nb - 1) * 77               # accelerations, qdd, joint integration
    root = 120                          # root integration + quaternion update
    substep = fk + contact + pass1 + torque + pass2 + solve6 + pass3 + root
    held_sc = fk + npair * 80           # FK of the input state + sphere pairs
    pd = nd * 6                         # target clamp + slew limit
    return substeps * substep + held_sc + pd


def sim_state(fields, device):
    return SimState(**{k: torch.as_tensor(v, device=device) for k, v in fields.items()})


def model_setup(path, gains):
    model = build_physics_model(path)
    if gains == "g1":
        kp, kv = build_pd_gains(model)
    else:
        kp = np.full(model.nd, 50.0, np.float32)
        kv = np.full(model.nd, 5.0, np.float32)
    params = EngineParams(kp=torch.as_tensor(kp, device=DEVICE),
                          kv=torch.as_tensor(kv, device=DEVICE))
    return model, FusedModelConstants(model), params


def compare_step(fc, params, state, cmd):
    """One control step by the kernel and by the plain version from the same
    input; returns (plain next state, max abs errors)."""
    out = cs.launch_control_step(fc, params, cs.pack_state(state, cmd))
    sk, ck = cs.unpack_state(out, fc.nd)
    sp, cp = fused_step(fc, params, state, cmd)
    torch.cuda.synchronize()
    errs = {}
    got = {**{f: getattr(sk, f) for f in fx.STATE_FIELDS}, "contact": ck}
    want = {**{f: getattr(sp, f) for f in fx.STATE_FIELDS}, "contact": cp}
    for f, tol in fx.step_tolerances().items():
        torch.testing.assert_close(got[f], want[f], **tol, msg=lambda m: f"{f}: {m}")
        errs[f] = (got[f] - want[f]).abs().max().item()
    if not bool((cp > 0).any()):
        raise AssertionError("no ground contact in the comparison")
    return sp, errs


def phase_kernel_vs_plain(mini_path, g1_path):
    worst = {}
    for name, path, gains, n, height in (
        ("mini", mini_path, "mini", 256, 0.6),
        ("g1_fixture", g1_path, "g1", NUM_ENVS, fx.G1_PELVIS_HEIGHT),
        ("g1_fixture_ragged", g1_path, "g1", 4000, fx.G1_PELVIS_HEIGHT),
    ):
        model, fc, params = model_setup(path, gains)
        fields, cmd = fx.random_sim_state(model, n, seed=n, height=height)
        state = sim_state(fields, DEVICE)
        cmd = torch.as_tensor(cmd, device=DEVICE)
        errs_all = {}
        for _ in range(8):
            state, errs = compare_step(fc, params, state, cmd)
            for k, v in errs.items():
                errs_all[k] = max(errs_all.get(k, 0.0), v)
        log(f"[phase 2] {name} N={n} nb={model.nb} nd={model.nd} points={model.ncp} "
            f"sc_pairs={len(model.sc_pairs)}: max abs err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs_all.items()))
        for k, v in errs_all.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _slice_cfg(g1_path, clip_path, num_envs, steps, mixed=None, kernel="auto", net=None):
    cfg = load_config("train")
    cfg["robot"]["asset_path"] = g1_path
    cfg["task"]["motion_file"] = clip_path
    cfg["engine"]["num_envs"] = num_envs
    cfg["engine"]["kernel"] = kernel
    cfg["agent"]["steps_per_iter"] = steps
    if mixed is not None:
        cfg["agent"]["mixed_precision"] = mixed
    if net is not None:
        for k in ("actor_net", "critic_net", "disc_net"):
            cfg["agent"][k] = net
    return cfg


def _start(env, agent, n, seed):
    ts = agent.init_train_state()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device=DEVICE),
                         ts.sampler, generator=g)
    return ts, es, env.compute_obs(es)


def phase_small_slice_check(g1_path, clip_path):
    """4-step f32 rollout at 64 envs: kernel vs plain step, same draws."""
    n, steps = 64, 4
    outs = []
    for kernel in ("on", "off"):
        cfg = _slice_cfg(g1_path, clip_path, n, steps, mixed=False, kernel=kernel,
                         net="fc_2layers_64units")
        env = build_env(cfg, device=DEVICE)
        agent = build_agent(cfg, env)
        ts, es, obs = _start(env, agent, n, seed=1)
        g = torch.Generator(device=DEVICE)
        g.manual_seed(2)
        draws = agent.sample_rollout_draws(ts, n, steps, g)
        outs.append(agent.rollout_lean(ts, es, obs, steps, draws=draws)[2])
    worst = 0.0
    for k in outs[0]:
        a, b = outs[0][k].float(), outs[1][k].float()
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3, msg=lambda m: f"{k}: {m}")
        worst = max(worst, (a - b).abs().max().item())
    log(f"[phase 3] small check: 64 envs x 4 steps, kernel vs plain rollout max abs diff "
        f"{worst:.3e} (rtol=atol=1e-3)")


def phase_slice(g1_path, clip_path):
    cfg = _slice_cfg(g1_path, clip_path, NUM_ENVS, STEPS)
    env = build_env(cfg, device=DEVICE)
    agent = build_agent(cfg, env)
    a = agent.cfg
    log(f"[phase 3] slice: num_envs={NUM_ENVS} steps_per_iter={a.steps_per_iter} "
        f"actor={a.actor_net} mixed_precision={a.mixed_precision} kernel={env.kernel} "
        f"obs_dim={env.obs_dim()} disc_obs_dim={env.disc_obs_dim()}")
    if not env.kernel:
        raise AssertionError("the slice did not select the kernel")
    ts, es, obs = _start(env, agent, NUM_ENVS, seed=0)
    torch.cuda.synchronize()

    cs.cuda_step.launches = 0
    times = []
    for i in range(1 + TIMED_ROLLOUTS):
        before = cs.cuda_step.launches
        t0 = time.perf_counter()
        es, obs, traj, _ = agent.rollout_lean(ts, es, obs, STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if cs.cuda_step.launches - before != STEPS:
            raise AssertionError(
                f"rollout {i}: {cs.cuda_step.launches - before} kernel launches, expected {STEPS}")
        for k, v in traj.items():
            if v.shape[:2] != (STEPS, NUM_ENVS):
                raise AssertionError(f"traj[{k}] has shape {tuple(v.shape)}")
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"traj[{k}] is not finite")
        if not bool(torch.isfinite(obs).all()):
            raise AssertionError("obs is not finite")
        resets = int((traj["done"] != 0).sum())
        if i > 0:
            times.append(dt)
        log(f"[phase 3] rollout {i}{' (warm-up)' if i == 0 else ''}: {dt:.4f} s, "
            f"{NUM_ENVS * STEPS / dt:.1f} env-steps/s, resets={resets}, "
            f"mean reward={traj['reward'].mean().item():.4f}")
    launches = cs.cuda_step.launches
    med = float(np.median(times))
    log(f"[phase 3] rollout env-steps/s (median of {TIMED_ROLLOUTS}): {NUM_ENVS * STEPS / med:.1f}")
    log(f"[phase 3] kernel launches over the main path: {launches} "
        f"({launches // (1 + TIMED_ROLLOUTS)} per rollout)")
    return launches, NUM_ENVS * STEPS / med


def _time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(g1_path):
    model, fc, params = model_setup(g1_path, "g1")
    fields, cmd = fx.random_sim_state(model, NUM_ENVS, seed=7, height=fx.G1_PELVIS_HEIGHT)
    state = sim_state(fields, DEVICE)
    cmd = torch.as_tensor(cmd, device=DEVICE)
    inp = cs.pack_state(state, cmd)
    kernel_ms = _time_ms(lambda: cs.launch_control_step(fc, params, inp), TIMING_LAUNCHES)
    plain_ms = _time_ms(lambda: fused_step(fc, params, state, cmd), 10)

    fbuf, ibuf, counts = cs.pack_model(fc, params)
    nb, nd, ncp, nsph, npair, substeps = counts
    flops = control_step_flops(nb, nd, ncp, npair, substeps) * NUM_ENVS
    io_bytes = 4 * NUM_ENVS * ((13 + 4 * nd) + (13 + 3 * nd + nb)) + fbuf.nbytes + ibuf.nbytes
    bound_ms = max(flops / PEAK_F32, io_bytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_F32 >= io_bytes / PEAK_BYTES else "bytes"
    log(f"[phase 4] control step at N={NUM_ENVS}: kernel {kernel_ms:.4f} ms/launch "
        f"(CUDA events, {TIMING_LAUNCHES} launches), plain version {plain_ms:.4f} ms/call; "
        f"bound {bound_ms:.5f} ms by {bound_by} ({flops / NUM_ENVS:.0f} flops/env, "
        f"{io_bytes} bytes)")
    return kernel_ms, plain_ms, bound_ms, bound_by


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    build = cs.build_library()
    log(f"[phase 1] kernel library {os.path.relpath(build['path'], ROOT)} "
        f"built in {build['seconds']:.1f} s")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            log(f"[phase 1] ptxas: {line.strip()}")

    mini_path = fx.write_mini_mjcf(FIXTURES)
    g1_path = fx.write_g1_fixture(FIXTURES)
    clip_path = fx.write_motion_csv(os.path.join(FIXTURES, "g1_fixture_clip.motion"),
                                    seed=0, num_frames=300)

    worst = phase_kernel_vs_plain(mini_path, g1_path)
    phase_small_slice_check(g1_path, clip_path)
    launches, env_steps_per_s = phase_slice(g1_path, clip_path)
    kernel_ms, plain_ms, bound_ms, bound_by = phase_times(g1_path)

    log(json.dumps({"kernels": [{
        "name": "control_step",
        "route": "cuda",
        "source": "add_gym_torch/csrc/control_step.cu",
        "replaces": "add_gym_tpu/physics/pallas_step.py:74",
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"rollout_env_steps_per_s": env_steps_per_s, "num_envs": NUM_ENVS,
                    "steps_per_iter": STEPS}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
