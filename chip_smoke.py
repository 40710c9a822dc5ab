"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here catches its own error):

1. Build the control-step kernel from ``add_gym_torch/csrc`` with nvcc;
   log ptxas's registers, stack and spills, and each variant's launch shape
   in each instance (``cuda_step.INSTANCES``: envs a block, dynamic shared
   memory a block, blocks and envs resident per SM, registers).
2. Kernel vs plain version on the card: the mini biped (N=256) and the
   G1-shaped fixture (N=4096 and the ragged N=4000), 4 control steps from
   states with ground contact and non-zero velocities; each step runs the
   kernel and ``fused_step`` on the same input state.  Tolerances
   (``add_gym_torch.physics.testing.step_tolerances``): positions and
   quaternions rtol = atol = 1e-5; velocities rtol = 1e-5, atol = 1e-4;
   contact rtol = 1e-5, atol = 5e-2 N.  The contact springs (~2e4 N/m per
   point) turn one f32 ulp of a ~1 m height into ~1e-3 N per point, and
   through a light link's inertia into ~1e-5 of velocity per step.
   2b. The same for the kernel's per-env (domain-randomization) variant on
   the G1-shaped fixture at N=4096 and N=4000, 8 control steps, with
   per-env gains, friction and mass scale (``testing.per_env_params``: the ``dr_pod``
   ranges, mass widened to [0.5, 2.0]).
   2c. The kernel with its held narrowphase rows (``np_bodies``): the
   G1-shaped fixture with ``attach_geoms`` (637 pairs, 30 touched bodies,
   180 rows), main and per-env variant, N=4096 and N=4000, 4 control steps
   from states with the joints bent by 0.2 N(0, 1); the rows come from
   ``fused_step.compute_np_ext`` and the plain version is ``fused_step``
   with the tables.  Fails if every row is zero; logs the active pairs.
   2d. The kernel's wide instance (48 body slots) on the G1 with Dex3-1
   hands (``port_bench.inputs``' ``g1_dex3``: 44 bodies, 43 hinges, 13
   levels): main and per-env variant at N=4096 and N=4000, then both with
   narrowphase rows at N=4096, 4 control steps each against ``fused_step``
   within the tolerances of phase 2.
3. The rollout: ``build_env`` / ``build_agent`` from config ``train`` on the
   G1-shaped fixture and a synthetic clip, 4096 envs, the default agent
   (``fc_3layers_1024units``, bf16 mixed precision), 32-step
   ``rollout_lean``: one warm-up and two timed rollouts through the
   kernel, with every traj tensor finite and exactly 32 kernel launches
   per rollout.  Before that, a small check: the same 4-step f32 rollout
   at 64 envs through the kernel and through the plain step agrees.
4. Times: CUDA events over 100 launches at 4096 envs on the G1-shaped
   fixture, for each variant and for the main variant with the
   narrowphase rows, beside the plain version and the bound, and two
   launches on one input block bitwise equal for each; the main variant's
   ms per launch at 1024, 2048, 4096 and 8192 envs beside the bound at
   each N and the host's enqueue time per launch (below the kernel's, so
   the events time the kernel); and the time of ``compute_np_ext`` per
   control step (the cost outside the kernel), with its device op count
   from ``torch.profiler``.  The same times, bound and bitwise check for
   both variants of the wide instance on the G1 with Dex3-1 hands (4b).
5. Training, config ``train`` (main variant): ``train_iter`` at 4096 envs
   x 32 steps, 5 epochs x 8 minibatches of 16,384, through the port
   bench's protocol (``add_gym_torch.bench.run_protocol``, ``bench.py``'s:
   2 warm-up iterations, one discarded 5-iteration ramp window, then the
   median of three 5-iteration windows -> train env-steps/s; the
   CUDA-event split of one more iteration into rollout / build_train_data
   / update_model, the device's busy share of one more under
   ``torch.profiler``, the peak device memory of the timed windows, the
   kernel's ms per launch at this shape beside its bound, and the ceiling
   from the H100's peaks).  The bench's JSON line is logged; exactly 32
   main-variant launches an iteration, none of another instance.
6. Training, config ``dr_pod`` (per-env variant) at 4096 envs: one warm-up
   and two timed iterations; exactly 32 per-env launches per iteration,
   finite infos, parameters that changed.
7. Training, config ``train`` with ``engine.general_narrowphase=true`` at
   4096 envs (the main variant with the narrowphase rows): one warm-up and
   two timed iterations; exactly 32 launches with rows per iteration,
   finite infos, parameters that changed; env-steps/s and peak memory.
8. ``utils.debug.parity_check`` on that env at 256 envs: the kernel with
   the rows against the reference-layout engine (``engine.step``).
9. The sharded step in one process: 4096 global envs split into 2 and 4
   shards, ``sharded_cuda_step`` per shard (global-size per-env leaves
   sliced to it) concatenated against ``cuda_step`` on all 4096 envs, bit
   for bit, for the main and the per-env instance; each shard against the
   plain sharded step within ``step_tolerances``.  With narrowphase rows
   the rows come from each shard's own state, and ``compute_np_ext`` is not
   bit for bit the same at another env count (its batched products), so
   that instance is held bit for bit on the same rows (the unsharded input
   block cut per shard) and the sharded wrapper within ``step_tolerances``.
   Then ms per launch at 2048 and 1024 envs (CUDA events over 100
   launches) beside the bound, and the plain sharded step at 2048.
10. The CLI on the card, one rank under NCCL: ``python -m
   torch.distributed.run --standalone --nproc_per_node=1 -m
   add_gym_torch.cli.train train`` at 4096 envs (the G1-shaped fixture, the
   synthetic clip, bf16 ``fc_3layers_1024units``) for 2 iterations with a
   50-step evaluation, then again to iteration 3 (an auto-resume), then
   config ``test`` with ``checkpoint=...`` in this process, without a
   launcher.  Checks the resumed
   state's digest against the saved one, ``config.json``, ``log.txt``,
   ``metrics.jsonl`` (3 rows, ``sample_count`` 3 x 32 x 4096) and the test
   mode's JSON line.
11. Two ranks on the one card under gloo (NCCL takes one rank per device):
   ``torch.distributed.run --nproc_per_node=2`` runs this script as a rank
   (``--two-rank-worker``), each a ``Trainer`` on 2048 of 4096 global envs
   for 2 iterations at full width.  Checks that both ranks hold the same
   parameters and Adam moments bit for bit, that each launched the kernel
   32 times an iteration through ``sharded_cuda_step`` on 2048 envs, and
   that the losses are finite; prints the rate as two ranks sharing one
   card (the collectives' cost on one card, no multi-GPU figure).
12. AMP at full width: config ``train`` with ``agent=amp_g1`` (f32
   ``fc_3layers_1024units`` actor and critic, ``fc_2layers_1024units``
   disc) at 4096 envs, one warm-up and two timed iterations: exactly 32
   main-variant launches per iteration, finite infos with ``disc_loss`` and
   ``disc_grad_penalty``, a ``NormState`` disc normalizer whose count grows
   by 2 x 32 x 4096 (agent and fresh demo obs) per iteration, parameters
   that changed; env-steps/s, the CUDA-event split of one more iteration
   and the peak device memory of the timed iterations.
13. Plain PPO: config ``ppo256`` as the file sets it (256 envs), then
   ``train`` with ``agent=ppo_g1`` at 4096 envs, one warm-up and two timed
   iterations each: 32 launches per iteration, no disc parameters, no disc
   loss in the infos (``disc_reward_mean`` and ``_std`` are 0, as in the
   JAX package), ``task_reward_mean`` not 0.  Then two timed iterations of
   ``train`` with ``agent.optimizer=sgd agent.actor_std_type=variable`` at
   4096 envs: the SGD traces and the logstd head change, the infos are
   finite.
14. The video and tools path.  (a) 8 steps of
   ``ADDAgent.eval_rollout_states`` at 64 envs (f32, small nets) through
   the kernel and through the plain step from one state with the same
   reset draws: env 0's states within rtol = atol = 1e-3 (the rollout
   tolerance of phase 3), and FK of the recorded states on the card within
   1e-5 of FK on the CPU.  (b) Config ``train`` on the mesh fixture
   (``testing.write_mesh_fixture``: the G1-shaped robot with an STL box per
   body as its visual mesh) at 4096 envs through the ``Trainer``:
   ``record_video(path, seconds=4.0)`` with the launch counts set to 0
   just before and read just after: exactly 400 main-variant launches, an
   npz with ``body_pos`` [400, 30, 3] and the ghost's arrays, all finite;
   the video rollout's ms and the render's ms per frame are logged, and
   the GIF must exist where PIL imports (without PIL a log line says that
   the render did not run on the card; the CPU tests hold it).  (c)
   ``python -m add_gym_torch.cli.view`` on the fixture clip with no
   ``device=`` (so on the card): its npz's ``body_pos`` within 1e-5 of the
   CPU FK of the same frames.  (d) ``python -m add_gym_torch.cli.probe``
   with its input from ``/dev/null``: exit 0 and ``bodies: 30  dofs: 29``.
   (e) ``python -m add_gym_torch.cli.publish`` on phase 10's checkpoint:
   ``model.pt`` equals the checkpoint's parameters bit for bit.  (g) The
   training CLI (``cli.train.main`` in this process, config ``train``) on
   the G1 with Dex3-1 hands and a clip in its 43-joint order, 4096 envs,
   2 iterations, no evaluation: exactly 2 x 32 main-variant launches, all
   of them of the wide instance (``cuda_step.wide_launches``), each a
   replay of the env step's CUDA graph but the warm-up step's; finite
   metrics.  (f) The
   native loader builds with g++ and its CSV and STL readers equal the
   numpy ones exactly on the fixture clip and STLs.  The three CLIs run as
   subprocesses started together, alongside (a) and (f), and are waited
   for before (b), which is timed alone.
15. The kernel line, the video line (``video_rollout_ms``,
   ``video_launches``, ``render_ms_per_frame``, ``view_frames``), the
   card's name and power limit, and the result line.

``python3 chip_smoke.py --compare-kernel DIR`` runs no phase but this:
``DIR`` holds another checkout of the repository (its own
``add_gym_torch/physics/cuda_step.py`` packs its model buffers and builds
its kernel into ``DIR/build``); the two kernels' main variants step the
same 4096-env input in turns (other, this, this, other), and it prints
each one's ms per launch and the largest difference of their outputs.

Each path (3, 5, 6, 7, 11, 12, 13, 14b) is driven with the launch counts set to 0 just
before it and read just after (phase 11 in each rank's own process).  Each log line starts with the seconds since the
start; the JSON lines, the card's line and the result line are printed
bare.  The kernel-vs-plain ``train_iter`` check of ``dr_pod`` is a
card-only test (``tests/test_torch_cuda.py``).  It imports nothing of JAX
or of the JAX package.  Fixture files and the kernel library go under ``build/`` (listed in
``.gitignore``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from add_gym_torch import bench
from add_gym_torch.bench import card_line, reset_counts, split_iteration, time_ms
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.cli.train import main as cli_main
from add_gym_torch.envs.imitation import ImitationEnv
from add_gym_torch.learning.normalizer import NormState
from add_gym_torch.learning.optim import SGDState
from add_gym_torch.parallel.mesh import EnvShard
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import engine as eng
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import EngineParams, SimState
from add_gym_torch.physics.fused_step import (
    FusedModelConstants, compute_np_ext, fused_step, np_rows, sharded_fused_step,
)
from add_gym_torch.physics.model import attach_geoms, build_physics_model
from add_gym_torch.physics.narrowphase import geom_f_ext
from add_gym_torch.physics.roofline import control_step_bound, control_step_flops
from add_gym_torch.profile_rollout import device_rows
from add_gym_torch.robot import build_pd_gains
from add_gym_torch.utils.config import load_config
from add_gym_torch.utils.debug import parity_check

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
FIXTURES = os.path.join(ROOT, "build", "add_gym_torch", "fixtures")
NUM_ENVS = 4096
STEPS = 32
TIMED_ROLLOUTS = 2
TIMING_LAUNCHES = 100
PLAIN_CALLS = 3           # the plain step takes ~0.25 s per call at 4096 envs on an H100
MAIN_COMPARE_STEPS = 4    # phase 2 (the main variant)
DR_COMPARE_STEPS = 8      # phase 2b (the per-env variant)
NP_COMPARE_STEPS = 4      # phase 2c (the narrowphase rows)
NP_EXT_CALLS = 20         # phase 4: compute_np_ext calls timed
NP_TIMED = 2              # phase 7: timed train iterations
PARITY_ENVS = 256         # phase 8
SHARD_ENVS = (2048, 1024)  # phase 9: per-rank shapes of 2 and 4 ranks at 4096 envs
SWEEP_ENVS = (1024, 2048, 4096, 8192)  # phase 4: ms per launch of the main variant
DESIGN = ("warp per env, lane per body; 4 envs a 128-thread block; per-env scratch in "
          "shared memory; tree passes level by level")
DESIGN_WIDE = ("warp per env, lanes 0-11 with two bodies past 32; 48 body slots, 2 envs a "
               "64-thread block; per-env scratch in shared memory; tree passes level by level")
CLI_EVAL_LEN = 0.5        # phase 10: episode cap of the run (50 control steps)
SUBPROCESS_TIMEOUT = 300
DR_TIMED = 2
MODE_TIMED = 2            # phases 12 and 13: timed iterations of each agent mode


T_START = time.perf_counter()


def log(*args):
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *args, flush=True)


def sim_state(fields, device):
    return SimState(**{k: torch.as_tensor(v, device=device) for k, v in fields.items()})


def model_setup(path, gains, geoms=False):
    model = build_physics_model(path)
    if geoms:
        model = attach_geoms(model, path)
    if gains == "g1":
        kp, kv = build_pd_gains(model)
    else:
        kp = np.full(model.nd, 50.0, np.float32)
        kv = np.full(model.nd, 5.0, np.float32)
    params = EngineParams(kp=torch.as_tensor(kp, device=DEVICE),
                          kv=torch.as_tensor(kv, device=DEVICE))
    return model, FusedModelConstants(model), params


def per_env(params, n, seed):
    """``params`` with per-env gains, friction and mass scale on the card."""
    pe = fx.per_env_params(params.kp.cpu().numpy(), params.kv.cpu().numpy(), n, seed)
    return dataclasses.replace(params, **{k: torch.as_tensor(v, device=DEVICE)
                                          for k, v in pe.items()})


def compare_step(fc, params, state, cmd, np_ext=None):
    """One control step by the kernel (the variant ``params`` select, with
    the narrowphase rows of ``np_ext``) and by the plain version from the
    same input; returns (plain next state, max abs errors)."""
    out = cs.launch_control_step(fc, params, cs.pack_state(state, cmd, params, None, np_ext))
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
        for _ in range(MAIN_COMPARE_STEPS):
            state, errs = compare_step(fc, params, state, cmd)
            for k, v in errs.items():
                errs_all[k] = max(errs_all.get(k, 0.0), v)
        log(f"[phase 2] {name} N={n} nb={model.nb} nd={model.nd} points={model.ncp} "
            f"sc_pairs={len(model.sc_pairs)}: max abs err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs_all.items()))
        for k, v in errs_all.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def phase_dr_kernel_vs_plain(g1_path):
    worst = {}
    for n in (NUM_ENVS, 4000):
        model, fc, params = model_setup(g1_path, "g1")
        params = per_env(params, n, seed=n + 1)
        fields, cmd = fx.random_sim_state(model, n, seed=n + 2, height=fx.G1_PELVIS_HEIGHT)
        state = sim_state(fields, DEVICE)
        cmd = torch.as_tensor(cmd, device=DEVICE)
        errs_all = {}
        for _ in range(DR_COMPARE_STEPS):
            state, errs = compare_step(fc, params, state, cmd)
            for k, v in errs.items():
                errs_all[k] = max(errs_all.get(k, 0.0), v)
        ms = params.mass_scale
        log(f"[phase 2b] per-env variant, g1_fixture N={n} (mass scale "
            f"{ms.min().item():.3f}-{ms.max().item():.3f}): max abs err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs_all.items()))
        for k, v in errs_all.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def bent_state(model, n, seed):
    """States with ground contact and the joints bent by 0.2 N(0, 1): the
    narrowphase pairs of the G1-shaped fixture touch."""
    fields, cmd = fx.random_sim_state(model, n, seed=seed, height=fx.G1_PELVIS_HEIGHT)
    rng = np.random.default_rng(seed)
    fields["dof_pos"] = np.clip(fields["dof_pos"] + 0.2 * rng.normal(size=fields["dof_pos"].shape),
                                model.dof_limit[:, 0], model.dof_limit[:, 1]).astype(np.float32)
    return sim_state(fields, DEVICE), torch.as_tensor(cmd, device=DEVICE)


def active_pairs(model, params, state):
    """Pairs of each narrowphase table that push, summed over the envs."""
    body_pos, body_rot = eng.forward_kinematics(model, state)
    omega, vel = eng._body_world_velocities(model, state, body_rot)
    active = {}
    geom_f_ext(model.geoms, body_pos, body_rot, omega, vel, params.ctrl_dt / params.substeps,
               params.contact_timeconst, model.nb, active=active)
    return {k: int(v.sum()) for k, v in active.items()}


def phase_np_kernel_vs_plain(g1_path):
    worst = {False: {}, True: {}}
    for per in (False, True):
        for n in (NUM_ENVS, 4000):
            model, fc, params = model_setup(g1_path, "g1", geoms=True)
            if per:
                params = per_env(params, n, seed=n + 3)
            state, cmd = bent_state(model, n, seed=n + 4)
            pairs = active_pairs(model, params, state)
            errs_all, row_max = {}, 0.0
            dt = params.ctrl_dt / params.substeps
            for _ in range(NP_COMPARE_STEPS):
                np_ext = compute_np_ext(fc, params, dt, state)
                row_max = max(row_max, np_rows(np_ext).abs().max().item())
                state, errs = compare_step(fc, params, state, cmd, np_ext)
                for k, v in errs.items():
                    errs_all[k] = max(errs_all.get(k, 0.0), v)
            if row_max == 0.0:
                raise AssertionError("every narrowphase row is zero: no pair pushed")
            log(f"[phase 2c] {'per-env' if per else 'main'} variant with narrowphase rows, "
                f"g1_fixture N={n}: {model.geoms.num_pairs} pairs, {len(fc.np_bodies)} touched "
                f"bodies, active pairs at the first step (summed over envs) {pairs}, "
                f"largest row {row_max:.3e}; max abs err "
                + " ".join(f"{k}={v:.3e}" for k, v in errs_all.items()))
            for k, v in errs_all.items():
                worst[per][k] = max(worst[per].get(k, 0.0), v)
    return worst


def phase_hands_kernel_vs_plain(dex3_path):
    """Phase 2d: the wide instance on the G1 with Dex3-1 hands against the
    plain step, main and per-env, with and without narrowphase rows."""
    worst = {}
    for per, geoms, n in ((False, False, NUM_ENVS), (False, False, 4000), (True, False, NUM_ENVS),
                          (True, False, 4000), (False, True, NUM_ENVS), (True, True, NUM_ENVS)):
        model, fc, params = model_setup(dex3_path, "g1", geoms=geoms)
        if cs.instance(model.nb) != cs.INSTANCES[-1]:
            raise AssertionError(f"{model.nb} bodies go to the {cs.instance(model.nb)}-body instance")
        if per:
            params = per_env(params, n, seed=n + 5)
        state, cmd = bent_state(model, n, seed=n + 6)
        dt = params.ctrl_dt / params.substeps
        errs_all = {}
        for _ in range(MAIN_COMPARE_STEPS):
            np_ext = compute_np_ext(fc, params, dt, state) if geoms else None
            state, errs = compare_step(fc, params, state, cmd, np_ext)
            for k, v in errs.items():
                errs_all[k] = max(errs_all.get(k, 0.0), v)
        log(f"[phase 2d] {'per-env' if per else 'main'} variant"
            f"{' with narrowphase rows' if geoms else ''}, g1_dex3 N={n} nb={model.nb} "
            f"nd={model.nd} points={model.ncp} levels={cs.tree_tables(model.parent)[0].max()}: "
            "max abs err " + " ".join(f"{k}={v:.3e}" for k, v in errs_all.items()))
        for k, v in errs_all.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _slice_cfg(g1_path, clip_path, num_envs, steps, mixed=None, kernel="auto", net=None,
               name="train", general_narrowphase=False, overrides=()):
    """Config ``name`` with ``overrides`` on the fixture and the clip;
    ``num_envs`` None keeps the file's env count."""
    cfg = load_config(name, list(overrides))
    cfg["robot"]["asset_path"] = g1_path
    cfg["task"]["motion_file"] = clip_path
    if num_envs is not None:
        cfg["engine"]["num_envs"] = num_envs
    cfg["engine"]["kernel"] = kernel
    cfg["engine"]["general_narrowphase"] = general_narrowphase
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

    reset_counts()
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
    if cs.cuda_step.dr_launches:
        raise AssertionError("the rollout of config train launched the per-env variant")
    med = float(np.median(times))
    log(f"[phase 3] rollout env-steps/s (median of {TIMED_ROLLOUTS}): {NUM_ENVS * STEPS / med:.1f}")
    log(f"[phase 3] kernel launches over the rollouts: {launches} "
        f"({launches // (1 + TIMED_ROLLOUTS)} per rollout)")
    return NUM_ENVS * STEPS / med


def phase_times(g1_path, dr: bool, geoms: bool = False):
    """(kernel ms/launch, plain ms/call, bound ms, bound by) of one variant;
    with ``geoms`` the main variant with the narrowphase rows (the plain
    version then computes them too), and the time and device ops of
    ``compute_np_ext`` as a fifth entry."""
    model, fc, params = model_setup(g1_path, "g1", geoms=geoms)
    if dr:
        params = per_env(params, NUM_ENVS, seed=8)
    if geoms:
        state, cmd = bent_state(model, NUM_ENVS, seed=9)
    else:
        fields, cmd = fx.random_sim_state(model, NUM_ENVS, seed=7, height=fx.G1_PELVIS_HEIGHT)
        state, cmd = sim_state(fields, DEVICE), torch.as_tensor(cmd, device=DEVICE)
    dt = params.ctrl_dt / params.substeps
    np_ext = compute_np_ext(fc, params, dt, state)
    inp = cs.pack_state(state, cmd, params, None, np_ext)
    first, again = (cs.launch_control_step(fc, params, inp) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("two launches on one input block differ")
    kernel_ms = time_ms(lambda: cs.launch_control_step(fc, params, inp), TIMING_LAUNCHES)
    plain_ms = time_ms(lambda: fused_step(fc, params, state, cmd), PLAIN_CALLS)

    fbuf, ibuf, counts = cs.pack_model(fc, params)
    nb, nd, ncp, nsph, npair, substeps, n_np = counts
    flops = control_step_flops(nb, nd, ncp, npair, substeps, per_env=dr, n_np=n_np)
    bound_ms, bound_by = control_step_bound(fbuf, ibuf, counts, NUM_ENVS, dr)
    name = ("per-env" if dr else "main") + (" + narrowphase rows" if geoms else "")
    log(f"[phase 4] {name} variant at N={NUM_ENVS}: kernel "
        f"{kernel_ms:.4f} ms/launch (CUDA events, {TIMING_LAUNCHES} launches; two launches "
        f"bitwise equal), plain version {plain_ms:.4f} ms/call ({PLAIN_CALLS} calls); bound "
        f"{bound_ms:.5f} ms by {bound_by} ({flops:.0f} flops/env, n_np={n_np})")
    if not geoms:
        return kernel_ms, plain_ms, bound_ms, bound_by

    ext_ms = time_ms(lambda: compute_np_ext(fc, params, dt, state), NP_EXT_CALLS)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        compute_np_ext(fc, params, dt, state)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    ops, busy_ms = sum(r[2] for r in rows), sum(r[1] for r in rows) / 1e3
    again = compute_np_ext(fc, params, dt, state)
    same = all(torch.equal(a, b) for k in np_ext for a, b in zip(np_ext[k], again[k]))
    if not same:
        raise AssertionError("two compute_np_ext calls on the same input differ")
    log(f"[phase 4] compute_np_ext at N={NUM_ENVS}: {ext_ms:.4f} ms per control step (CUDA "
        f"events, {NP_EXT_CALLS} calls), {ops} device ops with {busy_ms:.4f} ms of device time "
        f"(torch.profiler, one call); two calls bitwise equal")
    return kernel_ms, plain_ms, bound_ms, bound_by, dict(ms=ext_ms, device_ops=ops,
                                                          device_ms=busy_ms)


def phase_sweep(g1_path):
    """The main variant's ms per launch at each N of SWEEP_ENVS beside the
    bound, and the host's enqueue time per launch (perf_counter over the
    launches, before the synchronise)."""
    model, fc, params = model_setup(g1_path, "g1")
    fbuf, ibuf, counts = cs.pack_model(fc, params)
    sweep = {}
    for n in SWEEP_ENVS:
        fields, cmd = fx.random_sim_state(model, n, seed=n + 5, height=fx.G1_PELVIS_HEIGHT)
        inp = cs.pack_state(sim_state(fields, DEVICE), torch.as_tensor(cmd, device=DEVICE))
        kernel_ms = time_ms(lambda: cs.launch_control_step(fc, params, inp), TIMING_LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(TIMING_LAUNCHES):
            cs.launch_control_step(fc, params, inp)
        host_ms = (time.perf_counter() - t0) * 1e3 / TIMING_LAUNCHES
        torch.cuda.synchronize()
        bound_ms, bound_by = control_step_bound(fbuf, ibuf, counts, n)
        sweep[n] = dict(ms=kernel_ms, bound_ms=bound_ms, host_enqueue_ms=host_ms)
        log(f"[phase 4] sweep, main variant at N={n}: {kernel_ms:.4f} ms/launch (CUDA events, "
            f"{TIMING_LAUNCHES} launches; host enqueue {host_ms:.4f} ms/launch), "
            f"{n / kernel_ms * 1e3:.1f} env-steps/s; bound {bound_ms:.5f} ms by {bound_by}")
    return sweep


def _check_info(info, where):
    for k, v in info.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{where}: info[{k}] = {v} is not finite")


def _changed(before, params):
    return any(not torch.equal(x, y) for x, y in zip(before, params))


def _train_setup(name, g1_path, clip_path, seed, num_envs=NUM_ENVS, **kw):
    cfg = _slice_cfg(g1_path, clip_path, num_envs, STEPS, name=name, **kw)
    env = build_env(cfg, device=DEVICE)
    agent = build_agent(cfg, env)
    ts, es, obs = _start(env, agent, int(cfg["engine"]["num_envs"]), seed=seed)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1)
    return env, agent, [ts, es, obs], g


def _train_iters(agent, state, g, iters, where):
    """``iters`` train_iter calls on ``state`` = [ts, es, obs] in place;
    returns the wall seconds up to a synchronise and the last info."""
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, es, obs, info = agent.train_iter(*state, generator=g)
        state[:] = [ts, es, obs]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check_info(info, where)
    return dt, info


def phase_train(g1_path, clip_path):
    """Config train at 4096 envs through the port bench's protocol."""
    cfg = _slice_cfg(g1_path, clip_path, NUM_ENVS, STEPS)
    env = build_env(cfg, device=DEVICE)
    agent = build_agent(cfg, env)
    a = agent.cfg
    if not env.kernel or env.dr.enabled:
        raise AssertionError("config train must run the main variant of the kernel")
    log(f"[phase 5] train: num_envs={NUM_ENVS} steps_per_iter={a.steps_per_iter} "
        f"epochs={a.update_epochs} minibatches={int(np.ceil(a.steps_per_iter / a.batch_size))} "
        f"actor={a.actor_net} critic={a.critic_net} disc={a.disc_net} "
        f"mixed_precision={a.mixed_precision} optimizer={a.optimizer}")
    # the bench sets the launch counts to 0 just before its first iteration
    out = bench.run_protocol(env, agent, NUM_ENVS, log=lambda msg: log(f"[phase 5] bench: {msg}"))
    counts = bench.read_counts()
    iters = bench.WARMUP + (1 + bench.WINDOWS) * bench.ITERS + 2   # + the split, the profiled
    want = dict(main=iters * a.steps_per_iter, per_env=0, narrowphase=0, sharded=0)
    if counts != want or out["kernel_launches_per_iter"] != a.steps_per_iter:
        raise AssertionError(f"phase 5: launches {counts} over {iters} iterations, expected {want}")
    if out["floor_ratio"] is not None and not 0 < out["floor_ratio"] < 1:
        raise AssertionError(f"phase 5: floor_ratio {out['floor_ratio']} outside (0, 1)")
    log(f"[phase 5] bench line: {json.dumps(out)}")
    split = out["split_ms"]
    log(f"[phase 5] train env-steps/s (median of {bench.WINDOWS} windows of {bench.ITERS}): "
        f"{out['value']:.1f}; {counts['main']} kernel launches over {iters} iterations "
        f"({counts['main'] // iters} per iteration); split of one iteration (CUDA events): rollout "
        f"{split['rollout']:.2f} ms, build_train_data {split['data']:.2f} ms, update_model "
        f"{split['update']:.2f} ms, normalizers+info {split['end']:.2f} ms; total "
        f"{out['iter_ms']:.2f} ms; device busy share {out['device_busy_share']:.4f}; peak device "
        f"memory {out['peak_device_bytes'] / 2**30:.3f} GiB; kernel "
        f"{out['kernel_ms_per_launch']:.4f} ms/launch (bound {out['kernel_bound_ms']:.5f}); "
        f"ceiling {out['derived_ceiling']} env-steps/s, floor_ratio {out['floor_ratio']}")
    return dict(rate=out["value"], launches=counts["main"], split=split, total_ms=out["iter_ms"],
                peak_bytes=out["peak_device_bytes"], bench=out)


def _split(agent, state, g, where):
    """The split of one more iteration on ``state`` (``bench.split_iteration``),
    logged.  Returns (ms by phase, total ms)."""
    split, total = split_iteration(agent, state, g)
    log(f"[{where}] split of one iteration (CUDA events): rollout {split['rollout']:.2f} ms, "
        f"build_train_data {split['data']:.2f} ms, update_model {split['update']:.2f} ms, "
        f"normalizers+info {split['end']:.2f} ms; total {total:.2f} ms")
    return split, total


def phase_train_dr(g1_path, clip_path):
    """Config dr_pod at 4096 envs through the per-env variant."""
    env, agent, state, g = _train_setup("dr_pod", g1_path, clip_path, seed=20)
    steps = agent.cfg.steps_per_iter
    if not env.kernel or not env.dr.enabled:
        raise AssertionError("config dr_pod must run the kernel with domain randomization")
    log(f"[phase 6] dr_pod: num_envs={NUM_ENVS} domain_rand={env.dr}")
    p0 = [p.detach().clone() for p in state[0].params.parameters()]
    torch.cuda.synchronize()

    reset_counts()
    dt, _ = _train_iters(agent, state, g, 1, "dr warm-up")
    log(f"[phase 6] warm-up iteration: {dt:.3f} s")
    times = []
    for i in range(DR_TIMED):
        before = cs.cuda_step.dr_launches
        dt, info = _train_iters(agent, state, g, 1, f"dr iteration {i}")
        if cs.cuda_step.dr_launches - before != steps:
            raise AssertionError(f"dr iteration {i}: {cs.cuda_step.dr_launches - before} "
                                 f"per-env launches, expected {steps}")
        times.append(dt)
        log(f"[phase 6] iteration {i}: {dt:.4f} s = {steps * NUM_ENVS / dt:.1f} env-steps/s; "
            f"loss={info['loss'].item():.4f} mean_reward={info['mean_reward'].item():.4f} "
            f"fail_frac={info['fail_frac'].item():.4f}")
    launches, dr_launches = cs.cuda_step.launches, cs.cuda_step.dr_launches
    if launches or dr_launches != (1 + DR_TIMED) * steps:
        raise AssertionError(f"{launches} main / {dr_launches} per-env launches, expected "
                             f"0 / {(1 + DR_TIMED) * steps}")
    if not _changed(p0, state[0].params.parameters()):
        raise AssertionError("train_iter left every parameter unchanged")
    ms = state[1].dr["mass_scale"]
    rate = steps * NUM_ENVS / float(np.median(times))
    log(f"[phase 6] dr_pod train env-steps/s (median of {DR_TIMED}): {rate:.1f}; "
        f"{dr_launches} per-env launches ({dr_launches // (1 + DR_TIMED)} per iteration); "
        f"mass scale over the envs {ms.min().item():.3f}-{ms.max().item():.3f}")
    return dict(rate=rate, launches=dr_launches)


def phase_train_np(g1_path, clip_path):
    """Config train + engine.general_narrowphase at 4096 envs: the main
    variant with the narrowphase rows."""
    env, agent, state, g = _train_setup("train", g1_path, clip_path, seed=30,
                                        general_narrowphase=True)
    steps = agent.cfg.steps_per_iter
    if not env.kernel or env.dr.enabled or not env.model.geoms.num_pairs:
        raise AssertionError("train + general_narrowphase must run the kernel with its rows")
    log(f"[phase 7] train + general_narrowphase: num_envs={NUM_ENVS} "
        f"pairs={env.model.geoms.num_pairs} touched bodies={len(env._fc.np_bodies)}")
    p0 = [p.detach().clone() for p in state[0].params.parameters()]
    torch.cuda.synchronize()

    reset_counts()
    dt, _ = _train_iters(agent, state, g, 1, "np warm-up")
    log(f"[phase 7] warm-up iteration: {dt:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(NP_TIMED):
        before = cs.cuda_step.np_launches
        dt, info = _train_iters(agent, state, g, 1, f"np iteration {i}")
        if cs.cuda_step.np_launches - before != steps:
            raise AssertionError(f"np iteration {i}: {cs.cuda_step.np_launches - before} "
                                 f"launches with narrowphase rows, expected {steps}")
        times.append(dt)
        log(f"[phase 7] iteration {i}: {dt:.4f} s = {steps * NUM_ENVS / dt:.1f} env-steps/s; "
            f"loss={info['loss'].item():.4f} mean_reward={info['mean_reward'].item():.4f} "
            f"fail_frac={info['fail_frac'].item():.4f}")
    launches, dr_launches = cs.cuda_step.launches, cs.cuda_step.dr_launches
    np_launches = cs.cuda_step.np_launches
    want = (1 + NP_TIMED) * steps
    if (launches, dr_launches, np_launches) != (want, 0, want):
        raise AssertionError(f"{launches} main / {dr_launches} per-env / {np_launches} with rows, "
                             f"expected {want} / 0 / {want}")
    if not _changed(p0, state[0].params.parameters()):
        raise AssertionError("train_iter left every parameter unchanged")
    peak = torch.cuda.max_memory_allocated()
    rate = steps * NUM_ENVS / float(np.median(times))
    log(f"[phase 7] train + general_narrowphase env-steps/s (median of {NP_TIMED}): {rate:.1f}; "
        f"{np_launches} launches with narrowphase rows ({np_launches // (1 + NP_TIMED)} per "
        f"iteration); peak device memory {peak / 2**30:.3f} GiB")
    return env, dict(rate=rate, launches=np_launches, peak_bytes=peak,
                     iter_ms=1e3 * float(np.median(times)))


def phase_parity(env):
    """utils.debug.parity_check on the narrowphase env: the kernel against
    the reference-layout engine."""
    errs = parity_check(env, n=PARITY_ENVS)
    if errs is None:
        raise AssertionError("parity_check did not compare: the env runs the reference engine")
    log(f"[phase 8] parity_check at {PARITY_ENVS} envs (kernel with narrowphase rows vs "
        f"engine.step, 3 steps): max abs err "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))


def _cut(state, sl):
    return SimState(**{f: getattr(state, f)[sl] for f in fx.STATE_FIELDS})


def _sharded_instance(fc, params, state, cmd, np_instance):
    """Phase 9 for one kernel instance; returns (max abs error against the
    plain sharded step, max abs difference of the concatenated shards from
    the unsharded kernel)."""
    whole, contact = cs.cuda_step(fc, params, state, cmd)
    if np_instance:
        inp = cs.pack_state(state, cmd, params, None,
                            compute_np_ext(fc, params, params.ctrl_dt / params.substeps, state))
        ref = cs.launch_control_step(fc, params, inp)
    worst, diff = 0.0, 0.0
    for shards in (2, 4):
        k = NUM_ENVS // shards
        parts = []
        for r in range(shards):
            sh = EnvShard(r * k, (r + 1) * k, NUM_ENVS)
            local, lcmd = _cut(state, sh.slice), cmd[sh.slice]
            got = cs.sharded_cuda_step(fc, params, local, lcmd, sh)
            want = sharded_fused_step(fc, params, local, lcmd, sh)
            for f, tol in fx.step_tolerances().items():
                a = got[1] if f == "contact" else getattr(got[0], f)
                b = want[1] if f == "contact" else getattr(want[0], f)
                torch.testing.assert_close(a, b, **tol, msg=lambda m: f"shard {r}/{shards} {f}: {m}")
                worst = max(worst, (a - b).abs().max().item())
            parts.append(got)
            if np_instance:
                out = cs.launch_control_step(fc, cs.shard_params(params, sh),
                                             inp[:, sh.slice].contiguous())
                if not torch.equal(out, ref[:, sh.slice]):
                    raise AssertionError(f"np instance, shard {r}/{shards}: the kernel on the "
                                         "same rows differs from the unsharded launch")
        cat = {f: torch.cat([getattr(p[0], f) for p in parts]) for f in fx.STATE_FIELDS}
        cat["contact"] = torch.cat([p[1] for p in parts])
        want_all = {**{f: getattr(whole, f) for f in fx.STATE_FIELDS}, "contact": contact}
        for f, v in cat.items():
            diff = max(diff, (v - want_all[f]).abs().max().item())
            if np_instance:
                torch.testing.assert_close(v, want_all[f], **fx.step_tolerances()[f])
            elif not torch.equal(v, want_all[f]):
                raise AssertionError(f"{shards} shards: {f} differs from the unsharded kernel")
    return worst, diff


def phase_sharded(g1_path):
    """sharded_cuda_step at 4096 global envs over 2 and 4 shards, and its
    time per launch at the per-rank shapes."""
    worst = 0.0
    for name, per, geoms in (("main", False, False), ("per-env", True, False),
                             ("narrowphase rows", False, True)):
        model, fc, params = model_setup(g1_path, "g1", geoms=geoms)
        if per:
            params = per_env(params, NUM_ENVS, seed=40)      # global-size leaves
        if geoms:
            state, cmd = bent_state(model, NUM_ENVS, seed=41)
        else:
            fields, cmd = fx.random_sim_state(model, NUM_ENVS, seed=42, height=fx.G1_PELVIS_HEIGHT)
            state, cmd = sim_state(fields, DEVICE), torch.as_tensor(cmd, device=DEVICE)
        err, diff = _sharded_instance(fc, params, state, cmd, geoms)
        worst = max(worst, err)
        log(f"[phase 9] {name} instance, 4096 envs over 2 and 4 shards: "
            + ("bitwise equal to the unsharded kernel" if not geoms else
               f"the kernel bitwise equal on the same rows; with each shard's own rows "
               f"max abs diff {diff:.3e} from the unsharded step")
            + f"; max abs err against the plain sharded step {err:.3e}")

    model, fc, params = model_setup(g1_path, "g1")
    fields, cmd = fx.random_sim_state(model, NUM_ENVS, seed=43, height=fx.G1_PELVIS_HEIGHT)
    state, cmd = sim_state(fields, DEVICE), torch.as_tensor(cmd, device=DEVICE)
    fbuf, ibuf, counts = cs.pack_model(fc, params)
    times = {}
    for n in SHARD_ENVS:
        sh = EnvShard(0, n, NUM_ENVS)
        local, lcmd = _cut(state, sh.slice), cmd[sh.slice]
        inp = cs.pack_state(local, lcmd, params)
        kernel_ms = time_ms(lambda: cs.launch_control_step(fc, params, inp), TIMING_LAUNCHES)
        plain_ms = (time_ms(lambda: sharded_fused_step(fc, params, local, lcmd, sh), PLAIN_CALLS)
                    if n == SHARD_ENVS[0] else None)
        bound_ms, bound_by = control_step_bound(fbuf, ibuf, counts, n)
        times[n] = (kernel_ms, plain_ms, bound_ms, bound_by)
        log(f"[phase 9] sharded launch at {n} envs (one rank's shard of {NUM_ENVS}): kernel "
            f"{kernel_ms:.4f} ms/launch (CUDA events, {TIMING_LAUNCHES} launches)"
            + (f", plain sharded step {plain_ms:.4f} ms/call ({PLAIN_CALLS} calls)" if plain_ms else "")
            + f"; bound {bound_ms:.5f} ms by {bound_by}")
    return worst, times


def _run(cmd, where, env=None):
    """Run a subprocess to its end; fails the smoke with its output's tail
    if it fails.  Returns its standard output."""
    log(f"[{where}] $ {' '.join(cmd)}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT, env=env, stdin=subprocess.DEVNULL)
    if proc.returncode != 0:
        raise AssertionError(f"{where}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    log(f"[{where}] exit 0 in {time.perf_counter() - t0:.1f} s")
    return proc.stdout


def _digests(out, word):
    """The state digests printed by Trainer.save / load ('Saved' / 'Loaded')."""
    return [line.rsplit("sha256 ", 1)[1].rstrip(")") for line in out.splitlines()
            if line.startswith(word) and "sha256" in line]


def _torchrun(nproc):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}"]


def phase_cli(g1_path, clip_path):
    """The CLI through torch.distributed.run, one rank under NCCL."""
    logs = os.path.join(ROOT, "build", "add_gym_torch", "smoke_logs")
    if os.path.isdir(logs):
        import shutil

        shutil.rmtree(logs)
    args = ["train", f"robot.asset_path={g1_path}", f"task.motion_file={clip_path}",
            f"engine.num_envs={NUM_ENVS}", f"task.max_episode_length={CLI_EVAL_LEN}",
            f"test_episodes={NUM_ENVS}", f"log_dir={logs}", "experiment_name=cli",
            "distributed.backend=nccl"]
    cli = ["-m", "add_gym_torch.cli.train"]
    out1 = _run(_torchrun(1) + cli + args + ["max_iters=2"], "phase 10")
    out2 = _run(_torchrun(1) + cli + args + ["max_iters=3"], "phase 10")
    exp = os.path.join(logs, "cli")
    ckpt = os.path.join(exp, "checkpoint")
    # config test (mode test) in this process, without a launcher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_info = cli_main(["test"] + args[1:] + [f"checkpoint={ckpt}"])
    out3 = buf.getvalue()

    saved1, loaded2, saved2 = _digests(out1, "Saved"), _digests(out2, "Loaded"), _digests(out2, "Saved")
    if not (saved1 and loaded2 and loaded2[0] == saved1[-1]):
        raise AssertionError(f"the resumed state {loaded2} is not the saved one {saved1[-1:]}")
    if f"at iter 2" not in out2:
        raise AssertionError("the second run did not resume at iteration 2")
    if _digests(out3, "Loaded")[-1] != saved2[-1]:
        raise AssertionError("mode=test loaded another state than the last one saved")
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    if cfg["engine"]["num_envs"] != NUM_ENVS or cfg["agent"]["actor_net"] != "fc_3layers_1024units":
        raise AssertionError(f"config.json: {cfg['engine']} {cfg['agent']}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    per_iter = STEPS * NUM_ENVS
    if [r["samples"] for r in rows] != [per_iter, 2 * per_iter, 3 * per_iter]:
        raise AssertionError(f"metrics.jsonl samples {[r['samples'] for r in rows]}")
    if not all(math.isfinite(r["loss"]) for r in rows) or rows[0]["test_num_eps"] < 1:
        raise AssertionError(f"metrics.jsonl rows: {rows}")
    with open(os.path.join(exp, "log.txt")) as f:
        lines = f.read().splitlines()
    if len(lines) != 5 or not lines[0].split()[0] == "samples":
        raise AssertionError(f"log.txt has {len(lines)} lines, expected 2 headers and 3 rows")
    if json.loads(out3.splitlines()[-1]) != test_info:
        raise AssertionError(f"mode=test printed {out3.splitlines()[-1:]}, returned {test_info}")
    if test_info["num_eps"] < 1 or not math.isfinite(test_info["mean_return"]):
        raise AssertionError(f"mode=test printed {test_info}")
    log(f"[phase 10] resumed at iter 2 with the saved state (sha256 {saved1[-1][:16]}...); "
        f"metrics.jsonl samples {[r['samples'] for r in rows]}; train iteration 2 "
        f"{rows[1]['env_steps_per_s']:.1f} env-steps/s, iteration 3 "
        f"{rows[2]['env_steps_per_s']:.1f}; eval at iteration 0: {rows[0]['test_num_eps']:.0f} "
        f"episodes, mean return {rows[0]['test_mean_return']:.4f}; mode=test {test_info}")
    return dict(rate_iter2=rows[1]["env_steps_per_s"], rate_iter3=rows[2]["env_steps_per_s"],
                test=test_info)


def two_rank_worker(out_dir, g1_path, clip_path):
    """One rank of phase 11 (started by torch.distributed.run): a Trainer on
    its 2048 envs for 2 iterations; writes its digest and counts."""
    from add_gym_torch.learning.add_agent import state_digest
    from add_gym_torch.learning.runner import Trainer
    from add_gym_torch.parallel.mesh import initialize_distributed

    cfg = _slice_cfg(g1_path, clip_path, NUM_ENVS, STEPS)
    cfg.update(test_episodes=0, log_dir=os.path.join(out_dir, "logs"), experiment_name="two_rank")
    os.environ["LOCAL_RANK"] = "0"          # both ranks on the one card
    dist = initialize_distributed("cuda", backend="gloo")
    try:
        trainer = Trainer(cfg, dist=dist)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.train(max_iters=2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        result = dict(rank=dist.rank, world=dist.world_size, device=str(dist.device),
                      local_envs=int(trainer.es.sim.root_pos.shape[0]),
                      launches=cs.cuda_step.launches, sharded=cs.sharded_cuda_step.launches,
                      dr=cs.cuda_step.dr_launches, np=cs.cuda_step.np_launches,
                      digest=state_digest(trainer.ts), seconds=seconds,
                      sample_count=int(trainer.ts.sample_count))
        with open(os.path.join(out_dir, f"rank{dist.rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.close()


def phase_two_ranks(g1_path, clip_path):
    """Two ranks on the one card under gloo through torch.distributed.run."""
    out_dir = os.path.join(ROOT, "build", "add_gym_torch", "two_rank")
    if os.path.isdir(out_dir):
        import shutil

        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    _run(_torchrun(2) + [os.path.abspath(__file__), "--two-rank-worker", out_dir, g1_path,
                         clip_path], "phase 11")
    res = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    with open(os.path.join(out_dir, "logs", "two_rank", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if res[0]["digest"] != res[1]["digest"]:
        raise AssertionError("the two ranks hold different parameters or Adam moments")
    for r in res:
        want = dict(world=2, local_envs=NUM_ENVS // 2, launches=2 * STEPS, sharded=2 * STEPS,
                    dr=0, np=0, sample_count=2 * STEPS * NUM_ENVS)
        if any(r[k] != v for k, v in want.items()):
            raise AssertionError(f"rank {r['rank']}: {r}, expected {want}")
    if len(rows) != 2 or not all(math.isfinite(x["loss"]) for x in rows):
        raise AssertionError(f"metrics.jsonl of the two ranks: {rows}")
    log(f"[phase 11] two ranks (gloo) sharing one card, {NUM_ENVS // 2} envs each: state sha256 "
        f"{res[0]['digest'][:16]}... on both; launches per rank {res[0]['sharded']} "
        f"({res[0]['sharded'] // 2} per iteration, devices {res[0]['device']}/{res[1]['device']}); "
        f"losses {[round(x['loss'], 4) for x in rows]}; iteration 2: "
        f"{rows[1]['env_steps_per_s']:.1f} env-steps/s over both ranks (two ranks sharing one "
        f"card: the collectives' cost on one card, not a multi-GPU rate)")
    return dict(launches=sum(r["sharded"] for r in res), rate=rows[1]["env_steps_per_s"],
                iter_seconds=[x["iter_seconds"] for x in rows])


def _mode_iters(agent, state, g, where, track=None):
    """One warm-up and ``MODE_TIMED`` timed ``train_iter`` calls on
    ``state``, the launch counts set to 0 before and read after: exactly
    ``steps_per_iter`` main-variant launches per iteration and none of
    another instance.  ``track(state)`` is read around each timed
    iteration.  Returns (env-steps/s, the median over the timed
    iterations; launches; the last info; the peak device bytes of the
    timed iterations; the change of ``track`` over each)."""
    steps, n = agent.cfg.steps_per_iter, int(state[2].shape[0])
    reset_counts()
    dt, _ = _train_iters(agent, state, g, 1, f"{where} warm-up")
    log(f"[{where}] warm-up iteration: {dt:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    times, deltas = [], []
    for i in range(MODE_TIMED):
        before = cs.cuda_step.launches
        t0 = track(state) if track else None
        dt, info = _train_iters(agent, state, g, 1, f"{where} iteration {i}")
        if cs.cuda_step.launches - before != steps:
            raise AssertionError(f"{where} iteration {i}: {cs.cuda_step.launches - before} kernel "
                                 f"launches, expected {steps}")
        if track:
            deltas.append(track(state) - t0)
        times.append(dt)
        log(f"[{where}] iteration {i}: {dt:.4f} s = {steps * n / dt:.1f} env-steps/s; "
            f"loss={info['loss'].item():.4f} mean_reward={info['mean_reward'].item():.4f} "
            f"task_reward_mean={info['task_reward_mean'].item():.4f}")
    peak = torch.cuda.max_memory_allocated()
    counts = (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.np_launches)
    if counts != ((1 + MODE_TIMED) * steps, 0, 0):
        raise AssertionError(f"{where}: {counts} main / per-env / with-rows launches, expected "
                             f"{(1 + MODE_TIMED) * steps} / 0 / 0")
    return steps * n / float(np.median(times)), counts[0], info, peak, deltas



def phase_train_amp(g1_path, clip_path):
    """AMP (``agent=amp_g1``) at 4096 envs through the main variant."""
    env, agent, state, g = _train_setup("train", g1_path, clip_path, seed=50,
                                        overrides=("agent=amp_g1",))
    a = agent.cfg
    if a.disc_mode != "amp" or not env.kernel or env.dr.enabled:
        raise AssertionError("agent=amp_g1 must train AMP through the main variant of the kernel")
    if not isinstance(state[0].disc_norm, NormState):
        raise AssertionError(f"AMP's disc normalizer is a {type(state[0].disc_norm).__name__}")
    log(f"[phase 12] amp_g1: num_envs={NUM_ENVS} steps_per_iter={a.steps_per_iter} "
        f"actor={a.actor_net} critic={a.critic_net} disc={a.disc_net} "
        f"mixed_precision={a.mixed_precision} disc_mixed_precision={a.disc_mixed_precision} "
        f"disc_grad_penalty={a.disc_grad_penalty}")
    p0 = [p.detach().clone() for p in state[0].params.parameters()]
    torch.cuda.synchronize()
    rate, launches, info, peak, grew = _mode_iters(
        agent, state, g, "phase 12", track=lambda st: float(st[0].disc_norm.count))
    want = 2 * a.steps_per_iter * NUM_ENVS
    if grew != [want] * MODE_TIMED:
        raise AssertionError(f"the disc normalizer's count grew by {grew}, expected {want} each")
    missing = {"disc_loss", "disc_grad_penalty"} - set(info)
    if missing:
        raise AssertionError(f"AMP infos lack {sorted(missing)}")
    if not _changed(p0, state[0].params.parameters()):
        raise AssertionError("AMP train_iter left every parameter unchanged")
    log(f"[phase 12] amp train env-steps/s (median of {MODE_TIMED}): {rate:.1f}; {launches} "
        f"launches ({launches // (1 + MODE_TIMED)} per iteration); disc normalizer count "
        f"+{want} per iteration; disc_loss={info['disc_loss'].item():.4f} "
        f"disc_grad_penalty={info['disc_grad_penalty'].item():.4f} "
        f"disc_reward_mean={info['disc_reward_mean'].item():.4f}; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    split, total = _split(agent, state, g, "phase 12")
    return dict(rate=rate, launches=launches, split=split, total_ms=total, peak_bytes=peak)


def phase_train_ppo(g1_path, clip_path):
    """Plain PPO: config ppo256 as the file sets it, then agent=ppo_g1 at
    4096 envs; then SGD with the learned-std head at 4096 envs."""
    out = {}
    for label, name, num_envs, overrides, seed in (
            ("ppo256", "ppo256", None, (), 60),
            ("ppo", "train", NUM_ENVS, ("agent=ppo_g1",), 62)):
        env, agent, state, g = _train_setup(name, g1_path, clip_path, seed=seed,
                                            num_envs=num_envs, overrides=overrides)
        n, a = int(state[2].shape[0]), agent.cfg
        if a.disc_mode != "none" or not env.kernel or env.dr.enabled:
            raise AssertionError(f"{label} must train plain PPO through the main variant")
        if label == "ppo256" and n != 256:
            raise AssertionError(f"config ppo256 has {n} envs")
        disc = [k for k, _ in state[0].params.named_parameters() if k.startswith("disc")]
        if disc:
            raise AssertionError(f"{label}: disc parameters {disc}")
        log(f"[phase 13] {label}: config {name} {' '.join(overrides)} num_envs={n} "
            f"actor={a.actor_net} mixed_precision={a.mixed_precision} "
            f"task_reward_weight={a.task_reward_weight}")
        rate, launches, info, _, _ = _mode_iters(agent, state, g, f"phase 13 {label}")
        disc_keys = {k for k in info if k.startswith("disc_")}
        if disc_keys != {"disc_reward_mean", "disc_reward_std"} or any(
                info[k].item() != 0.0 for k in disc_keys):
            raise AssertionError(f"{label}: disc infos {disc_keys}")
        if info["task_reward_mean"].item() == 0.0:
            raise AssertionError(f"{label}: task_reward_mean is 0")
        log(f"[phase 13] {label} train env-steps/s (median of {MODE_TIMED}): {rate:.1f}; "
            f"{launches} launches ({launches // (1 + MODE_TIMED)} per iteration)")
        out[label] = rate

    env, agent, state, g = _train_setup(
        "train", g1_path, clip_path, seed=64,
        overrides=("agent.optimizer=sgd", "agent.actor_std_type=variable"))
    a = agent.cfg
    if not isinstance(state[0].opt_state, SGDState) or a.actor_std_type != "variable":
        raise AssertionError("sgd + variable: the agent has no SGD state or no logstd head")
    head = [p.detach().clone() for p in state[0].params.actor_logstd_head.parameters()]
    log(f"[phase 13] sgd + variable std: num_envs={NUM_ENVS} optimizer={a.optimizer} "
        f"momentum={a.momentum} actor_std_type={a.actor_std_type}")
    rate, launches, info, _, _ = _mode_iters(agent, state, g, "phase 13 sgd+variable")
    if not any(bool(t.abs().max() > 0) for t in state[0].opt_state.trace):
        raise AssertionError("sgd + variable: every SGD trace is zero")
    if not _changed(head, state[0].params.actor_logstd_head.parameters()):
        raise AssertionError("sgd + variable: the logstd head did not change")
    logstd = state[0].params.actor_logstd_head.bias
    log(f"[phase 13] sgd + variable train env-steps/s (median of {MODE_TIMED}): {rate:.1f}; "
        f"{launches} launches; logstd head bias {logstd.min().item():.5f}.."
        f"{logstd.max().item():.5f}")
    out["sgd_variable"] = rate
    return out


def _start_tool(args, where):
    """Start ``python -m <args>`` with its input from /dev/null and its
    output piped; ``_finish_tool`` waits for it."""
    cmd = [sys.executable, "-m", *args]
    log(f"[{where}] $ {' '.join(cmd)} (started)")
    return where, time.perf_counter(), subprocess.Popen(
        cmd, cwd=ROOT, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish_tool(started):
    where, t0, proc = started
    try:
        out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"{where}: exit {proc.returncode}\n{out[-4000:]}\n{err[-4000:]}")
    log(f"[{where}] exit 0, {time.perf_counter() - t0:.1f} s after its start")
    return out


def phase_video_small_check(g1_path, clip_path):
    """8 steps of eval_rollout_states at 64 envs: kernel vs plain step, the
    same reset draws; FK of the recorded states on the card vs the CPU."""
    n, steps = 64, 8
    outs = []
    for kernel in ("on", "off"):
        cfg = _slice_cfg(g1_path, clip_path, n, STEPS, mixed=False, kernel=kernel,
                         net="fc_2layers_64units")
        env = build_env(cfg, device=DEVICE)
        agent = build_agent(cfg, env)
        ts, es, obs = _start(env, agent, n, seed=60)
        g = torch.Generator(device=DEVICE)
        g.manual_seed(61)
        draws = agent.sample_rollout_draws(ts, n, steps, g)
        outs.append(agent.eval_rollout_states(ts, es, obs, steps, draws=draws)[2])
    if not torch.equal(outs[0]["motion_id"], outs[1]["motion_id"]):
        raise AssertionError("phase 14a: kernel and plain recorded other motion ids")
    worst = 0.0
    for k in ("root_pos", "root_quat", "dof_pos", "motion_time"):
        a, b = outs[0][k], outs[1][k]
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3, msg=lambda m: f"{k}: {m}")
        worst = max(worst, (a - b).abs().max().item())
    char = env.char
    st = outs[0]
    fk = [char.forward_kinematics(st["root_pos"].to(dev), st["root_quat"].to(dev),
                                  char.dof_to_rot(st["dof_pos"].to(dev)))
          for dev in (DEVICE, "cpu")]
    fk_err = 0.0
    for a, b in zip(*fk):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
        fk_err = max(fk_err, (a.cpu() - b).abs().max().item())
    log(f"[phase 14a] eval_rollout_states 64 envs x {steps} steps, kernel vs plain max abs diff "
        f"{worst:.3e} (rtol=atol=1e-3); FK card vs CPU max abs diff {fk_err:.3e} (atol 1e-5)")


def phase_native(clip_path, mesh_dir):
    """The native loader against the numpy readers, exactly."""
    import glob

    from add_gym_torch import native
    from add_gym_torch.physics.stl import stl_aabb as np_stl_aabb

    if not native.available():
        raise AssertionError("phase 14f: the native loader did not build with g++")
    frames = native.parse_motion_csv(clip_path)
    if not np.array_equal(frames, np.loadtxt(clip_path, delimiter=",", dtype=np.float64)):
        raise AssertionError("phase 14f: native CSV parse differs from np.loadtxt")
    stls = sorted(glob.glob(os.path.join(mesh_dir, "*_vis.STL")))
    for path in stls:
        got, want = native.stl_aabb(path), np_stl_aabb(path)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"phase 14f: native STL AABB of {path} differs: {got} {want}")
    log(f"[phase 14f] native loader {os.path.relpath(native.library_path(), ROOT)}: CSV "
        f"{frames.shape} and {len(stls)} STL AABBs equal the numpy readers exactly")


def phase_video(mesh_path, g1_path, clip_path):
    """The video and tools path (phase 14)."""
    import importlib.util

    from add_gym_torch.kinematics.char_model import load_char_model
    from add_gym_torch.learning.runner import Trainer
    from add_gym_torch.motion.motion_lib import load_motion_lib

    out_dir = os.path.join(ROOT, "build", "add_gym_torch", "smoke_video")
    if os.path.isdir(out_dir):
        import shutil

        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    view_npz = os.path.join(out_dir, "view.npz")
    artifact = os.path.join(out_dir, "artifact")
    ckpt = os.path.join(ROOT, "build", "add_gym_torch", "smoke_logs", "cli", "checkpoint")
    tools = [
        _start_tool(["add_gym_torch.cli.view", f"robot.asset_path={g1_path}",
                     f"task.motion_file={clip_path}", f"out={view_npz}"], "phase 14c"),
        _start_tool(["add_gym_torch.cli.probe", f"robot.asset_path={g1_path}",
                     f"task.motion_file={clip_path}"], "phase 14d"),
        _start_tool(["add_gym_torch.cli.publish", ckpt, artifact, "--name", "smoke"],
                    "phase 14e"),
    ]
    phase_video_small_check(g1_path, clip_path)
    phase_native(clip_path, os.path.dirname(mesh_path))
    view_out, probe_out, _ = (_finish_tool(t) for t in tools)

    # (c) the viewer ran on the card; its poses against FK on the CPU
    char = load_char_model(g1_path)
    motion = load_motion_lib(clip_path, fx.MOTION_JOINT_ORDER, char, dt=1.0 / 30.0)
    from add_gym_torch.cli.view import playback_poses

    _, want, _ = playback_poses(char, motion, fps=30.0)
    got = np.load(view_npz)
    if "on cuda" not in view_out or got["body_pos"].shape != want.shape:
        raise AssertionError(f"phase 14c: {view_out[-400:]} {got['body_pos'].shape} {want.shape}")
    view_err = float(np.abs(got["body_pos"] - want).max())
    if view_err > 1e-5:
        raise AssertionError(f"phase 14c: view body_pos differs from CPU FK by {view_err}")
    log(f"[phase 14c] cli.view on the card: {want.shape[0]} frames, npz keys "
        f"{sorted(got.files)}, body_pos vs CPU FK max abs diff {view_err:.3e} (atol 1e-5)")
    # (d) the probe
    if "bodies: 30  dofs: 29" not in probe_out:
        raise AssertionError(f"phase 14d: probe printed {probe_out[:400]}")
    log(f"[phase 14d] cli.probe: {probe_out.splitlines()[0]}")
    # (e) the published parameters
    saved = torch.load(os.path.join(ckpt, "train_state.pt"), map_location="cpu",
                       weights_only=True)["train_state"]["params"]
    published = torch.load(os.path.join(artifact, "model.pt"), weights_only=True)
    if published.keys() != saved.keys() or not all(
            torch.equal(published[k], saved[k]) for k in saved):
        raise AssertionError("phase 14e: model.pt differs from the checkpoint's parameters")
    with open(os.path.join(artifact, "metadata.json")) as f:
        meta = json.load(f)
    log(f"[phase 14e] cli.publish: model.pt equals the checkpoint's {len(saved)} parameter "
        f"tensors bit for bit; metadata {meta}")

    # (b) the Trainer's video at full width, timed alone
    has_pil = importlib.util.find_spec("PIL") is not None
    log(f"[phase 14b] PIL importable: {has_pil}")
    cfg = _slice_cfg(mesh_path, clip_path, NUM_ENVS, STEPS)
    cfg.update(device=DEVICE, log_dir=out_dir, experiment_name="video")
    trainer = Trainer(cfg)
    path = os.path.join(out_dir, "rollout.gif")
    reset_counts()
    info = trainer.record_video(path, seconds=4.0)
    counts = (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.np_launches,
              cs.sharded_cuda_step.launches)
    trainer.close()
    if counts != (400, 0, 0, 0):
        raise AssertionError(f"phase 14b: {counts} main / per-env / with-rows / sharded "
                             f"launches for a 4-s video, expected 400 / 0 / 0 / 0")
    d = np.load(path + ".npz")
    for k, shape in (("body_pos", (400, 30, 3)), ("body_rot", (400, 30, 4)),
                     ("ghost_body_pos", (400, 30, 3)), ("ghost_body_rot", (400, 30, 4))):
        if d[k].shape != shape or not np.isfinite(d[k]).all():
            raise AssertionError(f"phase 14b: {k} {d[k].shape}, finite {np.isfinite(d[k]).all()}")
    if has_pil:
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise AssertionError("phase 14b: PIL imports but no GIF was written")
        log(f"[phase 14b] GIF {os.path.getsize(path)} bytes; render "
            f"{info['render_ms_per_frame']:.3f} ms per frame (mesh render + GIF encode, host)")
    else:
        log("[phase 14b] no PIL on this machine: the render was not run on the card "
            "(the CPU tests hold it)")
    log(f"[phase 14b] record_video at {NUM_ENVS} envs on the mesh fixture: {counts[0]} "
        f"main-variant launches; video rollout {info['rollout_ms']:.1f} ms "
        f"({info['rollout_ms'] / 400:.3f} ms per step); npz {sorted(d.files)}")
    return dict(video_rollout_ms=info["rollout_ms"], video_launches=counts[0],
                render_ms_per_frame=info["render_ms_per_frame"],
                view_frames=int(want.shape[0]))


def phase_hands_cli(dex3_path, dex3_clip):
    """Phase 14g: ``cli.train`` on the G1 with Dex3-1 hands, 2 iterations
    at 4096 envs, in this process: every launch of the wide instance."""
    from port_bench import inputs

    logs = os.path.join(ROOT, "build", "add_gym_torch", "smoke_logs_dex3")
    args = ["train", f"robot.asset_path={dex3_path}", f"task.motion_file={dex3_clip}",
            f"task.motion_joint_order={list(inputs.G1_DEX3_MOTION_JOINT_ORDER)!r}",
            f"engine.num_envs={NUM_ENVS}",
            "test_episodes=0", f"log_dir={logs}", "experiment_name=dex3", "max_iters=2",
            "device=cuda"]
    reset_counts()
    cs.cuda_step.wide_launches = 0
    f = ImitationEnv.rollout_step_cached
    replays0 = f.replays
    t0 = time.perf_counter()
    cli_main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.wide_launches)
    if counts != (2 * STEPS, 0, 2 * STEPS):
        raise AssertionError(f"phase 14g: launches (main, per-env, wide) {counts}, expected "
                             f"{(2 * STEPS, 0, 2 * STEPS)}")
    replays = f.replays - replays0
    with open(os.path.join(logs, "dex3", "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    if len(rows) != 2 or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"phase 14g: metrics.jsonl rows {rows}")
    log(f"[phase 14g] cli.train on g1_dex3 at {NUM_ENVS} envs, 2 iterations in {seconds:.1f} s: "
        f"launches (main, per-env, wide) {counts}, graph replays {replays}; iteration 2 "
        f"{rows[1]['env_steps_per_s']:.1f} env-steps/s")
    return dict(launches=counts[2], replays=replays, rate=rows[1]["env_steps_per_s"])


def compare_kernel(other_dir) -> int:
    """This checkout's kernel against the one in ``other_dir`` (another
    checkout), main variant, the same 4096-env input, timed in turns."""
    import importlib.util

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    path = os.path.join(os.path.abspath(other_dir), "add_gym_torch", "physics", "cuda_step.py")
    spec = importlib.util.spec_from_file_location("other_cuda_step", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    for name, mod in (("other", other), ("this", cs)):
        build = mod.build_library()
        log(f"[compare] {name} kernel {build['path']} built in {build['seconds']:.1f} s")
        for line in build["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "stack")):
                log(f"[compare] {name} ptxas: {line.strip()}")
    model, fc, params = model_setup(fx.write_g1_fixture(FIXTURES), "g1")
    fc_other = FusedModelConstants(model)    # each module caches its buffers on its own fc
    fields, cmd = fx.random_sim_state(model, NUM_ENVS, seed=7, height=fx.G1_PELVIS_HEIGHT)
    inp = cs.pack_state(sim_state(fields, DEVICE), torch.as_tensor(cmd, device=DEVICE))
    runs = {"other": lambda: other.launch_control_step(fc_other, params, inp),
            "this": lambda: cs.launch_control_step(fc, params, inp)}
    times = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        times[name].append(time_ms(runs[name], TIMING_LAUNCHES))
        log(f"[compare] {name}: {times[name][-1]:.4f} ms/launch at N={NUM_ENVS} "
            f"(CUDA events, {TIMING_LAUNCHES} launches)")
    (a_state, a_contact), (b_state, b_contact) = (
        cs.unpack_state(runs[name](), model.nd) for name in ("other", "this"))
    diff = {f: (getattr(a_state, f) - getattr(b_state, f)).abs().max().item()
            for f in fx.STATE_FIELDS}
    diff["contact"] = (a_contact - b_contact).abs().max().item()
    print(json.dumps({"compare_kernel": {"n": NUM_ENVS, "other_ms": times["other"],
                                         "this_ms": times["this"], "max_abs_diff": diff}}))
    print(card_line())
    return 0


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
        if any(w in line for w in ("entry function", "registers", "spill", "stack", "smem")):
            log(f"[phase 1] ptxas: {line.strip()}")
    for cap in cs.INSTANCES:
        for per in (False, True):
            log(f"[phase 1] {cap}-body instance, {'per-env' if per else 'main'} variant launch "
                f"shape: {cs.kernel_info(per, cap)}")

    from port_bench import inputs

    mini_path = fx.write_mini_mjcf(FIXTURES)
    g1_path, clip_path = fx.write_slice_files(FIXTURES)
    dex3_path, dex3_clip = inputs.write_inputs(FIXTURES, clip_seed=0, name="g1_dex3")

    worst = phase_kernel_vs_plain(mini_path, g1_path)
    worst_dr = phase_dr_kernel_vs_plain(g1_path)
    worst_np = phase_np_kernel_vs_plain(g1_path)
    worst_wide = phase_hands_kernel_vs_plain(dex3_path)
    phase_small_slice_check(g1_path, clip_path)
    env_steps_per_s = phase_slice(g1_path, clip_path)
    times = {"main": phase_times(g1_path, False), "dr": phase_times(g1_path, True),
             "np": phase_times(g1_path, False, geoms=True),
             "wide": phase_times(dex3_path, False), "wide_dr": phase_times(dex3_path, True)}
    np_ext = times["np"][4]
    sweep = phase_sweep(g1_path)
    train = phase_train(g1_path, clip_path)
    train_dr = phase_train_dr(g1_path, clip_path)
    np_env, train_np = phase_train_np(g1_path, clip_path)
    phase_parity(np_env)
    worst_sharded, shard_times = phase_sharded(g1_path)
    cli = phase_cli(g1_path, clip_path)
    two = phase_two_ranks(g1_path, clip_path)
    amp = phase_train_amp(g1_path, clip_path)
    ppo = phase_train_ppo(g1_path, clip_path)
    video = phase_video(fx.write_mesh_fixture(FIXTURES), g1_path, clip_path)
    hands = phase_hands_cli(dex3_path, dex3_clip)

    entries = []
    for name, key, launches, errs, replaces in (
        ("control_step", "main", train["launches"], worst, 74),
        ("control_step_dr", "dr", train_dr["launches"], worst_dr, 74),
        ("control_step_np", "np", train_np["launches"], worst_np[False], 88),
        ("control_step_wide", "wide", hands["launches"], worst_wide, 74),
    ):
        kernel_ms, plain_ms, bound_ms, bound_by = times[key][:4]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "add_gym_torch/csrc/control_step.cu",
            "replaces": f"add_gym_tpu/physics/pallas_step.py:{replaces}",
            "launches": launches,
            "max_abs_err": max(errs.values()),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "design": DESIGN_WIDE if key == "wide" else DESIGN,
        })
    kernel_ms, plain_ms, bound_ms, bound_by = shard_times[SHARD_ENVS[0]]
    entries.append({
        "name": "control_step_sharded",
        "route": "cuda",
        "source": "add_gym_torch/csrc/control_step.cu",
        "replaces": "add_gym_tpu/physics/pallas_step.py:347",
        "launches": two["launches"],
        "max_abs_err": worst_sharded,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "design": DESIGN + "; the same kernel launched per rank",
    })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "rollout_env_steps_per_s": env_steps_per_s,
        "train_env_steps_per_s": train["rate"],
        "train_split_ms": train["split"], "train_iter_ms": train["total_ms"],
        "train_peak_device_bytes": train["peak_bytes"],
        "train_floor_ratio": train["bench"]["floor_ratio"],
        "train_derived_ceiling": train["bench"]["derived_ceiling"],
        "train_device_busy_share": train["bench"]["device_busy_share"],
        "dr_train_env_steps_per_s": train_dr["rate"],
        "np_train_env_steps_per_s": train_np["rate"], "np_train_iter_ms": train_np["iter_ms"],
        "np_train_peak_device_bytes": train_np["peak_bytes"],
        "compute_np_ext_ms": np_ext["ms"], "compute_np_ext_device_ops": np_ext["device_ops"],
        "np_per_env_max_abs_err": max(worst_np[True].values()),
        "kernel_sweep": {str(n): v for n, v in sweep.items()},
        "sharded_ms_per_launch": {str(n): t[0] for n, t in shard_times.items()},
        "sharded_bound_ms": {str(n): t[2] for n, t in shard_times.items()},
        "cli_env_steps_per_s": [cli["rate_iter2"], cli["rate_iter3"]],
        "two_ranks_one_card_env_steps_per_s": two["rate"],
        "amp_train_env_steps_per_s": amp["rate"], "amp_train_split_ms": amp["split"],
        "amp_train_iter_ms": amp["total_ms"], "amp_train_peak_device_bytes": amp["peak_bytes"],
        "ppo256_train_env_steps_per_s": ppo["ppo256"], "ppo_train_env_steps_per_s": ppo["ppo"],
        "sgd_variable_train_env_steps_per_s": ppo["sgd_variable"],
        "wide_dr_ms_per_launch": times["wide_dr"][0], "wide_dr_bound_ms": times["wide_dr"][2],
        "dex3_cli_env_steps_per_s": hands["rate"],
        "smoke_seconds": time.perf_counter() - T_START,
        "num_envs": NUM_ENVS, "steps_per_iter": STEPS,
    }))
    print(json.dumps(video))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--two-rank-worker"]:
        two_rank_worker(*sys.argv[2:5])
        sys.exit(0)
    if sys.argv[1:2] == ["--compare-kernel"]:
        sys.exit(compare_kernel(sys.argv[2]))
    sys.exit(main())
