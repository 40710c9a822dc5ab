"""Imitation environment on device tensors.

Counterpart of ``add_gym_tpu/envs/imitation.py``: one ``EnvState`` of
``[N, ...]`` tensors and the functions the train rollout runs on it:
``reset_where`` (masked reset to sampled reference poses, with fresh
domain-randomization draws when it is on), ``compute_obs``, ``step``
(physics step with the per-env parameters and the latency blend of domain
randomization, reward and done), ``rollout_step_cached`` (the same step,
masked reset and both observation passes, with the incremental motion-row
window; for non-consecutive ``tar_obs_steps`` it composes ``step``,
``reset_where`` and ``compute_obs`` on the same presampled draws) and
``rollout_step`` (the same, drawing its own resets; evaluation's step).

Inside ``ImitationEnv.graphed_steps`` (the train rollout's scope),
``rollout_step_cached`` through the CUDA kernel runs its body as one CUDA graph
(``_StepGraph``): captured at the scope's first step, replayed at every
later one, released when the scope closes.  The env's first step at a
shape runs eagerly on the capture stream instead, and the graph is captured
at the next.
"""

from __future__ import annotations

import gc
from contextlib import contextmanager
from dataclasses import dataclass, fields, replace
from typing import Sequence

import numpy as np
import torch

from add_gym_torch.envs import obs as obs_mod
from add_gym_torch.envs.domain_rand import DRConfig, init_dr_state, sample_dr
from add_gym_torch.envs.done import DoneFlags, compute_done
from add_gym_torch.envs.reward import compute_reward
from add_gym_torch.learning import sampler as sampler_mod
from add_gym_torch.motion.motion_lib import MotionLib
from add_gym_torch.parallel.mesh import EnvShard
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics.engine import EngineParams, SimState, default_state
from add_gym_torch.physics.fused_step import FusedModelConstants
from add_gym_torch.physics.model import PhysicsModel
from add_gym_torch.utils.device import resolve_device
from add_gym_torch.utils.trace import span


@dataclass(frozen=True)
class TaskConfig:
    """Static task parameters (configs/task/pose.yaml)."""

    max_episode_length: float = 20.0
    global_obs: bool = True
    root_height_obs: bool = True
    pose_termination: bool = True
    pose_termination_dist: float = 1.0
    enable_phase_obs: bool = False
    enable_tar_obs: bool = True
    num_phase_encoding: int = 4
    tar_obs_steps: Sequence[int] = (1, 2, 3, 4, 5, 6)
    num_disc_obs_steps: int = 3
    rand_reset: bool = True
    enable_early_termination: bool = True
    enable_vel_obs: bool = False
    contact_bodies: Sequence[str] = (
        "left_knee_link", "left_ankle_pitch_link", "left_ankle_roll_link",
        "right_knee_link", "right_ankle_pitch_link", "right_ankle_roll_link",
    )
    reward_pose_w: float = 0.5
    reward_vel_w: float = 0.1
    reward_root_pose_w: float = 0.15
    reward_root_vel_w: float = 0.1
    reward_pose_scale: float = 0.25
    reward_vel_scale: float = 0.01
    reward_root_pose_scale: float = 5.0
    reward_root_vel_scale: float = 1.0
    sampler_num_segments: int = 20
    sampler_temperature: float | None = None

    @property
    def track_root(self) -> bool:
        return self.enable_tar_obs and self.global_obs


@dataclass(frozen=True)
class EnvState:
    """Batched environment state (sim + task bookkeeping + disc history)."""

    sim: SimState
    time: torch.Tensor               # [N]
    motion_ids: torch.Tensor         # [N] int64
    motion_offsets: torch.Tensor     # [N]
    done: torch.Tensor               # [N] int32 DoneFlags
    # discriminator history, oldest -> newest along axis 1 (H steps)
    hist_root_pos: torch.Tensor      # [N, H, 3]
    hist_root_rot: torch.Tensor      # [N, H, 4]
    hist_root_vel: torch.Tensor      # [N, H, 3]
    hist_root_ang_vel: torch.Tensor  # [N, H, 3]
    hist_dof_pos: torch.Tensor       # [N, H, D]
    hist_dof_vel: torch.Tensor       # [N, H, D]
    dr: dict                         # per-env domain-randomization state


def to_device(x, device, dtype):
    """A tensor or array-like as a tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x))
    return x.to(device=device, dtype=dtype)


def _where_env(mask, new, old):
    """Per-env select over every tensor of a state (mask [N] bool)."""
    if isinstance(new, (SimState, EnvState)):
        return type(new)(**{
            f.name: _where_env(mask, getattr(new, f.name), getattr(old, f.name))
            for f in fields(new)
        })
    if isinstance(new, dict):
        return {k: _where_env(mask, new[k], old[k]) for k in new}
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


class ImitationEnv:
    """Binds model + motion data + config; all runtime data lives in ``EnvState``.

    Physics backends (the same function, held to each other by the tests
    and by ``utils/debug.parity_check``): ``kernel=True`` steps through the
    CUDA kernel (``physics/cuda_step.py``); otherwise ``fused=True`` through
    the plain env-minor step (``physics/fused_step.py``) and
    ``fused=False`` through the reference-layout engine
    (``physics/engine.py``), which the kernel cannot be.  ``device``
    defaults to the card and raises where there is none.

    Under data parallelism ``shard`` (``parallel.mesh.EnvShard``) names
    this rank's envs: every state holds only those, and the kernel runs
    through its sharded wrapper (``cuda_step.sharded_cuda_step``).  The
    per-env parameters are drawn for the local envs, so the plain steps
    need no slicing.  Reset and domain-randomization draws come from the
    caller's (per-rank) generator.
    """

    def __init__(
        self,
        model: PhysicsModel,
        motion: MotionLib,
        engine_params: EngineParams,
        task: TaskConfig = TaskConfig(),
        kernel: bool = False,
        fused: bool = True,
        device="cuda",
        dr: DRConfig = DRConfig(),
        shard: EnvShard | None = None,
        char=None,
    ):
        if kernel and not fused:
            raise ValueError("the control-step kernel is a fused backend: kernel needs fused=True")
        self.device = resolve_device(device)
        self.shard = shard
        self.model = model
        self.char = char  # the kinematic CharModel (video recording)
        self.motion = motion
        self.params = engine_params
        self.task = task
        self.dr = dr
        self.ctrl_dt = engine_params.ctrl_dt
        self.kernel = kernel
        self.fused = fused
        self._fc = FusedModelConstants(model)
        if kernel and shard is not None:
            from add_gym_torch.physics.cuda_step import sharded_cuda_step
            self._step_fn = lambda p, s, t: sharded_cuda_step(self._fc, p, s, t, shard)
        elif kernel:
            from add_gym_torch.physics.cuda_step import cuda_step
            self._step_fn = lambda p, s, t: cuda_step(self._fc, p, s, t)
        elif fused:
            from add_gym_torch.physics.fused_step import fused_step
            self._step_fn = lambda p, s, t: fused_step(self._fc, p, s, t)
        else:
            from add_gym_torch.physics.engine import step as engine_step
            self._step_fn = lambda p, s, t: engine_step(self.model, p, s, t)

        contact_set = set(task.contact_bodies)
        self.noncontact_mask = torch.as_tensor(
            [name not in contact_set for name in model.body_names], device=self.device
        )
        self.tar_steps = np.asarray(task.tar_obs_steps, np.int64)
        # time offsets of the motion-row window relative to the current
        # motion time: H history rows (oldest -> newest) then K target rows
        H = task.num_disc_obs_steps
        dt = self.ctrl_dt
        win = -dt * torch.arange(H - 1, -1, -1, dtype=torch.float32, device=self.device)
        if task.enable_tar_obs and len(self.tar_steps):
            tar = dt * torch.as_tensor(self.tar_steps, dtype=torch.float32, device=self.device)
            win = torch.cat([win, tar])
        self.window_offsets = win
        self.seg_sizes = motion.lengths / task.sampler_num_segments
        self.min_start_time = (task.num_disc_obs_steps - 1) * self.ctrl_dt
        lim = torch.as_tensor(model.dof_limit, device=self.device)
        self.dof_lo, self.dof_hi = lim[:, 0], lim[:, 1]
        self._dof_err_w = torch.ones(model.nd, device=self.device)

        # action bounds = limits mid +- 1.4 x half-range
        lim = np.asarray(model.dof_limit)
        mid = 0.5 * (lim[:, 0] + lim[:, 1])
        scale = 1.4 * np.maximum(np.abs(lim[:, 1] - mid), np.abs(lim[:, 0] - mid))
        self.action_low = mid - scale
        self.action_high = mid + scale

        self._graph_scope = False    # graphed_steps is open
        self._step_graph = None      # the scope's graph, once captured
        self._graph_stream = None    # the side stream graphs are captured on
        self._graph_warm = set()     # shapes the body has run at on that stream
        # the last graph captured: it keeps the private memory pool alive
        # for the next capture to share
        self._graph_keeper = None

    # ------------------------------------------------------------- obs sizes

    @property
    def num_dofs(self) -> int:
        return self.model.nd

    def obs_dim(self) -> int:
        d = self.model.nd
        char = (1 if self.task.root_height_obs else 0) + 6 + d
        if self.task.enable_vel_obs:
            char += 3 + 3 + d
        total = char
        if self.task.enable_phase_obs:
            total += 1 + 2 * self.task.num_phase_encoding
        if self.task.enable_tar_obs:
            per = (3 if self.task.root_height_obs else 2) + 6 + d
            total += per * len(self.tar_steps)
        return total

    def disc_obs_dim(self) -> int:
        d = self.model.nd
        per = 3 + 6 + d
        if self.task.enable_vel_obs:
            per += 3 + 3 + d
        return per * self.task.num_disc_obs_steps

    # -------------------------------------------------------------- builders

    def init_state(self, num_envs: int) -> EnvState:
        H, D = self.task.num_disc_obs_steps, self.model.nd
        z = lambda *s: torch.zeros((num_envs,) + s, device=self.device)
        quat = z(H, 4)
        quat[..., 0] = 1.0
        return EnvState(
            sim=default_state(self.model, num_envs, device=self.device),
            time=z(),
            motion_ids=torch.zeros(num_envs, dtype=torch.int64, device=self.device),
            motion_offsets=z(),
            done=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            hist_root_pos=z(H, 3),
            hist_root_rot=quat,
            hist_root_vel=z(H, 3),
            hist_root_ang_vel=z(H, 3),
            hist_dof_pos=z(H, D),
            hist_dof_vel=z(H, D),
            dr=init_dr_state(num_envs, self.device),
        )

    # ----------------------------------------------------------------- steps

    def motion_times(self, state: EnvState):
        return state.time + state.motion_offsets

    def _effective_params(self, state: EnvState) -> EngineParams:
        """The engine params with the per-env domain-randomization scales."""
        if not self.dr.enabled:
            return self.params
        dr = state.dr
        p = replace(
            self.params,
            kp=self.params.kp[None, :] * dr["kp_scale"][:, None],
            kv=self.params.kv[None, :] * dr["kv_scale"][:, None],
            friction_mu=self.params.friction_mu * dr["friction_mu"],
        )
        if self.dr.mass_enabled:
            p = replace(p, mass_scale=p.mass_scale * dr["mass_scale"])
        return p

    def _physics(self, state: EnvState, pd_target):
        """Control step with the latency blend and per-env params of domain
        randomization."""
        if self.dr.enabled and self.dr.action_latency_range[1] > 0:
            # first-order actuation delay: blend the fresh command with the
            # previously applied target
            a = state.dr["latency"][:, None]
            pd_target = (1.0 - a) * pd_target + a * state.sim.pd_target
        return self._step_fn(self._effective_params(state), state.sim, pd_target)

    def step(self, state: EnvState, pd_target):
        """Physics step + task update.

        Returns (state, obs, disc_obs, disc_obs_demo, reward, done).
        """
        sim, body_contact = self._physics(state, pd_target)
        time = state.time + self.ctrl_dt
        state = self._push_history(replace(state, sim=sim, time=time))

        # reference frame at the current motion time
        mt = self.motion_times(state)
        ref = self.motion.get_motion_step(state.motion_ids, mt)

        obs = self.compute_obs(state)
        disc_obs = self._disc_obs_from_hist(state)
        disc_obs_demo = self._disc_obs_demo(state.motion_ids, mt)
        reward = self._reward(sim, ref)

        meta = self.motion.meta_all[state.motion_ids]      # [N, 7]
        done = self._done(time, sim, ref, body_contact, mt, meta)
        state = replace(state, done=done)
        return state, obs, disc_obs, disc_obs_demo, reward, done

    def _done(self, time, sim: SimState, ref, body_contact, mt, meta):
        t = self.task
        return compute_done(
            time, sim.root_pos, sim.dof_pos, ref[0], ref[4], body_contact,
            mt, meta[:, 0], meta[:, 1] == 0.0,
            ep_len=t.max_episode_length,
            noncontact_body_mask=self.noncontact_mask,
            pose_termination=t.pose_termination,
            pose_termination_dist=t.pose_termination_dist,
            enable_early_termination=t.enable_early_termination,
            track_root=t.track_root,
        )

    @property
    def _aux_shiftable(self) -> bool:
        """The incremental row window needs tar_obs_steps = 1..K."""
        K = len(self.tar_steps) if self.task.enable_tar_obs else 0
        return not K or bool(np.array_equal(self.tar_steps, np.arange(1, K + 1)))

    def motion_aux(self, state: EnvState):
        """Motion-row cache [N, H+K, R] aligned to the current motion time."""
        mt = self.motion_times(state)
        times = mt[:, None] + self.window_offsets[None, :]
        ids = state.motion_ids[:, None].expand(times.shape)
        return self.motion.get_motion_rows(ids, times)

    def _reward(self, sim: SimState, ref):
        t = self.task
        return compute_reward(
            sim.root_pos, sim.root_quat, sim.root_vel, sim.root_ang_vel,
            sim.dof_pos, sim.dof_vel,
            ref[0], ref[1], ref[2], ref[3], ref[4], ref[5],
            self._dof_err_w,
            track_root_h=t.root_height_obs, track_root=t.track_root,
            pose_w=t.reward_pose_w, vel_w=t.reward_vel_w,
            root_pose_w=t.reward_root_pose_w, root_vel_w=t.reward_root_vel_w,
            pose_scale=t.reward_pose_scale, vel_scale=t.reward_vel_scale,
            root_pose_scale=t.reward_root_pose_scale,
            root_vel_scale=t.reward_root_vel_scale,
        )

    def rollout_step(self, state: EnvState, pd_target, sampler_state, generator=None,
                     draws=None):
        """Step, masked reset and both obs passes, drawing the resets itself:
        the step the evaluation rollout takes (``ADDAgent.rollout``).

        ``draws = (ids, times)`` or ``(ids, times, dr)`` replaces the reset
        draws of this step (the JAX package takes them from the step's key:
        motion ids, start times and domain randomization, in that order);
        without ``dr`` it is drawn from ``generator``.  Returns
        ``(state3, obs_after, out)`` as :meth:`rollout_step_cached`.
        """
        N = state.time.shape[0]
        if draws is None:
            draws = self.sample_resets(N, sampler_state, generator)
        ids_f, times_f = draws[:2]
        dr = draws[2] if len(draws) > 2 else self.sample_dr(N, generator)
        ids_f = to_device(ids_f, self.device, torch.int64)
        times_f = to_device(times_f, self.device, torch.float32)
        dr = {k: to_device(v, self.device, torch.float32) for k, v in dr.items()}
        aux = self.motion_aux(state) if self._aux_shiftable else None
        state3, obs_after, _, out = self.rollout_step_cached(
            state, pd_target, aux, ids_f, times_f, dr)
        return state3, obs_after, out

    def rollout_step_cached(self, state: EnvState, pd_target, aux, ids_f, times_f, dr):
        """Presampled, aux-carried rollout step.

        ``aux`` is the [N, H+K, R] motion-row cache aligned to the pre-step
        motion time (:meth:`motion_aux`); advancing one control step shifts
        it by one row and gathers one fresh row per env.  ``ids_f`` /
        ``times_f`` / ``dr`` (a dict of [N] tensors, see
        ``domain_rand.sample_dr``) are the reset draws for envs that finish
        this step.  Returns ``(state3, obs_after, aux3, out)``.

        Non-consecutive ``tar_obs_steps`` have no incremental window: the
        step then composes :meth:`step`, :meth:`reset_where` and
        :meth:`compute_obs` on the same draws, ``aux`` is not read and
        ``aux3`` is None.

        Each section runs in a span of ``utils.trace`` (recorded only while
        a profiler runs): ``env.physics``, ``env.motion``,
        ``env.reward_done``, ``env.reset`` and ``env.obs``; the composed
        step has ``env.physics`` (all of :meth:`step`), ``env.reset`` and
        ``env.obs``.

        Inside :meth:`graphed_steps`, with the kernel backend on CUDA
        tensors and the incremental window, the body runs as one CUDA graph
        (``_StepGraph``, the kernel launched inside it: spans
        ``env.capture`` at the first step, whose body's spans nest in it,
        and ``env.graph`` at every step); every tensor it returns is fresh
        for the call.  The env's first step at a shape runs eagerly on the
        capture stream (:meth:`_warm_step`), and the graph is captured at the
        next.  Elsewhere it runs eagerly.  The function attributes
        ``captures``, ``replays`` and ``eager`` count graphs captured, steps
        replayed and steps run eagerly.
        """
        args = (state, pd_target, aux, ids_f, times_f, dr)
        if self._graph_scope and self.kernel and pd_target.is_cuda and self._aux_shiftable:
            key = (tuple(pd_target.shape), tuple(aux.shape))
            if self._step_graph is None:
                if key not in self._graph_warm:
                    return self._warm_step(args, key)
                self._step_graph = _StepGraph(self, args, key)
            if self._step_graph.key == key:
                return self._step_graph(args)
        _step_counts.eager += 1
        return self._rollout_step_body(*args)

    def _warm_step(self, args, key):
        """The step run eagerly on the env's capture stream, the env's first
        at these shapes (torch's graph notes ask for a warm-up on the side
        stream): it builds the kernel, fills the caches of device constants,
        which a capture cannot copy from the host, and gives the stream its
        cuBLAS workspace.  Its outputs are the step's."""
        dev = args[1].device
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(dev)
        stream, current = self._graph_stream, torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        # the outputs' memory returns to this stream's free blocks; every
        # later use of the stream first waits for the current one, so none
        # is reused while the current stream still reads it
        with torch.cuda.stream(stream):
            out = self._rollout_step_body(*args)
        current.wait_stream(stream)
        self._graph_warm.add(key)
        _step_counts.eager += 1
        return out

    @contextmanager
    def graphed_steps(self):
        """The scope of one train rollout: inside it :meth:`rollout_step_cached`
        through the kernel on CUDA tensors replays one CUDA graph of its
        body, captured at its first call (a call of other shapes runs
        eagerly).  The graph's buffers are released when the scope closes;
        its private memory pool, and the blocks the pool has reserved, stay
        for the next scope's capture.  A nested scope is the outer one."""
        if self._graph_scope:
            yield
            return
        self._graph_scope = True
        try:
            yield
        finally:
            self._graph_scope, self._step_graph = False, None

    def _rollout_step_body(self, state: EnvState, pd_target, aux, ids_f, times_f, dr):
        """The body of :meth:`rollout_step_cached`, run eagerly or captured."""
        task = self.task
        N = state.time.shape[0]
        H = task.num_disc_obs_steps
        K = len(self.tar_steps) if task.enable_tar_obs else 0
        dt = self.ctrl_dt
        if not self._aux_shiftable:
            with span("env.physics"):
                state2, next_obs, disc_obs, disc_obs_demo, reward, done = self.step(
                    state, pd_target)
            out = dict(
                reward=reward, done=done, disc_obs=disc_obs,
                disc_obs_demo=disc_obs_demo, motion_ids=state.motion_ids,
                motion_times=self.motion_times(state2), ep_time=state2.time,
                next_obs=next_obs,
            )
            reset = done != int(DoneFlags.NULL)
            with span("env.reset"):
                state3 = self.reset_where(state2, reset, None, draws=(ids_f, times_f, dr))
            with span("env.obs"):
                return state3, self.compute_obs(state3), None, out

        # --- physics --------------------------------------------------
        with span("env.physics"):
            sim, body_contact = self._physics(state, pd_target)
            time = state.time + dt
            state2 = self._push_history(replace(state, sim=sim, time=time))
            mt = time + state.motion_offsets
            ids = state.motion_ids

        # --- advance the motion-row cache: shift + one fresh row -------
        with span("env.motion"):
            new_t = mt + (K * dt if K else 0.0)
            new_row = self.motion.get_motion_rows(ids, new_t)      # [N, R]
            aux_cur = torch.cat([aux[:, 1:], new_row[:, None]], dim=1)
            win = self.motion.split_rows(aux_cur[:, :H])
            ref = self.motion.split_rows(aux_cur[:, H - 1])

        with span("env.reward_done"):
            disc_obs = self._disc_obs_from_hist(state2)
            disc_obs_demo = obs_mod.compute_disc_obs(
                *win, enable_vel_obs=task.enable_vel_obs, global_obs=task.global_obs,
            )
            reward = self._reward(sim, ref)

            meta = self.motion.meta_all[ids]                   # [N, 7]
            done = self._done(time, sim, ref, body_contact, mt, meta)
            state2 = replace(state2, done=done)

        out = dict(
            reward=reward, done=done, disc_obs=disc_obs,
            disc_obs_demo=disc_obs_demo, motion_ids=ids, motion_times=mt,
            ep_time=time,
        )

        # --- reset-side gather: fresh window + fresh tar = fresh aux ---
        with span("env.reset"):
            reset = done != int(DoneFlags.NULL)
            ids3 = torch.where(reset, ids_f, ids)
            mt3 = torch.where(reset, times_f, mt)
            timesB = times_f[:, None] + self.window_offsets[None, :]
            idsB = ids_f[:, None].expand(timesB.shape)
            rowsB = self.motion.get_motion_rows(idsB, timesB)   # [N, H+K, R]
            fresh = self._fresh_state(ids_f, times_f, self.motion.split_rows(rowsB[:, :H]), dr)
            state3 = _where_env(reset, fresh, state2)
            aux3 = torch.where(reset[:, None, None], rowsB, aux_cur)

        # --- stacked obs pass [N, 2, ...]: next_obs (state2) + obs (state3)
        with span("env.obs"):
            stk = lambda a, b: torch.stack([a, b], dim=1)
            sim3 = state3.sim
            if task.enable_phase_obs:
                phase = self.motion.calc_motion_phase(stk(ids, ids3), stk(mt, mt3))
            else:
                phase = torch.zeros((N, 2), dtype=mt.dtype, device=mt.device)
            if K:
                D = self.model.nd
                tar_rp = stk(aux_cur[:, H:, 0:3], aux3[:, H:, 0:3])
                tar_rr = stk(aux_cur[:, H:, 3:7], aux3[:, H:, 3:7])
                tar_dp = stk(aux_cur[:, H:, 13:13 + D], aux3[:, H:, 13:13 + D])
            else:
                tar_rp = tar_rr = tar_dp = torch.zeros((N, 2, 0, 0), device=mt.device)
            obs2x = obs_mod.compute_add_obs(
                stk(sim.root_pos, sim3.root_pos),
                stk(sim.root_quat, sim3.root_quat),
                stk(sim.root_vel, sim3.root_vel),
                stk(sim.root_ang_vel, sim3.root_ang_vel),
                stk(sim.dof_pos, sim3.dof_pos),
                stk(sim.dof_vel, sim3.dof_vel),
                phase, tar_rp, tar_rr, tar_dp,
                enable_vel_obs=task.enable_vel_obs,
                global_obs=task.global_obs,
                root_height_obs=task.root_height_obs,
                enable_phase_obs=task.enable_phase_obs,
                num_phase_encoding=task.num_phase_encoding,
                enable_tar_obs=task.enable_tar_obs,
            )
            out["next_obs"] = obs2x[:, 0]
            return state3, obs2x[:, 1], aux3, out

    def _fresh_state(self, ids, times, hist, dr) -> EnvState:
        """Episode start at the reference pose of (ids, times); ``hist`` is
        the demo window (rp, rr, rv, rav, dp, dv), each [N, H, ...]."""
        N = ids.shape[0]
        dp = torch.minimum(torch.maximum(hist[4][:, -1], self.dof_lo), self.dof_hi)
        return EnvState(
            sim=SimState(
                root_pos=hist[0][:, -1],
                root_quat=hist[1][:, -1],
                root_vel=hist[2][:, -1],
                root_ang_vel=hist[3][:, -1],
                dof_pos=dp,
                dof_vel=hist[5][:, -1],
                pd_target=dp,
            ),
            time=torch.zeros(N, device=self.device),
            motion_ids=ids,
            motion_offsets=times,
            done=torch.zeros(N, dtype=torch.int32, device=self.device),
            hist_root_pos=hist[0],
            hist_root_rot=hist[1],
            hist_root_vel=hist[2],
            hist_root_ang_vel=hist[3],
            hist_dof_pos=hist[4],
            hist_dof_vel=hist[5],
            dr=dr,
        )

    def _push_history(self, state: EnvState) -> EnvState:
        sim = state.sim
        push = lambda buf, x: torch.cat([buf[:, 1:], x[:, None]], dim=1)
        return replace(
            state,
            hist_root_pos=push(state.hist_root_pos, sim.root_pos),
            hist_root_rot=push(state.hist_root_rot, sim.root_quat),
            hist_root_vel=push(state.hist_root_vel, sim.root_vel),
            hist_root_ang_vel=push(state.hist_root_ang_vel, sim.root_ang_vel),
            hist_dof_pos=push(state.hist_dof_pos, sim.dof_pos),
            hist_dof_vel=push(state.hist_dof_vel, sim.dof_vel),
        )

    # ------------------------------------------------------------------- obs

    def compute_obs(self, state: EnvState):
        """Actor/critic obs."""
        sim = state.sim
        mt = self.motion_times(state)
        t = self.task

        if t.enable_phase_obs:
            phase = self.motion.calc_motion_phase(state.motion_ids, mt)
        else:
            phase = torch.zeros_like(mt)

        N = mt.shape[0]
        if t.enable_tar_obs:
            K = len(self.tar_steps)
            steps = torch.as_tensor(self.tar_steps, dtype=mt.dtype, device=mt.device)
            times = mt[:, None] + self.ctrl_dt * steps[None, :]
            ids = state.motion_ids[:, None].expand(times.shape)
            trp, trr, _, _, tdp, _ = self.motion.get_motion_step(
                ids.reshape(-1), times.reshape(-1)
            )
            tar_root_pos = trp.reshape(N, K, 3)
            tar_root_rot = trr.reshape(N, K, 4)
            tar_dof_pos = tdp.reshape(N, K, self.model.nd)
        else:
            tar_root_pos = tar_root_rot = tar_dof_pos = torch.zeros((N, 0, 0), device=mt.device)

        return obs_mod.compute_add_obs(
            sim.root_pos, sim.root_quat, sim.root_vel, sim.root_ang_vel,
            sim.dof_pos, sim.dof_vel, phase,
            tar_root_pos, tar_root_rot, tar_dof_pos,
            enable_vel_obs=t.enable_vel_obs,
            global_obs=t.global_obs,
            root_height_obs=t.root_height_obs,
            enable_phase_obs=t.enable_phase_obs,
            num_phase_encoding=t.num_phase_encoding,
            enable_tar_obs=t.enable_tar_obs,
        )

    def _disc_obs_from_hist(self, state: EnvState):
        return obs_mod.compute_disc_obs(
            state.hist_root_pos, state.hist_root_rot, state.hist_root_vel,
            state.hist_root_ang_vel, state.hist_dof_pos, state.hist_dof_vel,
            enable_vel_obs=self.task.enable_vel_obs,
            global_obs=self.task.global_obs,
        )

    def _demo_window(self, motion_ids, motion_times0):
        """Demo states over the disc history window (oldest -> newest)."""
        H = self.task.num_disc_obs_steps
        offs = -self.ctrl_dt * torch.arange(
            H - 1, -1, -1, dtype=motion_times0.dtype, device=motion_times0.device)
        times = motion_times0[:, None] + offs[None, :]
        ids = motion_ids[:, None].expand(times.shape)
        out = self.motion.get_motion_step(ids.reshape(-1), times.reshape(-1))
        N = motion_times0.shape[0]
        return tuple(x.reshape((N, H) + x.shape[1:]) for x in out)

    def _disc_obs_demo(self, motion_ids, motion_times0):
        return obs_mod.compute_disc_obs(
            *self._demo_window(motion_ids, motion_times0),
            enable_vel_obs=self.task.enable_vel_obs,
            global_obs=self.task.global_obs,
        )

    def fetch_disc_obs_demo(self, n: int, sampler_state, generator=None, draws=None):
        """Disc obs [n, disc_obs_dim] of ``n`` fresh demo windows (the AMP
        agent's positives): motion ids, then start times from the sampler,
        then the window ending there.  ``draws = (ids, times)`` replaces the
        sampling (the parity tests inject the JAX package's draws)."""
        if draws is None:
            draws = self.sample_resets(n, sampler_state, generator)
        ids = to_device(draws[0], self.device, torch.int64)
        times = to_device(draws[1], self.device, torch.float32)
        return self._disc_obs_demo(ids, times)

    # ----------------------------------------------------------------- reset

    def _sample_times(self, motion_ids, sampler_state, generator=None):
        if not self.task.rand_reset:
            return torch.zeros(motion_ids.shape[0], device=self.device)
        return sampler_mod.sample_start_time(
            sampler_state, motion_ids, self.seg_sizes, self.ctrl_dt,
            self.min_start_time, self.task.sampler_temperature, generator=generator,
        )

    def sample_resets(self, n: int, sampler_state, generator=None):
        """Reset draws: motion ids [n] and start times [n]."""
        ids = self.motion.sample_motions(n, generator)
        return ids, self._sample_times(ids, sampler_state, generator)

    def sample_dr(self, n: int, generator=None):
        """Domain-randomization draws for ``n`` resets (identity when off)."""
        if not self.dr.enabled:
            return init_dr_state(n, self.device)
        return sample_dr(self.dr, n, generator, self.device)

    def reset_where(self, state: EnvState, mask, sampler_state, generator=None, draws=None):
        """Masked reset: fresh episodes where ``mask`` is True.

        Teleports to a sampled reference pose, prefills the disc history
        from the demo and draws the domain randomization anew.  ``draws =
        (ids, times)`` or ``(ids, times, dr)`` replaces the sampling (the
        parity tests inject the JAX package's draws); without ``dr`` it is
        drawn from ``generator``.
        """
        N = state.time.shape[0]
        if draws is None:
            draws = self.sample_resets(N, sampler_state, generator)
        ids, times = draws[:2]
        dr = draws[2] if len(draws) > 2 else self.sample_dr(N, generator)
        ids = to_device(ids, self.device, torch.int64)
        times = to_device(times, self.device, torch.float32)
        dr = {k: to_device(v, self.device, torch.float32) for k, v in dr.items()}
        fresh = self._fresh_state(ids, times, self._demo_window(ids, times), dr)
        return _where_env(mask, fresh, state)


# the paths of rollout_step_cached, counted as function attributes (as
# cuda_step.launches): graphs captured, steps replayed, steps run eagerly
_step_counts = ImitationEnv.rollout_step_cached
_step_counts.captures = 0
_step_counts.replays = 0
_step_counts.eager = 0


def _launch_counts() -> tuple:
    return (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.np_launches,
            cs.cuda_step.wide_launches, cs.sharded_cuda_step.launches)


def _set_launch_counts(c) -> None:
    (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.np_launches,
     cs.cuda_step.wide_launches, cs.sharded_cuda_step.launches) = c


def _leaves(x, like=None) -> list:
    """The tensors of a nest of tuples, dicts and states, in a fixed order:
    that of ``like`` where given (a nest of the same fields and keys)."""
    like = x if like is None else like
    if isinstance(like, torch.Tensor):
        return [x]
    if isinstance(like, (SimState, EnvState)):
        return [t for f in fields(like) for t in _leaves(getattr(x, f.name), getattr(like, f.name))]
    if isinstance(like, dict):
        return [t for k, v in like.items() for t in _leaves(x[k], v)]
    return [t for a, b in zip(x, like) for t in _leaves(a, b)]


def _builder(like):
    """A function, made once, that builds a nest shaped as ``like`` (a nest
    as :func:`_leaves` reads it) from an iterator over its tensors."""
    if isinstance(like, torch.Tensor):
        return next
    if isinstance(like, (SimState, EnvState)):
        cls, parts = type(like), [_builder(getattr(like, f.name)) for f in fields(like)]
        return lambda it: cls(*[part(it) for part in parts])
    if isinstance(like, dict):
        keys, parts = list(like), [_builder(v) for v in like.values()]
        return lambda it: dict(zip(keys, [part(it) for part in parts]))
    parts = [_builder(v) for v in like]
    return lambda it: tuple([part(it) for part in parts])


def _is_dense(t) -> bool:
    """Whether ``t`` fills one gap-free block of memory (dims in any order)."""
    expect = 1
    for stride, size in sorted((st, n) for n, st in zip(t.shape, t.stride()) if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _static_like(t):
    """An uninitialised tensor of ``t``'s shape, dtype and device, with its
    strides where ``t`` is dense."""
    if _is_dense(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _words(t):
    """``t`` as 32-bit words, for batched copies; None where its elements
    or layout have no such view."""
    if t.dtype == torch.int32:
        return t
    if t.element_size() == 4 or (t.element_size() == 8 and t.dim() and t.stride(-1) == 1):
        return t.view(torch.int32)
    return None


def _word_span(storage, lo: int, hi: int, device):
    """Bytes ``[lo, hi)`` of ``storage`` as a flat int32 tensor."""
    return torch.empty(0, dtype=torch.int32, device=device).set_(
        storage, lo // 4, ((hi - lo) // 4,), (1,))


def _copyable(x, s) -> bool:
    """Whether ``x`` goes into the static ``s`` as words of the same layout
    (given that ``s`` has a word view)."""
    return x.dtype == s.dtype and x.shape == s.shape and x.stride() == s.stride()


class _StepGraph:
    """:meth:`ImitationEnv.rollout_step_cached`'s body as one CUDA graph,
    for one scope of :meth:`ImitationEnv.graphed_steps` and one shape.

    Capture, on the env's capture stream (where the body has run at these
    shapes, :meth:`ImitationEnv._warm_step`): the inputs get static buffers
    of their shapes, dtypes and strides, loaded with the first step's
    inputs, and the body is captured on them,
    with Python's garbage collector paused, into the private memory pool of
    the env's last graph (a fresh pool at the first capture; a pool is kept
    alive by a graph that uses it).  Capture executes nothing, so the first
    call replays straight after it.

    A call copies its inputs into the static buffers in one batched copy of
    32-bit words, replays the graph, and copies the outputs into fresh
    memory in one more, with the eager step's shapes and strides (outputs
    that share a storage, as the two obs passes do, share a fresh one): no
    returned tensor is written by a later replay, and each pins what the
    eager step's would.  ``cuda_step``'s launch counters count what runs on
    the card: nothing at capture, and at each replay what the body launched
    at capture.
    """

    def __init__(self, env: ImitationEnv, args, key):
        self.device = args[1].device
        self.key = key
        it = iter([_static_like(t) for t in _leaves(args)])
        self.inputs = _builder(args)(it)
        self.static = _leaves(self.inputs)
        self.static_words = [_words(t) for t in self.static]
        self._load(args)             # the body is captured on real inputs

        with span("env.capture"):
            stream = env._graph_stream
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            counts = _launch_counts()
            with torch.cuda.stream(stream):
                self.graph = torch.cuda.CUDAGraph()
                keeper = env._graph_keeper
                # no garbage collection during the capture: a collected
                # object's CUDA calls (a dead env's graph being destroyed)
                # would invalidate it
                collecting = gc.isenabled()
                gc.disable()
                self.graph.capture_begin(pool=keeper.pool() if keeper is not None else None)
                try:
                    self.outs = env._rollout_step_body(*self.inputs)
                finally:
                    self.graph.capture_end()
                    if collecting:
                        gc.enable()
            current.wait_stream(stream)
            env._graph_keeper = self.graph
            self.launches = tuple(b - a for a, b in zip(counts, _launch_counts()))
            _set_launch_counts(counts)
            _step_counts.captures += 1
        self._plan_outputs()

    def _plan_outputs(self) -> None:
        """How the outputs are copied out.  An output alone in its storage
        and filling it (``whole``) is copied into a fresh tensor of its
        shape and strides; 4-byte outputs that share a storage (``spans``)
        into a fresh copy of the bytes they cover, and viewed there; any
        other is cloned."""
        outs = _leaves(self.outs)
        self.whole, self.spans, self.cloned, span_src = [], [], [], []
        by_storage = {}
        for i, t in enumerate(outs):
            if t.numel() == 0:
                self.cloned.append(i)
                continue
            isz = t.element_size()
            lo = t.storage_offset() * isz
            hi = lo + isz * (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride())))
            s = by_storage.setdefault(t.untyped_storage().data_ptr(),
                                      [lo, hi, t.untyped_storage(), []])
            s[0], s[1] = min(s[0], lo), max(s[1], hi)
            s[3].append(i)
        self.n_out = len(outs)
        for lo, hi, storage, members in by_storage.values():
            t = outs[members[0]]
            if (len(members) == 1 and _words(t) is not None and _is_dense(t)
                    and hi - lo == t.numel() * t.element_size()):
                self.whole.append((members[0], t.shape, t.stride(), t.dtype))
                continue
            if any(outs[i].element_size() != 4 for i in members):
                self.cloned += members
                continue
            views = []
            for i in members:
                u = outs[i]
                off = (u.storage_offset() * u.element_size() - lo) // u.element_size()
                views.append((i, u.dtype, u.shape, u.stride(), off))
            self.spans.append(((hi - lo) // 4, views))
            span_src.append(_word_span(storage, lo, hi, self.device))
        self.src = [_words(outs[i]) for i, _, _, _ in self.whole] + span_src
        self.out_leaves = outs if self.cloned else None
        self.build = _builder(self.outs)

    def _load(self, args) -> None:
        """The step's inputs into the static buffers."""
        dst, src = [], []
        for s, w, x in zip(self.static, self.static_words, _leaves(args, self.inputs)):
            if w is not None and _copyable(x, s):
                dst.append(w)
                src.append(_words(x))
            else:
                s.copy_(x)
        torch._foreach_copy_(dst, src)

    def __call__(self, args):
        with span("env.graph"):
            self._load(args)
            self.graph.replay()
            _set_launch_counts(tuple(a + b for a, b in zip(_launch_counts(), self.launches)))
            _step_counts.replays += 1

            dev, leaves = self.device, [None] * self.n_out
            dst = []
            for i, shape, stride, dtype in self.whole:
                leaves[i] = torch.empty_strided(shape, stride, dtype=dtype, device=dev)
                dst.append(_words(leaves[i]))
            for n, views in self.spans:
                words = torch.empty(n, dtype=torch.int32, device=dev)
                dst.append(words)
                for i, dtype, shape, stride, off in views:
                    leaves[i] = words.view(dtype).as_strided(shape, stride, off)
            torch._foreach_copy_(dst, self.src)
            for i in self.cloned:
                leaves[i] = self.out_leaves[i].clone()
            return self.build(iter(leaves))
