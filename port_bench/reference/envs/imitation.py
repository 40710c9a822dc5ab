"""Imitation environment on device tensors, stepped by the reference-layout
engine (``physics/engine.py``): one ``EnvState`` of ``[N, ...]`` tensors,
``reset_where``, ``compute_obs``, ``step`` (physics step with the per-env
parameters and the latency blend of domain randomization, reward and
done) and ``rollout_step_cached`` (the same step, masked reset and both
observation passes, with the incremental motion-row window).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Sequence

import numpy as np
import torch

from port_bench.reference.envs import obs as obs_mod
from port_bench.reference.envs.domain_rand import DRConfig
from port_bench.reference.envs.done import DoneFlags, compute_done
from port_bench.reference.envs.reward import compute_reward
from port_bench.reference.motion.motion_lib import MotionLib
from port_bench.reference.physics.engine import EngineParams, SimState
from port_bench.reference.physics.model import PhysicsModel
from port_bench.reference.utils.device import resolve_device


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

    It steps through the reference-layout engine (``physics/engine.py``),
    one rank holding every env; the reset and domain-randomization draws
    are always given (the program's, at the step the reference follows).
    """

    def __init__(
        self,
        model: PhysicsModel,
        motion: MotionLib,
        engine_params: EngineParams,
        task: TaskConfig = TaskConfig(),
        device="cuda",
        dr: DRConfig = DRConfig(),
        char=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.char = char  # the kinematic CharModel (video recording)
        self.motion = motion
        self.params = engine_params
        self.task = task
        self.dr = dr
        self.ctrl_dt = engine_params.ctrl_dt
        from port_bench.reference.physics.engine import step as engine_step
        self._step_fn = lambda p, s, t: engine_step(self.model, p, s, t)

        contact_set = set(task.contact_bodies)
        self.noncontact_mask = torch.as_tensor(
            [name not in contact_set for name in model.body_names], device=self.device
        )
        self.tar_steps = np.asarray(task.tar_obs_steps, np.int64)
        lim = torch.as_tensor(model.dof_limit, device=self.device)
        self.dof_lo, self.dof_hi = lim[:, 0], lim[:, 1]
        self._dof_err_w = torch.ones(model.nd, device=self.device)

        # action bounds = limits mid +- 1.4 x half-range
        lim = np.asarray(model.dof_limit)
        mid = 0.5 * (lim[:, 0] + lim[:, 1])
        scale = 1.4 * np.maximum(np.abs(lim[:, 1] - mid), np.abs(lim[:, 0] - mid))
        self.action_low = mid - scale
        self.action_high = mid + scale

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

    def _window_offsets(self, dtype=torch.float32):
        """Time offsets of the motion-row window relative to the current
        motion time: H history rows (oldest -> newest) then K target rows."""
        H = self.task.num_disc_obs_steps
        K = len(self.tar_steps) if self.task.enable_tar_obs else 0
        dt = self.ctrl_dt
        win = -dt * torch.arange(H - 1, -1, -1, dtype=dtype, device=self.device)
        if K:
            tar = dt * torch.as_tensor(self.tar_steps, dtype=dtype, device=self.device)
            return torch.cat([win, tar])
        return win

    @property
    def _aux_shiftable(self) -> bool:
        """The incremental row window needs tar_obs_steps = 1..K."""
        K = len(self.tar_steps) if self.task.enable_tar_obs else 0
        return not K or bool(np.array_equal(self.tar_steps, np.arange(1, K + 1)))

    def motion_aux(self, state: EnvState):
        """Motion-row cache [N, H+K, R] aligned to the current motion time."""
        mt = self.motion_times(state)
        times = mt[:, None] + self._window_offsets(mt.dtype)[None, :]
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
        """
        task = self.task
        N = state.time.shape[0]
        H = task.num_disc_obs_steps
        K = len(self.tar_steps) if task.enable_tar_obs else 0
        dt = self.ctrl_dt
        if not self._aux_shiftable:
            state2, next_obs, disc_obs, disc_obs_demo, reward, done = self.step(state, pd_target)
            out = dict(
                reward=reward, done=done, disc_obs=disc_obs,
                disc_obs_demo=disc_obs_demo, motion_ids=state.motion_ids,
                motion_times=self.motion_times(state2), ep_time=state2.time,
                next_obs=next_obs,
            )
            reset = done != int(DoneFlags.NULL)
            state3 = self.reset_where(state2, reset, (ids_f, times_f, dr))
            return state3, self.compute_obs(state3), None, out

        # --- physics --------------------------------------------------
        sim, body_contact = self._physics(state, pd_target)
        time = state.time + dt
        state2 = self._push_history(replace(state, sim=sim, time=time))
        mt = time + state.motion_offsets
        ids = state.motion_ids

        # --- advance the motion-row cache: shift + one fresh row -------
        new_t = mt + (K * dt if K else 0.0)
        new_row = self.motion.get_motion_rows(ids, new_t)      # [N, R]
        aux_cur = torch.cat([aux[:, 1:], new_row[:, None]], dim=1)
        win = self.motion.split_rows(aux_cur[:, :H])
        ref = self.motion.split_rows(aux_cur[:, H - 1])

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

        reset = done != int(DoneFlags.NULL)
        ids3 = torch.where(reset, ids_f, ids)
        mt3 = torch.where(reset, times_f, mt)

        # --- reset-side gather: fresh window + fresh tar = fresh aux ---
        timesB = times_f[:, None] + self._window_offsets(mt.dtype)[None, :]
        idsB = ids_f[:, None].expand(timesB.shape)
        rowsB = self.motion.get_motion_rows(idsB, timesB)   # [N, H+K, R]
        fresh = self._fresh_state(ids_f, times_f, self.motion.split_rows(rowsB[:, :H]), dr)
        state3 = _where_env(reset, fresh, state2)
        aux3 = torch.where(reset[:, None, None], rowsB, aux_cur)

        # --- stacked obs pass [N, 2, ...]: next_obs (state2) + obs (state3)
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

    # ----------------------------------------------------------------- reset

    def reset_where(self, state: EnvState, mask, draws):
        """Masked reset: fresh episodes where ``mask`` is True, from
        ``draws = (ids, times, dr)``: teleports to the reference pose there,
        prefills the disc history from the demo and takes the domain
        randomization of ``dr``.
        """
        ids, times, dr = draws
        ids = to_device(ids, self.device, torch.int64)
        times = to_device(times, self.device, torch.float32)
        dr = {k: to_device(v, self.device, torch.float32) for k, v in dr.items()}
        fresh = self._fresh_state(ids, times, self._demo_window(ids, times), dr)
        return _where_env(mask, fresh, state)
