"""Simulation state, engine parameters and the PD target rule.

Counterpart of the state half of ``add_gym_tpu/physics/engine.py``: the
``SimState`` layout (every tensor leads with the env axis N), the
``EngineParams`` knobs, ``default_state`` and ``apply_pd_target``.  The
reference-layout step, ``aba.py`` and ``spatial.py`` of the JAX package are
not ported: the control step runs in ``fused_step`` (plain torch) and
``cuda_step`` (the CUDA kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from add_gym_torch.physics.model import PhysicsModel


@dataclass(frozen=True)
class SimState:
    """Batched simulation state.  All tensors lead with the env axis N.

    Root velocities are world-frame (linear velocity of the root origin and
    angular velocity).
    """

    root_pos: torch.Tensor      # [N, 3]
    root_quat: torch.Tensor     # [N, 4] wxyz
    root_vel: torch.Tensor      # [N, 3]
    root_ang_vel: torch.Tensor  # [N, 3]
    dof_pos: torch.Tensor       # [N, nd]
    dof_vel: torch.Tensor       # [N, nd]
    pd_target: torch.Tensor     # [N, nd] previous PD target (slew limiting)

    @property
    def num_envs(self):
        return self.root_pos.shape[0]


@dataclass(frozen=True)
class EngineParams:
    """Control/contact parameters.

    ``kp``/``kv`` are shared ``[nd]`` gains or per-env ``[N, nd]`` ones;
    ``friction_mu`` is a float or a per-env ``[N]`` tensor; ``mass_scale``
    (whole-body mass/inertia multiplier: spatial inertias, bias forces and
    contact forces scale with it, gravity and the actuators do not) is the
    float 1.0 or a per-env ``[N]`` tensor.  Per-env values come from
    domain randomization (``ImitationEnv._effective_params``).
    """

    kp: torch.Tensor                # [nd] or [N, nd]
    kv: torch.Tensor                # [nd] or [N, nd]
    ctrl_dt: float = 0.01
    substeps: int = 4
    max_torque: float = 200.0
    max_target_delta: float = 0.5
    position_limit_margin: float = 1e-4
    contact_timeconst: float = 0.02
    contact_dampratio: float = 1.0
    friction_mu: float | torch.Tensor = 1.0
    mass_scale: float | torch.Tensor = 1.0
    gravity: float = 9.81
    self_collision: bool = True


def mass_scale_or_none(params: EngineParams):
    """The mass scale as a float32 ``[N]`` or ``[1]`` tensor, or None for the
    float 1.0 (no scaling)."""
    ms = params.mass_scale
    if not isinstance(ms, torch.Tensor):
        if float(ms) == 1.0:
            return None
        ms = torch.tensor(float(ms))
    ms = ms.to(torch.float32)
    return ms[None] if ms.ndim == 0 else ms


def is_per_env(params: EngineParams) -> bool:
    """Whether ``params`` carry per-env leaves (domain randomization): the
    control step kernel's per-env variant takes them."""
    return (
        torch.as_tensor(params.kp).ndim == 2
        or torch.as_tensor(params.kv).ndim == 2
        or isinstance(params.friction_mu, torch.Tensor)
        or mass_scale_or_none(params) is not None
    )


def default_state(model: PhysicsModel, num_envs: int, device="cpu",
                  dtype=torch.float32) -> SimState:
    zeros = lambda *s: torch.zeros((num_envs,) + s, dtype=dtype, device=device)
    quat = zeros(4)
    quat[:, 0] = 1.0
    return SimState(
        root_pos=zeros(3),
        root_quat=quat,
        root_vel=zeros(3),
        root_ang_vel=zeros(3),
        dof_pos=zeros(model.nd),
        dof_vel=zeros(model.nd),
        pd_target=zeros(model.nd),
    )


def apply_pd_target(model: PhysicsModel, params: EngineParams, state: SimState, target):
    """Clamp targets to joint limits (with margin) and slew-limit the change."""
    lim = torch.as_tensor(model.dof_limit, dtype=target.dtype, device=target.device)
    lo = lim[:, 0] + params.position_limit_margin
    hi = lim[:, 1] - params.position_limit_margin
    tgt = torch.minimum(torch.maximum(target, lo), hi)
    delta = torch.clamp(
        tgt - state.pd_target, -params.max_target_delta, params.max_target_delta
    )
    return state.pd_target + delta
