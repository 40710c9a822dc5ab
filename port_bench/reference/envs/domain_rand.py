"""Domain randomization: per-env physics perturbations, drawn at reset.

Counterpart of ``add_gym_tpu/envs/domain_rand.py``.  PD gains, ground
friction and the mass scale become per-env data (``EngineParams`` leaves,
see ``ImitationEnv._effective_params``), drawn again for every env that
resets:

- ``kp_scale`` / ``kv_scale``: PD gain multipliers, log-uniform;
- ``friction_mu``: ground Coulomb friction coefficient, log-uniform;
- ``latency``: first-order actuation delay, the applied PD target is
  ``(1 - a) * cmd + a * prev`` with ``a`` uniform in range (0 = no delay);
- ``mass_scale``: whole-body mass/inertia multiplier, log-uniform; it
  scales spatial inertias, bias forces and contact forces in the control
  step (``fused_step._substep_core``'s ``ms``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

DR_KEYS = ("kp_scale", "kv_scale", "friction_mu", "latency", "mass_scale")


@dataclass(frozen=True)
class DRConfig:
    enabled: bool = False
    kp_scale_range: tuple = (0.8, 1.2)
    kv_scale_range: tuple = (0.8, 1.2)
    friction_range: tuple = (0.6, 1.4)
    action_latency_range: tuple = (0.0, 0.0)
    mass_range: tuple = (1.0, 1.0)

    @property
    def mass_enabled(self) -> bool:
        return tuple(self.mass_range) != (1.0, 1.0)


def sample_dr(cfg: DRConfig, num_envs: int, generator: torch.Generator | None = None,
              device="cpu"):
    """Fresh per-env perturbations within the config ranges, from one
    [5, num_envs] draw of uniforms (a row per quantity, in ``DR_KEYS``
    order)."""
    u = torch.rand((len(DR_KEYS), num_envs), generator=generator, device=device)

    def uniform(row, lo, hi):
        return u[row] * (hi - lo) + lo

    def log_uniform(row, lo, hi):
        return torch.exp(uniform(row, math.log(lo), math.log(hi)))

    return dict(
        kp_scale=log_uniform(0, *cfg.kp_scale_range),
        kv_scale=log_uniform(1, *cfg.kv_scale_range),
        friction_mu=log_uniform(2, *cfg.friction_range),
        latency=uniform(3, *cfg.action_latency_range),
        mass_scale=log_uniform(4, *cfg.mass_range),
    )
