"""Domain-randomization state of an env that runs without randomization.

Counterpart of ``add_gym_tpu/envs/domain_rand.py::init_dr_state``: the
identity perturbations that ``EnvState.dr`` carries.  Domain randomization
is off by default; sampling per-env perturbations is not ported yet, so
``build_env`` refuses ``engine.domain_rand.enabled: true``.
"""

from __future__ import annotations

import torch


def init_dr_state(num_envs: int, device="cpu"):
    """Identity perturbations."""
    ones = torch.ones(num_envs, device=device)
    return dict(
        kp_scale=ones, kv_scale=ones, friction_mu=ones,
        latency=torch.zeros(num_envs, device=device), mass_scale=ones,
    )
