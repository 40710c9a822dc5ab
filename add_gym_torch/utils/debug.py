"""Debug utilities.

Counterpart of ``add_gym_tpu/utils/debug.py``: :func:`parity_check` is the
cross-backend sanity mode, a short rollout of the env's selected physics
backend (the CUDA kernel or the plain env-minor step) beside the
reference-layout engine.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from add_gym_torch.physics import engine as eng


def parity_check(env, n: int = 4, atol: float = 5e-4, steps: int = 3, seed: int = 0):
    """Step the env's selected physics backend and the reference-layout
    engine from the same random state (root 1 m up, joint velocities
    ~N(0, 0.1)) with the same random targets, and compare.

    Returns the largest absolute difference per compared field; raises
    ``AssertionError`` naming the field when one exceeds ``atol``.  An env
    that already runs the reference-layout engine is not checked (returns
    None).  The inputs come from a numpy seed, so every device gets the
    same ones.
    """
    if not (env.fused or env.kernel):
        print("parity_check: env already uses the reference-layout engine")
        return None

    model, params, dev = env.model, env.params, env.device
    rng = np.random.default_rng(seed)
    s = eng.default_state(model, n, device=dev)
    root_pos = s.root_pos.clone()
    root_pos[:, 2] = 1.0
    s_sel = replace(s, root_pos=root_pos, dof_vel=torch.as_tensor(
        rng.normal(0.0, 0.1, (n, model.nd)), dtype=torch.float32, device=dev))
    s_ref = s_sel
    for _ in range(steps):
        tgt = torch.as_tensor(rng.normal(0.0, 0.05, (n, model.nd)), dtype=torch.float32,
                              device=dev)
        s_sel, _ = env._step_fn(params, s_sel, tgt)
        s_ref, _ = eng.step(model, params, s_ref, tgt)
    errs = {}
    for name in ("root_pos", "root_quat", "dof_pos", "dof_vel"):
        errs[name] = (getattr(s_sel, name) - getattr(s_ref, name)).abs().max().item()
        if not errs[name] < atol:
            raise AssertionError(
                f"physics parity check FAILED: {name} diverges by {errs[name]:.2e} "
                f"between the selected backend and the reference-layout engine")
    print(f"parity_check: selected backend matches reference engine "
          f"({steps} steps, {n} envs, atol {atol})")
    return errs
