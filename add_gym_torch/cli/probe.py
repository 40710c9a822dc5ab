"""Interactive probe: pose one mocap frame and inspect joint mappings.

Counterpart of ``add_gym_tpu/cli/probe.py``: loads the model and one motion
frame, runs FK, prints the DOF order / motion-column mapping and per-body
world positions, then drops into an interactive shell (IPython if it
imports, else ``code.interact``) with everything bound.  Runs on the card
unless ``device=cpu`` is given; without a CUDA device the default raises.

Usage:
    python -m add_gym_torch.cli.probe [task.motion_file=...] [frame_time=0.0] [device=cpu]
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides = [a for a in argv if "=" in a]

    import numpy as np
    import torch

    from add_gym_torch.builder import _resolve_motion_file
    from add_gym_torch.kinematics.char_model import load_char_model
    from add_gym_torch.motion.motion_lib import load_motion_lib
    from add_gym_torch.physics.model import build_physics_model
    from add_gym_torch.physics.testing import MOTION_JOINT_ORDER
    from add_gym_torch.utils.assets import asset_path
    from add_gym_torch.utils.config import load_config
    from add_gym_torch.utils.device import resolve_device

    cfg = load_config("train", overrides)
    device = resolve_device(cfg.get("device", "cuda"))
    t = float(cfg.get("frame_time", 0.0))

    mjcf = asset_path(cfg.get("robot", {}).get("asset_path", "g1_description/g1_29.xml"))
    char = load_char_model(mjcf)
    model = build_physics_model(mjcf, char)
    order = cfg["task"].get("motion_joint_order", MOTION_JOINT_ORDER)
    motion = load_motion_lib(
        _resolve_motion_file(cfg["task"].get("motion_file", "motions/dance1_subject3.motion")),
        order, char, dt=0.01, device=device,
    )

    print(f"bodies: {model.nb}  dofs: {model.nd}  contact points: {model.ncp}")
    print("\nDOF order (BFS client order) vs motion-file column:")
    kin_order = char.get_joint_order()[1:]
    for i, name in enumerate(kin_order):
        col = list(order).index(name)
        lim = model.dof_limit[i]
        print(f"  dof {i:2d}  <- motion col {col:2d}  {name:34s} "
              f"range [{lim[0]:+.2f}, {lim[1]:+.2f}]")

    ids = torch.zeros(1, dtype=torch.int64, device=device)
    rp, rr, rv, rav, dp, dv = motion.get_motion_step(ids, torch.tensor([t], device=device))
    joint_rot = char.dof_to_rot(dp)
    body_pos, body_rot = char.forward_kinematics(rp, rr, joint_rot)

    print(f"\nframe at t={t:.2f}s on {device}: root_pos={rp[0].cpu().numpy().round(3)}")
    pos = body_pos[0].cpu().numpy()
    for b, name in enumerate(model.body_names):
        print(f"  {name:32s} {pos[b].round(3)}")

    ns = dict(
        char=char, model=model, motion=motion, cfg=cfg,
        rp=rp, rr=rr, dp=dp, dv=dv,
        joint_rot=joint_rot, body_pos=body_pos, body_rot=body_rot,
        torch=torch, np=np,
    )
    try:
        import IPython

        IPython.start_ipython(argv=[], user_ns=ns)
    except ImportError:
        import code

        code.interact(local=ns)


if __name__ == "__main__":
    main()
