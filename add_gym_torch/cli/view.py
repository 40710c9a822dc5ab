"""Kinematic motion viewer: play a clip through the skeleton and render it.

Counterpart of ``add_gym_tpu/cli/view.py``.  Plays a motion clip
kinematically on the character model: (a) dumps the body-pose trajectory
to ``.npz`` (the JAX package's keys: ``times``, ``body_pos``,
``body_rot``, ``body_names``, ``parents``) and (b) with ``video=...``
renders it, with the meshes of the robot's MJCF (``render/mesh.py``) or,
where that fails, a matplotlib stick figure.  The clip lookup and the
forward kinematics run on the card unless ``device=cpu`` is given; without
a CUDA device the default raises, like the port's other entry points.

Usage:
    python -m add_gym_torch.cli.view task.motion_file=motions/walk1_subject1.motion \
        out=walk.npz video=walk.gif fps=30 [device=cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def playback_poses(char, motion, fps: float = 30.0, max_seconds: float | None = None):
    """Sample clip 0 of ``motion`` at ``fps`` and FK every frame on the
    motion library's device.

    Returns numpy (times [T], body_pos [T, nb, 3], body_rot [T, nb, 4 wxyz]).
    """
    length = float(motion.lengths[0])
    if max_seconds is not None:
        length = min(length, max_seconds)
    times = np.arange(0.0, length, 1.0 / fps, dtype=np.float32)
    dev = motion.lengths.device
    ids = torch.zeros(times.shape[0], dtype=torch.int64, device=dev)
    rp, rr, _, _, dp, _ = motion.get_motion_step(ids, torch.as_tensor(times, device=dev))
    body_pos, body_rot = char.forward_kinematics(rp, rr, char.dof_to_rot(dp))
    return times, body_pos.cpu().numpy(), body_rot.cpu().numpy()


def render_video(char, body_pos: np.ndarray, out_file: str, fps: float = 30.0):
    """Stick-figure MP4/GIF of the body-position trajectory (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    parents = char.parent_indices
    T = body_pos.shape[0]

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")

    center = body_pos[..., :2].reshape(-1, 2).mean(axis=0)
    span = 1.2

    lines = []
    for j in range(1, char.num_bodies):
        (ln,) = ax.plot([], [], [], "o-", lw=2, ms=2, color="tab:blue")
        lines.append(ln)

    def init():
        ax.set_xlim(center[0] - span, center[0] + span)
        ax.set_ylim(center[1] - span, center[1] + span)
        ax.set_zlim(0, 2 * span)
        ax.set_box_aspect((1, 1, 1))
        return lines

    def update(t):
        for j in range(1, char.num_bodies):
            p = int(parents[j])
            seg = body_pos[t, [p, j]]
            lines[j - 1].set_data(seg[:, 0], seg[:, 1])
            lines[j - 1].set_3d_properties(seg[:, 2])
        ax.set_title(f"t = {t / fps:.2f}s")
        return lines

    anim = animation.FuncAnimation(fig, update, frames=T, init_func=init, blit=False)
    if out_file.endswith(".gif"):
        anim.save(out_file, writer="pillow", fps=int(fps))
    else:
        anim.save(out_file, writer=animation.FFMpegWriter(fps=int(fps)))
    plt.close(fig)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides = [a for a in argv if "=" in a]

    from add_gym_torch.builder import _resolve_motion_file
    from add_gym_torch.kinematics.char_model import load_char_model
    from add_gym_torch.motion.motion_lib import load_motion_lib
    from add_gym_torch.physics.testing import MOTION_JOINT_ORDER
    from add_gym_torch.utils.assets import asset_path
    from add_gym_torch.utils.config import load_config
    from add_gym_torch.utils.device import resolve_device

    cfg = load_config("view", overrides)
    device = resolve_device(cfg.get("device", "cuda"))
    fps = float(cfg.get("fps", 30.0))

    mjcf = asset_path(cfg.get("robot", {}).get("asset_path", "g1_description/g1_29.xml"))
    char = load_char_model(mjcf)
    motion = load_motion_lib(
        _resolve_motion_file(cfg["task"].get("motion_file", "motions/dance1_subject3.motion")),
        cfg["task"].get("motion_joint_order", MOTION_JOINT_ORDER),
        char,
        dt=1.0 / fps,
        device=device,
    )

    times, body_pos, body_rot = playback_poses(
        char, motion, fps=fps,
        max_seconds=float(cfg["max_seconds"]) if "max_seconds" in cfg else None,
    )
    print(f"played {times.shape[0]} frames ({times[-1]:.2f}s) "
          f"of {cfg['task'].get('motion_file')} on {device}")

    out = cfg.get("out", "motion_playback.npz")
    np.savez_compressed(
        out, times=times, body_pos=body_pos, body_rot=body_rot,
        body_names=np.asarray(char.body_names),
        parents=char.parent_indices,
    )
    print(f"wrote {out}")

    video = cfg.get("video")
    if video:
        if bool(cfg.get("mesh", True)):
            # mesh render (render/mesh.py); stick figure on failure
            try:
                from add_gym_torch.render.mesh import RobotMeshModel, render_frames, save_video

                mm = RobotMeshModel(mjcf, list(char.body_names))
                save_video(render_frames(mm, body_pos, body_rot), video, fps=fps)
                print(f"wrote {video} (mesh render)")
                return
            except Exception as e:
                print(f"mesh render failed ({e!r}); stick-figure fallback")
        render_video(char, body_pos, video, fps=fps)
        print(f"wrote {video}")


if __name__ == "__main__":
    main()
