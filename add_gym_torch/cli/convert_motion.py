"""Convert ``.motion`` CSV clips to the pickle format (and back).

Counterpart of ``add_gym_tpu/cli/convert_motion.py``: reads the
36-float-per-frame CSV text format (or a pickle clip) and writes
``{loop_mode, fps, frames}`` pickles, which both packages read.  The
output path is explicit (the asset tree may be read-only), and a whole
directory of ``.motion`` files converts in one call.

Usage:
    python -m add_gym_torch.cli.convert_motion in.motion out.pkl [--fps 30] [--loop wrap]
    python -m add_gym_torch.cli.convert_motion motions_dir/ out_dir/
"""

from __future__ import annotations

import argparse
import os

from add_gym_torch.motion.motion_file import LoopMode, MotionClip, load_motion


def convert(src: str, dst: str, fps: float | None, loop: str | None) -> None:
    clip = load_motion(src)
    if fps is not None:
        clip = MotionClip(loop_mode=clip.loop_mode, fps=fps, frames=clip.frames)
    if loop is not None:
        clip = MotionClip(loop_mode=LoopMode[loop.upper()], fps=clip.fps, frames=clip.frames)
    clip.save(dst)
    print(f"{src} -> {dst}  [{clip.frames.shape[0]} frames @ {clip.fps} fps, "
          f"{clip.loop_mode.name}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help=".motion/.pkl file or directory of .motion files")
    ap.add_argument("dst", help="output .pkl file or directory")
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--loop", choices=["clamp", "wrap"], default=None)
    args = ap.parse_args(argv)

    if os.path.isdir(args.src):
        os.makedirs(args.dst, exist_ok=True)
        for name in sorted(os.listdir(args.src)):
            if not name.endswith(".motion"):
                continue
            convert(
                os.path.join(args.src, name),
                os.path.join(args.dst, name.replace(".motion", ".pkl")),
                args.fps, args.loop,
            )
    else:
        convert(args.src, args.dst, args.fps, args.loop)


if __name__ == "__main__":
    main()
