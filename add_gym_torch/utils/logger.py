"""Console, file and TensorBoard logging of training metrics.

Counterpart of ``add_gym_tpu/utils/logger.py``: a table on the console
with its columns fixed at the first row, ``log.txt`` and ``metrics.jsonl``
in the log directory, and TensorBoard scalars keyed by the sample count
where ``torch.utils.tensorboard`` imports (an optional sink).  Only the
main rank writes.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class TrainLogger:
    def __init__(self, log_dir: str | None = None, is_main: bool = True,
                 enable_tb: bool = True):
        self.is_main = is_main
        self._keys = None
        self._file = None
        self._jsonl = None
        self._tb = None
        if self.is_main and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "log.txt"), "a")
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if enable_tb:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None       # tensorboard is not installed
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def log(self, metrics: Dict, step: int):
        """Write one row of metrics (step = the sample count)."""
        if not self.is_main:
            return
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._keys is None:
            self._keys = list(metrics)
            header = " | ".join(f"{k:>18s}" for k in ["samples"] + self._keys)
            print(header)
            if self._file:
                self._file.write(header + "\n")
        row = " | ".join([f"{step:>18d}"]
                         + [f"{metrics.get(k, float('nan')):>18.5f}" for k in self._keys])
        print(row, flush=True)
        if self._file:
            self._file.write(row + "\n")
            self._file.flush()
        if self._jsonl:
            self._jsonl.write(json.dumps({"samples": step, **metrics}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def log_sampler_image(self, errors, step: int):
        """The adaptive sampler's error and probability tables as a
        TensorBoard image ([num_clips, num_segments] EMA errors)."""
        if not self.is_main or self._tb is None:
            return
        try:
            import matplotlib
        except ImportError:                    # the image is optional
            return

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        errors = np.asarray(errors)
        t = errors.max() + 1e-6
        e = np.exp(errors / t - (errors / t).max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        fig, axes = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
        for ax, table, title in ((axes[0], errors, "segment error (EMA)"),
                                 (axes[1], probs, "sampling probability")):
            im = ax.imshow(table, aspect="auto", cmap="viridis")
            ax.set_title(title)
            ax.set_ylabel("clip")
            fig.colorbar(im, ax=ax)
        axes[1].set_xlabel("segment")
        fig.tight_layout()
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        self._tb.add_image("sampler", img, step, dataformats="HWC")
        plt.close(fig)

    def close(self):
        for f in (self._file, self._jsonl, self._tb):
            if f:
                f.close()
