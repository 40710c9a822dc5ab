"""Running input normalizers as plain state.

Counterpart of ``add_gym_tpu/learning/normalizer.py``: the running
mean/std normalizer (``NormState``) and the mean-absolute-value normalizer
for ADD observation differences (``DiffNormState``), their init functions,
the forward maps and the merges of a new batch (``update_normalizer``,
``update_normalizer_from_stats``, ``update_diff_normalizer`` and
``update_diff_normalizer_from_stats``), which return new states.  The
from-stats forms take what data parallelism reduces over the ranks before
the merge: a count with sums, or a count with the mean of |x|.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class NormState:
    count: torch.Tensor    # [] float
    mean: torch.Tensor     # [shape]
    mean_sq: torch.Tensor  # [shape]
    min_std: float = 1e-4
    clip: float = math.inf

    @property
    def std(self):
        var = torch.clamp_min(self.mean_sq - self.mean * self.mean, self.min_std ** 2)
        return torch.sqrt(var)


def init_normalizer(shape, init_mean=None, init_std=None, min_std=1e-4,
                    clip=math.inf, device="cpu"):
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    mean = torch.zeros(shape, device=device) if init_mean is None else f(init_mean)
    std = torch.ones(shape, device=device) if init_std is None else f(init_std)
    return NormState(
        count=torch.zeros((), device=device), mean=mean, mean_sq=std * std + mean * mean,
        min_std=min_std, clip=clip,
    )


def normalize(state: NormState, x):
    y = (x - state.mean) / state.std
    return torch.clamp(y, -state.clip, state.clip)


def unnormalize(state: NormState, y):
    return y * state.std + state.mean


def update_normalizer(state: NormState, batch) -> NormState:
    """Merge a batch ``[..., shape]`` of samples (weighted average of the
    old and the batch mean and mean square)."""
    flat = batch.reshape((-1,) + tuple(state.mean.shape)).float()
    n_new = torch.tensor(float(flat.shape[0]), device=state.count.device)
    total = state.count + n_new
    w_old = state.count / total
    w_new = n_new / total
    return replace(
        state,
        count=total,
        mean=w_old * state.mean + w_new * flat.mean(0),
        mean_sq=w_old * state.mean_sq + w_new * (flat * flat).mean(0),
    )


def update_normalizer_from_stats(state: NormState, n_new, s, s_sq) -> NormState:
    """Merge pre-accumulated statistics (count, sum, sum of squares): the
    same merge as :func:`update_normalizer` for the lean rollout, which
    sums the acting obs as it goes."""
    n_new = torch.as_tensor(n_new, dtype=torch.float32, device=state.count.device)
    total = state.count + n_new
    w_old = state.count / total
    return replace(
        state,
        count=total,
        mean=w_old * state.mean + s / total,
        mean_sq=w_old * state.mean_sq + s_sq / total,
    )


@dataclass(frozen=True)
class DiffNormState:
    count: torch.Tensor     # []
    mean_abs: torch.Tensor  # [shape]
    min_diff: float = 1e-4
    clip: float = math.inf


def init_diff_normalizer(shape, min_diff=1e-4, clip=math.inf, device="cpu"):
    return DiffNormState(
        count=torch.zeros((), device=device), mean_abs=torch.ones(shape, device=device),
        min_diff=min_diff, clip=clip,
    )


def diff_normalize(state: DiffNormState, x):
    d = torch.clamp_min(state.mean_abs, state.min_diff)
    return torch.clamp(x / d, -state.clip, state.clip)


def update_diff_normalizer_from_stats(state: DiffNormState, n_new, mean_abs) -> DiffNormState:
    """Merge a batch given by its sample count and its mean of |x| (under
    data parallelism, the count and the mean over all ranks)."""
    n_new = torch.as_tensor(n_new, dtype=torch.float32, device=state.count.device)
    total = state.count + n_new
    return replace(
        state,
        count=total,
        mean_abs=(state.count / total) * state.mean_abs + (n_new / total) * mean_abs,
    )


def update_diff_normalizer(state: DiffNormState, batch) -> DiffNormState:
    """Merge a batch ``[..., shape]`` of differences (mean of |x|)."""
    flat = batch.reshape((-1,) + tuple(state.mean_abs.shape)).float()
    return update_diff_normalizer_from_stats(state, float(flat.shape[0]), flat.abs().mean(0))
