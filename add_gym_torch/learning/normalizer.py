"""Running input normalizers as plain state.

Counterpart of ``add_gym_tpu/learning/normalizer.py`` as far as the
rollout needs it: the running mean/std normalizer (``NormState``) and the
mean-absolute-value normalizer for ADD observation differences
(``DiffNormState``), their init functions and the forward maps.  The
update functions come with the model update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
