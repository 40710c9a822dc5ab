"""Diagonal Gaussian action distribution (pure functions).

Counterpart of ``add_gym_tpu/learning/distributions.py`` for the fixed-std
Gaussian head the G1 task uses; the categorical head is not ported yet.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def sample(mean, logstd, generator: torch.Generator | None = None):
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + torch.exp(logstd) * noise


def log_prob(mean, logstd, x):
    diff = (x - mean) * torch.exp(-logstd)
    logp = -0.5 * torch.sum(diff * diff, dim=-1)
    logp = logp + (-0.5 * mean.shape[-1] * _LOG_2PI
                   - torch.sum(logstd.expand(mean.shape), dim=-1))
    return logp


def entropy(mean, logstd):
    dim = mean.shape[-1]
    return torch.sum(logstd.expand(mean.shape), dim=-1) + 0.5 * dim * (_LOG_2PI + 1.0)


def param_reg(mean):
    return torch.sum(mean * mean, dim=-1)
