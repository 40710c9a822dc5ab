"""Action distributions (pure functions).

Counterpart of ``add_gym_tpu/learning/distributions.py``: the diagonal
Gaussian head (its ``logstd`` fixed by the agent, a learned parameter or a
network output) and the categorical head for discrete action spaces
(``categorical_*``; unused by the G1 task, part of the model factory).
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


# ------------------------------------------------------- categorical head


def categorical_sample(logits, generator: torch.Generator | None = None):
    """Class indices [...] drawn from softmax(``logits``) along the last axis."""
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(logits.shape[:-1])


def categorical_mode(logits):
    return torch.argmax(logits, dim=-1)


def categorical_log_prob(logits, x):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, x.long()[..., None])[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_param_reg(logits):
    return torch.sum(logits * logits, dim=-1)
