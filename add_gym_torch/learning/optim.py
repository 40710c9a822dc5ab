"""Global-norm gradient clip + Adam, or + SGD with momentum, over a
parameter list.

Counterpart of ``add_gym_tpu/learning/optim.py::fused_clip_adam``
(``optimizer: fused_adam``) and of the ``optax.chain(clip_by_global_norm(c),
adamw(lr, weight_decay=0))`` that the JAX agent builds for ``optimizer:
adam``.  Both compute the same step with the same moments
(:class:`AdamState`: count, mu, nu): the clip ``g * (clip / max(|g|,
clip))``, bias correction ``1 - b^t`` and the update ``(-lr * m_hat) /
(sqrt(v_hat) + eps)``.  The optax chain rounds the clip and the update at
other places, within one f32 ulp of this one, so one body serves both
names.  (``torch.nn.utils.clip_grad_norm_`` is not the same clip: it
divides by ``|g| + 1e-6``.)  Parameters are updated in place; the moments
are new tensors.  The arithmetic runs as ``torch._foreach_*`` list ops, one
launch per op for the whole parameter list on a GPU.

``optimizer: sgd`` is the JAX agent's ``optax.chain(clip_by_global_norm(c),
sgd(lr, momentum))``: the same clip, then optax's ``trace`` (``t <- g + m
t``, :class:`SGDState`) and the update ``-lr t`` (:func:`clip_sgd_step`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class AdamState:
    count: torch.Tensor  # [] int32: steps taken
    mu: list             # first moments, one per parameter
    nu: list             # second moments


def init_adam(params) -> AdamState:
    params = list(params)
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


@dataclass
class SGDState:
    trace: list          # momentum traces, one per parameter


def init_sgd(params) -> SGDState:
    return SGDState(trace=[torch.zeros_like(p) for p in params])


def global_norm(grads):
    return torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())


def _clip(grads, clip: float):
    return torch._foreach_mul(grads, clip / torch.clamp_min(global_norm(grads), clip))


@torch.no_grad()
def clip_adam_step(params, grads, state: AdamState, learning_rate: float, clip: float,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamState:
    """One clipped Adam step: updates ``params`` in place and returns the
    new moments."""
    params, grads = list(params), list(grads)
    grads = _clip(grads, clip)
    count = state.count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    mu = torch._foreach_mul(state.mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    nu = torch._foreach_mul(state.nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))

    m_hat = torch._foreach_div(mu, bc1)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, eps)
    torch._foreach_add_(params, torch._foreach_div(torch._foreach_mul(m_hat, -learning_rate),
                                                   denom))
    return AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def clip_sgd_step(params, grads, state: SGDState, learning_rate: float, clip: float,
                  momentum: float = 0.9) -> SGDState:
    """One clipped SGD-with-momentum step: updates ``params`` in place and
    returns the new traces."""
    params, grads = list(params), list(grads)
    trace = torch._foreach_mul(state.trace, momentum)
    torch._foreach_add_(trace, _clip(grads, clip))
    torch._foreach_add_(params, torch._foreach_mul(trace, -learning_rate))
    return SGDState(trace=trace)
