"""Carry a JAX package train state across into the port.

The JAX package stores its networks as flax parameter trees
(``params["params"][<module>]["Dense_<i>"]`` with ``kernel [in, out]`` and
``bias [out]``) and its normalizers and sampler as small dataclasses.  This
module reads them as numpy arrays (``np.asarray`` on each leaf), so it needs
neither JAX nor the JAX package: a flax ``Dense`` kernel becomes an
``nn.Linear`` weight ``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch

from add_gym_torch.learning.add_agent import ADDAgent, TrainState
from add_gym_torch.learning.networks import ADDNet
from add_gym_torch.learning.normalizer import DiffNormState, NormState
from add_gym_torch.learning.sampler import SamplerState


def _copy_dense(lin: torch.nn.Linear, leaf) -> None:
    kernel = np.array(leaf["kernel"], np.float32)
    bias = np.array(leaf["bias"], np.float32)
    if kernel.shape != (lin.in_features, lin.out_features):
        raise ValueError(f"kernel {kernel.shape} does not fit Linear({lin.in_features}, {lin.out_features})")
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(kernel.T))
        lin.bias.copy_(torch.as_tensor(bias))


def load_flax_params(net: ADDNet, flax_params) -> None:
    """Copy a flax ``ADDNet`` parameter tree into ``net`` in place."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    heads = {"actor": "actor_mean", "critic": "critic_out", "disc": "disc_logit"}
    for name, head in heads.items():
        if name == "disc" and not net.enable_disc:
            continue
        tree = p[f"{name}_trunk"]
        layers = getattr(net, f"{name}_trunk").layers
        if len(tree) != len(layers):
            raise ValueError(f"{name}_trunk: {len(tree)} flax layers, {len(layers)} torch layers")
        for i, lin in enumerate(layers):
            _copy_dense(lin, tree[f"Dense_{i}"])
        _copy_dense(getattr(net, head), p[head])


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def from_jax(agent: ADDAgent, jax_ts) -> TrainState:
    """A port ``TrainState`` holding the JAX train state's networks, obs
    normalizer, disc diff normalizer, sampler errors and sample count."""
    dev = agent.device
    ts = agent.init_train_state()
    load_flax_params(ts.params, jax_ts.params)
    on, dn = jax_ts.obs_norm, jax_ts.disc_norm
    return TrainState(
        params=ts.params,
        obs_norm=NormState(
            count=_tensor(on.count, dev), mean=_tensor(on.mean, dev),
            mean_sq=_tensor(on.mean_sq, dev), min_std=float(on.min_std), clip=float(on.clip),
        ),
        disc_norm=DiffNormState(
            count=_tensor(dn.count, dev), mean_abs=_tensor(dn.mean_abs, dev),
            min_diff=float(dn.min_diff), clip=float(dn.clip),
        ),
        sampler=SamplerState(errors=_tensor(jax_ts.sampler.errors, dev)),
        sample_count=_tensor(jax_ts.sample_count, dev, torch.int64),
    )
