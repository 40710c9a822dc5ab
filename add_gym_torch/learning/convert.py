"""Carry a JAX package train state across into the port.

The JAX package stores its networks as flax parameter trees
(``params["params"][<module>]["Dense_<i>"]`` with ``kernel [in, out]`` and
``bias [out]``), its Adam moments as trees of the same shape (in a
``FusedAdamState`` or inside an optax chain's state tuple), and its
normalizers and sampler as small dataclasses.  This module reads them as
numpy arrays (``np.asarray`` on each leaf), so it needs neither JAX nor the
JAX package: a flax ``Dense`` kernel becomes an ``nn.Linear`` weight
``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch

from add_gym_torch.learning.add_agent import ADDAgent, TrainState
from add_gym_torch.learning.networks import ADDNet
from add_gym_torch.learning.normalizer import DiffNormState, NormState
from add_gym_torch.learning.optim import AdamState
from add_gym_torch.learning.sampler import SamplerState


def _dense_pairs(net: ADDNet, flax_tree):
    """(nn.Linear, flax Dense leaf) for every layer of ``net``."""
    p = flax_tree["params"] if "params" in flax_tree else flax_tree
    heads = {"actor": "actor_mean", "critic": "critic_out", "disc": "disc_logit"}
    for name, head in heads.items():
        if name == "disc" and not net.enable_disc:
            continue
        tree = p[f"{name}_trunk"]
        layers = getattr(net, f"{name}_trunk").layers
        if len(tree) != len(layers):
            raise ValueError(f"{name}_trunk: {len(tree)} flax layers, {len(layers)} torch layers")
        for i, lin in enumerate(layers):
            yield lin, tree[f"Dense_{i}"]
        yield getattr(net, head), p[head]


def _as_linear(lin: torch.nn.Linear, leaf):
    """(weight [out, in], bias [out]) of a flax Dense leaf, checked against ``lin``."""
    kernel = np.array(leaf["kernel"], np.float32)
    if kernel.shape != (lin.in_features, lin.out_features):
        raise ValueError(f"kernel {kernel.shape} does not fit Linear({lin.in_features}, {lin.out_features})")
    return torch.as_tensor(kernel.T), torch.as_tensor(np.array(leaf["bias"], np.float32))


def load_flax_params(net: ADDNet, flax_params) -> None:
    """Copy a flax ``ADDNet`` parameter tree into ``net`` in place."""
    with torch.no_grad():
        for lin, leaf in _dense_pairs(net, flax_params):
            w, b = _as_linear(lin, leaf)
            lin.weight.copy_(w)
            lin.bias.copy_(b)


def _flax_like_params(net: ADDNet, flax_tree):
    """A flax-shaped tree (e.g. an Adam moment) as tensors in the order of
    ``net.parameters()``, on the parameters' device."""
    by_param = {}
    for lin, leaf in _dense_pairs(net, flax_tree):
        w, b = _as_linear(lin, leaf)
        by_param[id(lin.weight)], by_param[id(lin.bias)] = w, b
    return [by_param[id(p)].to(p.device) for p in net.parameters()]


def _adam_moments(opt_state):
    """(count, mu, nu) of a ``FusedAdamState`` or of the one Adam state in
    an optax chain's state tuple."""
    found = []

    def walk(x):
        if all(hasattr(x, f) for f in ("count", "mu", "nu")):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"{len(found)} Adam states in the optimizer state, expected one")
    return found[0].count, found[0].mu, found[0].nu


def load_adam_state(net: ADDNet, jax_opt_state) -> AdamState:
    """The port's ``AdamState`` holding a JAX optimizer state's moments."""
    count, mu, nu = _adam_moments(jax_opt_state)
    dev = next(net.parameters()).device
    return AdamState(
        count=torch.as_tensor(np.array(count), dtype=torch.int32, device=dev),
        mu=_flax_like_params(net, mu), nu=_flax_like_params(net, nu),
    )


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def from_jax(agent: ADDAgent, jax_ts) -> TrainState:
    """A port ``TrainState`` holding the JAX train state's networks, Adam
    moments, obs normalizer, disc diff normalizer, sampler errors and
    sample count."""
    dev = agent.device
    ts = agent.init_train_state()
    load_flax_params(ts.params, jax_ts.params)
    on, dn = jax_ts.obs_norm, jax_ts.disc_norm
    return TrainState(
        params=ts.params,
        opt_state=load_adam_state(ts.params, jax_ts.opt_state),
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
