"""Carry a JAX package train state across into the port.

The JAX package stores its networks as flax parameter trees
(``params["params"][<module>]["Dense_<i>"]`` with ``kernel [in, out]`` and
``bias [out]``; a conv trunk's ``Conv_<i>`` with ``kernel [H, W, in, out]``;
the learned std as ``actor_logstd [nd]`` or the ``actor_logstd_head``
Dense), its optimizer state as trees of the same shape (Adam moments in a
``FusedAdamState`` or inside an optax chain's state tuple, or the SGD
momentum ``trace`` of the chain's ``TraceState``), and its normalizers and
sampler as small dataclasses.  This module reads them as numpy arrays
(``np.asarray`` on each leaf), so it needs neither JAX nor the JAX package:
a flax ``Dense`` kernel becomes an ``nn.Linear`` weight ``[out, in]``, a
``Conv`` kernel (HWIO) a ``Conv2d`` weight (OIHW).
"""

from __future__ import annotations

import numpy as np
import torch

from add_gym_torch.learning.add_agent import ADDAgent, TrainState
from add_gym_torch.learning.networks import ADDNet
from add_gym_torch.learning.normalizer import DiffNormState, NormState
from add_gym_torch.learning.optim import AdamState, SGDState
from add_gym_torch.learning.sampler import SamplerState


def _flax_leaf(p, name: str):
    """The flax leaf of the torch parameter ``name`` and the layout it
    needs: "dense" (transpose), "conv" (HWIO -> OIHW) or "plain"."""
    parts = name.split(".")
    if parts[0].endswith("_trunk"):
        tree = p[parts[0]]
        if parts[1] == "layers":                       # MLP: layers.<i>.<weight|bias>
            return tree[f"Dense_{parts[2]}"], parts[3], "dense"
        if parts[1] == "convs":                        # conv trunk: convs.<i>.<weight|bias>
            return tree[f"Conv_{parts[2]}"], parts[3], "conv"
        return tree["Dense_0"], parts[2], "dense"      # conv trunk: fc.<weight|bias>
    if len(parts) == 1:                                # actor_logstd
        return p, parts[0], "plain"
    return p[parts[0]], parts[1], "dense"              # the heads


def _count_leaves(tree) -> int:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return sum(_count_leaves(v) for _, v in tree.items())
    return 1


def _by_name(net: ADDNet, flax_tree) -> dict:
    """{torch parameter name: tensor} of a flax-shaped tree (the network's
    parameters, or an optimizer state of the same shape)."""
    p = flax_tree["params"] if "params" in flax_tree else flax_tree
    named = dict(net.named_parameters())
    if _count_leaves(p) != len(named):
        raise ValueError(f"the flax tree has {_count_leaves(p)} leaves, the network "
                         f"{len(named)} parameters")
    out = {}
    for name, param in named.items():
        leaf, field, layout = _flax_leaf(p, name)
        key = "kernel" if field == "weight" else field
        x = np.array(leaf[key], np.float32)
        if field == "weight":
            x = x.T if layout == "dense" else x.transpose(3, 2, 0, 1)
        if x.shape != tuple(param.shape):
            raise ValueError(f"{name}: flax leaf of shape {x.shape}, parameter {tuple(param.shape)}")
        out[name] = torch.as_tensor(np.ascontiguousarray(x))
    return out


def load_flax_params(net: ADDNet, flax_params) -> None:
    """Copy a flax ``ADDNet`` parameter tree into ``net`` in place."""
    values = _by_name(net, flax_params)
    with torch.no_grad():
        for name, param in net.named_parameters():
            param.copy_(values[name])


def _flax_like_params(net: ADDNet, flax_tree):
    """A flax-shaped tree (e.g. an Adam moment) as tensors in the order of
    ``net.parameters()``, on the parameters' device."""
    values = _by_name(net, flax_tree)
    return [values[name].to(p.device) for name, p in net.named_parameters()]


def _find_states(opt_state, fields):
    """The states in an optimizer state (a chain's nested tuples) that have
    every one of ``fields``."""
    found = []

    def walk(x):
        if all(hasattr(x, f) for f in fields):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(opt_state)
    return found


def _adam_moments(opt_state):
    """(count, mu, nu) of a ``FusedAdamState`` or of the one Adam state in
    an optax chain's state tuple."""
    found = _find_states(opt_state, ("count", "mu", "nu"))
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


def load_sgd_state(net: ADDNet, jax_opt_state) -> SGDState:
    """The port's ``SGDState`` holding the momentum trace of the JAX
    agent's ``chain(clip_by_global_norm, sgd(lr, momentum))`` state."""
    found = _find_states(jax_opt_state, ("trace",))
    if len(found) != 1:
        raise ValueError(f"{len(found)} SGD trace states in the optimizer state, expected one")
    return SGDState(trace=_flax_like_params(net, found[0].trace))


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def load_normalizer(state, device):
    """A JAX ``NormState`` or ``DiffNormState`` as the port's."""
    if hasattr(state, "mean_abs"):
        return DiffNormState(count=_tensor(state.count, device),
                             mean_abs=_tensor(state.mean_abs, device),
                             min_diff=float(state.min_diff), clip=float(state.clip))
    return NormState(count=_tensor(state.count, device), mean=_tensor(state.mean, device),
                     mean_sq=_tensor(state.mean_sq, device), min_std=float(state.min_std),
                     clip=float(state.clip))


def from_jax(agent: ADDAgent, jax_ts) -> TrainState:
    """A port ``TrainState`` holding the JAX train state's networks (with
    or without a disc, any std type), optimizer state (Adam moments or the
    SGD trace, by the agent's ``optimizer``), obs normalizer, disc
    normalizer (``DiffNormState`` or, under ``amp``, ``NormState``),
    sampler errors and sample count."""
    dev = agent.device
    ts = agent.init_train_state()
    load_flax_params(ts.params, jax_ts.params)
    load_opt = load_sgd_state if agent.cfg.optimizer == "sgd" else load_adam_state
    return TrainState(
        params=ts.params,
        opt_state=load_opt(ts.params, jax_ts.opt_state),
        obs_norm=load_normalizer(jax_ts.obs_norm, dev),
        disc_norm=load_normalizer(jax_ts.disc_norm, dev),
        sampler=SamplerState(errors=_tensor(jax_ts.sampler.errors, dev)),
        sample_count=_tensor(jax_ts.sample_count, dev, torch.int64),
    )
