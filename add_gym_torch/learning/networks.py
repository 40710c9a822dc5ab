"""Networks for the PPO/ADD models (``nn.Module``).

Counterpart of ``add_gym_tpu/learning/networks.py``: named MLP trunks with
ReLU activations and zero bias init; hidden layers use U(+-1/sqrt(fan_in))
weights, the actor mean head U(+-actor_init_output_scale), the critic head
U(+-1/sqrt(fan_in)) and the disc logit head U(+-1).  ``forward`` of each
head takes an optional compute dtype for the trunk (bf16 mixed precision:
trunk matmuls in bf16 on bf16 inputs, heads in f32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# name -> hidden layer sizes (e.g. fc_3layers_1024units: [1024, 1024, 512])
NET_REGISTRY = {
    "fc_2layers_64units": (64, 64),
    "fc_2layers_128units": (128, 128),
    "fc_2layers_256units": (256, 256),
    "fc_2layers_512units": (512, 512),
    "fc_2layers_1024units": (1024, 512),
    "fc_3layers_1024units": (1024, 1024, 512),
}


def _init_linear(lin: nn.Linear, scale: float, generator: torch.Generator | None):
    with torch.no_grad():
        lin.weight.uniform_(-scale, scale, generator=generator)
        lin.bias.zero_()


class MLP(nn.Module):
    def __init__(self, in_dim: int, sizes, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList()
        d = in_dim
        for s in sizes:
            lin = nn.Linear(d, s, device=device)
            _init_linear(lin, 1.0 / math.sqrt(d), generator)
            self.layers.append(lin)
            d = s
        self.out_dim = d

    def forward(self, x, dtype=None):
        """ReLU MLP; with ``dtype`` the weights, biases and input are cast
        to it (the activations come back in that dtype)."""
        if dtype is not None:
            x = x.to(dtype)
        for lin in self.layers:
            w, b = lin.weight, lin.bias
            if dtype is not None:
                w, b = w.to(dtype), b.to(dtype)
            x = F.relu(F.linear(x, w, b))
        return x


def build_trunk(name: str, in_dim: int, generator=None, device=None) -> MLP:
    if name not in NET_REGISTRY:
        raise KeyError(f"unknown net: {name}")
    return MLP(in_dim, NET_REGISTRY[name], generator, device)


class ADDNet(nn.Module):
    """Actor + critic + discriminator (fixed action std: the std is the
    agent's constant, not a parameter)."""

    def __init__(
        self,
        obs_dim: int,
        disc_obs_dim: int,
        action_dim: int,
        actor_net: str = "fc_3layers_1024units",
        critic_net: str = "fc_3layers_1024units",
        disc_net: str = "fc_2layers_1024units",
        actor_init_output_scale: float = 0.01,
        enable_disc: bool = True,
        generator: torch.Generator | None = None,
        device=None,
    ):
        """Weights are drawn from ``generator``, which must live on ``device``."""
        super().__init__()
        g, dev = generator, device
        self.actor_trunk = build_trunk(actor_net, obs_dim, g, dev)
        self.actor_mean = nn.Linear(self.actor_trunk.out_dim, action_dim, device=dev)
        _init_linear(self.actor_mean, actor_init_output_scale, g)
        self.critic_trunk = build_trunk(critic_net, obs_dim, g, dev)
        self.critic_out = nn.Linear(self.critic_trunk.out_dim, 1, device=dev)
        _init_linear(self.critic_out, 1.0 / math.sqrt(self.critic_trunk.out_dim), g)
        self.enable_disc = enable_disc
        if enable_disc:
            self.disc_trunk = build_trunk(disc_net, disc_obs_dim, g, dev)
            self.disc_logit = nn.Linear(self.disc_trunk.out_dim, 1, device=dev)
            _init_linear(self.disc_logit, 1.0, g)

    def actor(self, obs, trunk_dtype=None):
        """Action mean [..., action_dim] in f32."""
        h = self.actor_trunk(obs, trunk_dtype)
        return self.actor_mean(h.float())

    def critic(self, obs, trunk_dtype=None):
        return self.critic_out(self.critic_trunk(obs, trunk_dtype).float())[..., 0]

    def disc(self, disc_obs, trunk_dtype=None):
        return self.disc_logit(self.disc_trunk(disc_obs, trunk_dtype).float())[..., 0]
