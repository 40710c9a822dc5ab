"""Networks for the PPO/ADD models (``nn.Module``).

Counterpart of ``add_gym_tpu/learning/networks.py``: named MLP trunks with
ReLU activations and zero bias init; hidden layers use U(+-1/sqrt(fan_in))
weights, the actor mean head U(+-actor_init_output_scale), the critic head
U(+-1/sqrt(fan_in)) and the disc logit head U(+-1).  The action std is the
agent's constant (``std_type`` "fixed"), a learned ``actor_logstd``
parameter ("constant") or a head on the actor trunk ("variable", weights
U(+-actor_init_output_scale), bias ``init_logstd``).  The registry's
Atari-style conv trunk ``cnn_3conv_1fc_0`` takes ``[..., H, W, C]`` input
as the JAX package's does.  ``forward`` of each head takes an optional
compute dtype for the trunk (bf16 mixed precision: trunk matmuls in bf16
on bf16 inputs, heads in f32 on the trunk's output cast to f32).
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


class CNN3Conv1FC(nn.Module):
    """Three VALID ReLU convolutions (32 8x8 /4, 64 4x4 /2, 64 3x3 /1) and a
    512-unit ReLU Linear over ``[..., H, W, C]`` input; ``in_shape`` is
    ``(H, W, C)``.  The convolutions run in NCHW and their output is
    flattened in H, W, C order, as the JAX package's NHWC trunk flattens,
    so that its Dense kernel carries over unchanged.  The convolutions
    start as flax's do: lecun-normal kernels (a normal truncated at 2
    sigma, rescaled to variance 1/fan_in) and zero biases."""

    SPEC = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, in_shape, fc_size: int = 512, generator=None, device=None):
        super().__init__()
        h, w, c = in_shape
        self.convs = nn.ModuleList()
        for feat, kern, stride in self.SPEC:
            conv = nn.Conv2d(c, feat, kern, stride, device=device)
            std = 1.0 / math.sqrt(c * kern * kern) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                conv.bias.zero_()
            self.convs.append(conv)
            h, w, c = (h - kern) // stride + 1, (w - kern) // stride + 1, feat
        self.fc = nn.Linear(h * w * c, fc_size, device=device)
        _init_linear(self.fc, 1.0 / math.sqrt(h * w * c), generator)
        self.out_dim = fc_size

    def forward(self, x, dtype=None):
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
        cast = (lambda t: t.to(dtype)) if dtype is not None else (lambda t: t)
        x = cast(x)
        for conv in self.convs:
            x = F.relu(F.conv2d(x, cast(conv.weight), cast(conv.bias), conv.stride))
        x = x.permute(0, 2, 3, 1).reshape(tuple(lead) + (-1,))
        return F.relu(F.linear(x, cast(self.fc.weight), cast(self.fc.bias)))


def build_trunk(name: str, in_dim, generator=None, device=None) -> nn.Module:
    """A registry trunk on ``in_dim`` features (an int), or for
    ``cnn_3conv_1fc_0`` on ``[H, W, C]`` images (``in_dim`` a 3-tuple)."""
    if name in NET_REGISTRY:
        return MLP(in_dim, NET_REGISTRY[name], generator, device)
    if name == "cnn_3conv_1fc_0":
        if isinstance(in_dim, int):
            raise ValueError(f"{name} takes [H, W, C] input, got {in_dim} features")
        return CNN3Conv1FC(in_dim, generator=generator, device=device)
    raise KeyError(f"unknown net: {name}")


STD_TYPES = ("fixed", "constant", "variable")


class ADDNet(nn.Module):
    """Actor + critic [+ discriminator]: with ``enable_disc=False`` a plain
    PPO model with no disc parameters."""

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
        std_type: str = "fixed",
        init_logstd: float = math.log(0.05),
        generator: torch.Generator | None = None,
        device=None,
    ):
        """Weights are drawn from ``generator``, which must live on ``device``."""
        super().__init__()
        if std_type not in STD_TYPES:
            raise ValueError(f"actor_std_type must be one of {STD_TYPES}, got {std_type!r}")
        g, dev = generator, device
        self.std_type = std_type
        self.actor_trunk = build_trunk(actor_net, obs_dim, g, dev)
        self.actor_mean = nn.Linear(self.actor_trunk.out_dim, action_dim, device=dev)
        _init_linear(self.actor_mean, actor_init_output_scale, g)
        if std_type == "constant":
            self.actor_logstd = nn.Parameter(
                torch.full((action_dim,), float(init_logstd), device=dev))
        elif std_type == "variable":
            self.actor_logstd_head = nn.Linear(self.actor_trunk.out_dim, action_dim, device=dev)
            _init_linear(self.actor_logstd_head, actor_init_output_scale, g)
            with torch.no_grad():
                self.actor_logstd_head.bias.fill_(float(init_logstd))
        self.critic_trunk = build_trunk(critic_net, obs_dim, g, dev)
        self.critic_out = nn.Linear(self.critic_trunk.out_dim, 1, device=dev)
        _init_linear(self.critic_out, 1.0 / math.sqrt(self.critic_trunk.out_dim), g)
        self.enable_disc = enable_disc
        if enable_disc:
            self.disc_trunk = build_trunk(disc_net, disc_obs_dim, g, dev)
            self.disc_logit = nn.Linear(self.disc_trunk.out_dim, 1, device=dev)
            _init_linear(self.disc_logit, 1.0, g)

    def actor(self, obs, trunk_dtype=None):
        """``(mean, logstd)`` [..., action_dim] in f32; ``logstd`` is None
        for ``std_type`` "fixed" (the agent's constant)."""
        h = self.actor_trunk(obs, trunk_dtype).float()
        mean = self.actor_mean(h)
        if self.std_type == "constant":
            return mean, self.actor_logstd.expand(mean.shape)
        if self.std_type == "variable":
            return mean, self.actor_logstd_head(h)
        return mean, None

    def critic(self, obs, trunk_dtype=None):
        return self.critic_out(self.critic_trunk(obs, trunk_dtype).float())[..., 0]

    def disc(self, disc_obs, trunk_dtype=None):
        return self.disc_logit(self.disc_trunk(disc_obs, trunk_dtype).float())[..., 0]
