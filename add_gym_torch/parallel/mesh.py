"""Data-parallel bootstrap: one process per GPU under ``torch.distributed``.

Counterpart of ``add_gym_tpu/parallel/mesh.py``.  The JAX package shards
envs along a one-axis device mesh and lets GSPMD make every batch
reduction global.  Here each process (a *rank*, started by
``python -m torch.distributed.run``) owns one device and a contiguous
shard of the envs; the learner's parameters are replicated, and every
batch statistic, and the gradients once per minibatch, are reduced
explicitly with the helpers of :class:`Dist`.

:func:`initialize_distributed` reads the variables that
``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).  Where they are absent the process runs
alone, with no process group, and every helper is a no-op.  Where they
are present the process group is created (NCCL on CUDA, gloo on the CPU,
unless a backend is named), and a failure raises: a silent fallback would
train N independent models.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as tdist

from add_gym_torch.utils.device import resolve_device


@dataclass(frozen=True)
class EnvShard:
    """The rank's envs: global indices ``[start, stop)`` of ``num_envs``."""

    start: int
    stop: int
    num_envs: int

    @property
    def size(self) -> int:
        return self.stop - self.start

    @property
    def slice(self) -> slice:
        return slice(self.start, self.stop)


@dataclass(frozen=True)
class Dist:
    """This process's place in the data-parallel group.

    ``group`` is True when a process group exists (``torch.distributed``
    was initialized by :func:`initialize_distributed`); the collectives
    run only when there is one and ``world_size > 1``.
    """

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    group: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def _collective(self) -> bool:
        return self.group and self.world_size > 1

    def shard(self, num_envs: int) -> EnvShard:
        """The rank's contiguous share of ``num_envs`` global envs; raises
        unless the world size divides ``num_envs``."""
        if num_envs % self.world_size:
            raise ValueError(
                f"num_envs={num_envs} does not divide over {self.world_size} ranks")
        n = num_envs // self.world_size
        return EnvShard(self.rank * n, (self.rank + 1) * n, num_envs)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (``x`` itself, reduced in place)."""
        if self._collective:
            tdist.all_reduce(x, op=tdist.ReduceOp.SUM)
        return x

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks: the sum divided by the world
        size, the same way on every rank."""
        if self._collective:
            tdist.all_reduce(x, op=tdist.ReduceOp.SUM)
            x.div_(self.world_size)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (in place)."""
        if self._collective:
            tdist.broadcast(x, src=src)
        return x

    def barrier(self) -> None:
        if self._collective:
            if self.device.type == "cuda" and tdist.get_backend() == "nccl":
                tdist.barrier(device_ids=[self.device.index])
            else:
                tdist.barrier()

    def close(self) -> None:
        """Destroy the process group this process created."""
        if self.group and tdist.is_initialized():
            tdist.destroy_process_group()


def initialize_distributed(device="cuda", backend: str = "auto") -> Dist:
    """This process's :class:`Dist`, creating the process group where
    ``torch.distributed.run`` (or a caller) set ``WORLD_SIZE`` and
    ``MASTER_ADDR``.

    ``device`` names the device type: on CUDA the rank takes
    ``cuda:LOCAL_RANK`` and makes it current.  ``backend`` ``auto`` is
    NCCL on CUDA and gloo on the CPU.  Raises if the environment names a group that cannot
    be joined.
    """
    device = resolve_device(device)
    env = os.environ
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return Dist(device=device)

    rank = int(env["RANK"])
    world = int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(
                f"local rank {local_rank} has no CUDA device of its own ({count} visible); "
                f"start at most {count} ranks per host")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if backend == "auto":
        backend = "nccl" if device.type == "cuda" else "gloo"
    try:
        tdist.init_process_group(backend=backend, rank=rank, world_size=world)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed init failed (rank {rank} of {world}, backend {backend}, "
            f"MASTER_ADDR={env.get('MASTER_ADDR')!r} MASTER_PORT={env.get('MASTER_PORT')!r})"
        ) from e
    return Dist(rank=rank, world_size=world, local_rank=local_rank, device=device, group=True)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's own random stream: ``seed`` itself on rank 0,
    so a one-rank run draws what a run without a group draws (the
    counterpart of ``jax.random.fold_in(PRNGKey(seed), rank)``)."""
    return (int(seed) + 0x9E3779B97F4A7C15 * int(rank)) % (1 << 63)
