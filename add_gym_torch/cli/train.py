"""Training / evaluation CLI of the port.

Counterpart of ``add_gym_tpu/cli/train.py``: composes the config groups,
applies dotted overrides, joins the data-parallel group, dispatches
``mode=train|test`` and auto-resumes from the experiment's checkpoint.

Usage (one GPU; ``device=cpu`` runs on the CPU):

    python -m add_gym_torch.cli.train engine.num_envs=4096 experiment_name=run1
    python -m add_gym_torch.cli.train test checkpoint=logs/run1/checkpoint
    python -m add_gym_torch.cli.train dr_pod engine.num_envs=4096   # one card's share of dr_pod
    python -m add_gym_torch.cli.train train agent=amp_g1       # AMP (ppo_g1: plain PPO)
    python -m add_gym_torch.cli.train ppo256                   # plain PPO, 256 envs

``debug.nans=true`` makes the ``Trainer`` check every phase's outputs for
NaN and Inf (see ``learning/runner.py``).

Data-parallel over the GPUs of a host, one process per GPU (``engine.num_envs``
is the global count, split evenly over the ranks):

    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m add_gym_torch.cli.train multihost
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    evaluation's statistics in ``mode=test``."""
    argv = argv if argv is not None else sys.argv[1:]
    overrides = [a for a in argv if "=" in a]
    # a bare argument names the top-level config (configs/<name>.yaml)
    names = [a for a in argv if "=" not in a]
    config_name = names[0] if names else "train"

    from add_gym_torch.learning.runner import Trainer
    from add_gym_torch.parallel.mesh import initialize_distributed
    from add_gym_torch.utils.config import load_config

    cfg = load_config(config_name, overrides)
    mode = cfg.get("mode", "train")
    dbg = cfg.get("debug", {}) or {}
    dcfg = cfg.get("distributed", {}) or {}
    dist = initialize_distributed(cfg.get("device", "cuda"), backend=dcfg.get("backend", "auto"))
    try:
        trainer = Trainer(cfg, dist=dist)
        try:
            return _run(trainer, cfg, mode, dbg)
        finally:
            trainer.close()
    finally:
        dist.close()


def _run(trainer, cfg, mode, dbg):
    if dbg.get("parity_check"):
        from add_gym_torch.utils.debug import parity_check

        parity_check(trainer.env)
    # the composed config, for reproducibility
    if trainer.dist.is_main:
        os.makedirs(trainer.exp_dir, exist_ok=True)
        with open(os.path.join(trainer.exp_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    if mode == "train":
        max_iters = cfg.get("max_iters")
        trainer.train(max_iters=int(max_iters) if max_iters else None)
        return None
    if mode == "test":
        ckpt = cfg.get("checkpoint")
        if ckpt:
            trainer.load(ckpt)
        info = trainer.evaluate(int(cfg.get("test_episodes", 10)))
        if trainer.dist.is_main:
            print(json.dumps(info))
        return info
    raise ValueError(f"Unsupported mode: {mode}")


if __name__ == "__main__":
    main()
