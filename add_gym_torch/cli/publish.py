"""Export a trained checkpoint as a publishable model artifact.

Counterpart of ``add_gym_tpu/cli/publish.py``: strips the optimizer state
from a training checkpoint (``checkpoint/train_state.pt``, read through
the ``Trainer``'s loading code) and writes a self-contained model
directory: the network's parameters (``model.pt``, a ``torch.save`` of the
agent's parameter state dict), the normalizer statistics
(``normalizers.pt``), the composed config, ``metadata.json`` and a model
card.  ``--push`` uploads the directory: ``hf://org/repo`` to the Hugging
Face Hub, ``gs://``, ``s3://`` or ``file://`` through
``utils.remote.push_dir``; export itself makes no network call.

Usage:
    python -m add_gym_torch.cli.publish logs/run1/checkpoint out_dir/ \
        [--config logs/run1/config.json] [--name my-g1-add] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile

MODEL_CARD = """\
---
license: mit
library_name: pytorch
tags:
  - reinforcement-learning
  - locomotion
  - robotics
  - g1
---

# {name}

A Unitree G1 (29-DOF) humanoid motion-imitation policy trained with
PPO + an adversarial differential discriminator (ADD) on the
`add_gym_torch` PyTorch/CUDA framework.

- actor/critic: `{actor_net}` / `{critic_net}` MLPs
- discriminator: `{disc_net}` MLP over observation-difference histories
- training samples: {sample_count}
- observation dim: {obs_dim}; action dim: {action_dim}

## Files

- `model.pt` — the network's parameter state dict (actor + critic + discriminator)
- `normalizers.pt` — running observation / diff normalizer statistics
- `config.json` — full composed training config
- `metadata.json` — shapes and training counters

## Usage

```python
import json, torch
from add_gym_torch.builder import build_env, build_agent

cfg = json.load(open("config.json"))
env = build_env(cfg, device="cpu")
agent = build_agent(cfg, env)
ts = agent.init_train_state()
ts.params.load_state_dict(torch.load("model.pt"))
```
"""


def export(checkpoint: str, out_dir: str, config_path: str | None = None,
           name: str = "add-gym-torch-g1", device=None) -> dict:
    """Write the artifact of ``checkpoint`` (a directory or a ``gs://``,
    ``s3://`` or ``file://`` URI) into ``out_dir``; returns the metadata.
    The config defaults to the ``config.json`` beside the checkpoint; the
    state is read on ``device`` (default the config's, else ``cuda``)."""
    import torch

    from add_gym_torch.learning.add_agent import train_state_dict
    from add_gym_torch.learning.runner import Trainer

    cfg = {}
    if config_path is None:
        cand = os.path.join(os.path.dirname(os.path.abspath(checkpoint)), "config.json")
        config_path = cand if os.path.exists(cand) else None
    if config_path:
        with open(config_path) as f:
            cfg = json.load(f)

    # only the train state's structure matters for the read: a small env
    # batch keeps it cheap, and a scratch log directory keeps the Trainer
    # from resuming its own experiment; the artifact's config.json keeps
    # the training config as it was
    build_cfg = copy.deepcopy(cfg)
    build_cfg.setdefault("engine", {})["num_envs"] = 8
    build_cfg.update(test_episodes=0, resume_path=None, video_interval=0)
    with tempfile.TemporaryDirectory() as tmp:
        build_cfg["log_dir"] = tmp
        trainer = Trainer(build_cfg, device=device)
        try:
            trainer.load(checkpoint)
        finally:
            trainer.close()
    env, ts = trainer.env, trainer.ts
    d = train_state_dict(ts)
    cpu = lambda m: {k: v.detach().cpu() for k, v in m.items()}

    os.makedirs(out_dir, exist_ok=True)
    torch.save(cpu(d["params"]), os.path.join(out_dir, "model.pt"))
    torch.save({"obs_norm": cpu(d["obs_norm"]), "disc_norm": cpu(d["disc_norm"])},
               os.path.join(out_dir, "normalizers.pt"))
    if cfg:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    agent_cfg = cfg.get("agent", {})
    meta = {
        "name": name,
        "iter": int(trainer.iter),
        "sample_count": int(ts.sample_count),
        "obs_dim": env.obs_dim(),
        "disc_obs_dim": env.disc_obs_dim(),
        "action_dim": env.num_dofs,
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(MODEL_CARD.format(
            name=name,
            actor_net=agent_cfg.get("actor_net", "fc_3layers_1024units"),
            critic_net=agent_cfg.get("critic_net", "fc_3layers_1024units"),
            disc_net=agent_cfg.get("disc_net", "fc_2layers_1024units"),
            sample_count=meta["sample_count"],
            obs_dim=meta["obs_dim"],
            action_dim=meta["action_dim"],
        ))
    print(f"exported {checkpoint} -> {out_dir}")
    return meta


def push_to_hf(out_dir: str, repo_id: str, private: bool = False) -> str:
    """Upload the exported artifact to the Hugging Face Hub: create the
    repo if missing (a re-push is idempotent) and upload the whole folder.
    Needs ``HF_TOKEN`` (or a cached login) with write access."""
    from huggingface_hub import HfApi

    api = HfApi()
    api.create_repo(repo_id=repo_id, repo_type="model", private=private, exist_ok=True)
    meta_path = os.path.join(out_dir, "metadata.json")
    it = "?"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            it = json.load(f).get("iter", "?")
    api.upload_folder(
        repo_id=repo_id,
        folder_path=out_dir,
        repo_type="model",
        commit_message=f"Update checkpoint (iter {it})",
    )
    url = f"https://huggingface.co/{repo_id}"
    print(f"pushed {out_dir} -> {url}")
    return url


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="checkpoint directory (Trainer.save) or URI")
    ap.add_argument("out_dir")
    ap.add_argument("--config", default=None, help="config.json from the run dir")
    ap.add_argument("--name", default="add-gym-torch-g1")
    ap.add_argument("--device", default=None,
                    help="device to read the checkpoint on (default: the config's, else cuda)")
    ap.add_argument(
        "--push", default=None, metavar="URI",
        help="also upload the artifact: hf://org/repo (Hugging Face Hub) or "
             "gs:// | s3:// | file:// bucket upload",
    )
    ap.add_argument("--private", action="store_true",
                    help="create the HF repo as private (first creation only)")
    args = ap.parse_args(argv)
    export(args.checkpoint, args.out_dir, args.config, args.name, args.device)
    if args.push:
        if args.push.startswith("hf://"):
            push_to_hf(args.out_dir, args.push[len("hf://"):], args.private)
        else:
            from add_gym_torch.utils.remote import push_dir

            push_dir(args.out_dir, args.push)


if __name__ == "__main__":
    main()
