"""Hydra-compatible YAML config groups (no hydra dependency).

Counterpart of ``add_gym_tpu/utils/config.py`` over the port's own config
groups (``add_gym_torch/configs``: agent/engine/robot/task/distributed).  Same layout:
a top-level file with a ``defaults`` list of ``group: name`` entries
resolved from ``configs/<group>/<name>.yaml``, plus dotted CLI overrides
(``engine.num_envs=4096``, ``agent.learning_rate=3e-4``).
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, List

import yaml

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        # YAML 1.1 booleans: every bool-typed key would otherwise see a
        # truthy non-empty string ("engine.fused=off" force-enabling fused)
        if v.lower() in ("true", "on", "yes"):
            return True
        if v.lower() in ("false", "off", "no"):
            return False
        if v.lower() in ("null", "none"):
            return None
        return v


def _deep_set(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _deep_merge(base: Dict, extra: Dict) -> Dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    name: str = "train",
    overrides: List[str] | None = None,
    config_root: str | None = None,
) -> Dict:
    """Load configs/<name>.yaml, resolve its defaults list, apply overrides."""
    root = config_root or _CONFIG_ROOT
    with open(os.path.join(root, f"{name}.yaml")) as f:
        top = yaml.safe_load(f) or {}

    cfg: Dict[str, Any] = {}
    for entry in top.pop("defaults", []):
        if entry == "_self_":
            continue
        if isinstance(entry, dict):
            (group, gname), = entry.items()
        else:
            group, gname = entry.split("/", 1) if "/" in entry else (entry, entry)
        with open(os.path.join(root, group, f"{gname}.yaml")) as f:
            cfg[group] = yaml.safe_load(f) or {}

    cfg = _deep_merge(cfg, top)

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov}")
        k, v = ov.split("=", 1)
        # allow group swaps like "agent=other_agent"
        if "." not in k and k in ("agent", "engine", "robot", "task", "distributed"):
            with open(os.path.join(root, k, f"{v}.yaml")) as f:
                cfg[k] = yaml.safe_load(f) or {}
        else:
            _deep_set(cfg, k, _parse_value(v))
    return cfg
