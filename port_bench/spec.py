"""A cell's files, found by the names ``BENCHMARK.json`` gives them.

A workload names a configuration and a traffic mix; the configuration file
holds the whole composed config as it is run (``config``), the traffic
file the dotted keys it sets on it (``set``) and what the correctness
check follows (``check``), and ``limits/<workload>.json`` the limit of
each number the check compares.  A configuration names its robot under
``inputs`` (``{"robot": "<name>"}``, one of ``inputs.ROBOTS``; ``g1``
where the key is absent).  Adding a cell, a configuration or a
metric adds files and ``BENCHMARK.json`` entries; nothing here changes.
"""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, bench: dict | None = None, here: str = HERE) -> dict:
    """The workload ``name`` with its configuration, traffic and limits
    files read: a dict with ``name``, ``entry`` (its BENCHMARK.json entry),
    ``config``, ``traffic`` and ``limits``.  Raises KeyError for a name
    BENCHMARK.json does not list and OSError for a missing file."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json lists no workload {name!r}")
    return dict(
        name=name,
        entry=entry,
        config=_load(os.path.join(here, "configs", f"{entry['config']}.json")),
        traffic=_load(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
        limits=_load(os.path.join(here, "limits", f"{name}.json")),
    )


def metric_names(bench: dict, workload_name: str, trace: bool) -> list:
    """The metrics a run of ``workload_name`` reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it; a metric with a
    ``workloads`` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group if workload_name in m.get("workloads", [workload_name])]


def set_dotted(cfg: dict, key: str, value) -> None:
    node = cfg
    parts = key.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def get_dotted(cfg: dict, key: str):
    node = cfg
    for p in key.split("."):
        node = node[p]
    return node


def robot(cell: dict) -> str:
    """The name of the robot the cell's configuration runs."""
    return cell["config"].get("inputs", {}).get("robot", "g1")


def _configured(cell: dict) -> dict:
    cfg = copy.deepcopy(cell["config"]["config"])
    for key, value in cell["traffic"]["set"].items():
        set_dotted(cfg, key, value)
    return cfg


def write_inputs(cell: dict, directory: str, seed: int):
    """The cell's robot and a clip from ``seed`` in the robot's joint order,
    written into ``directory``: (MJCF path, clip path).  Raises ValueError
    where the configuration's ``task.motion_joint_order`` is not that order."""
    from port_bench import inputs

    name = robot(cell)
    order = list(get_dotted(_configured(cell), "task.motion_joint_order"))
    if order != inputs.robot(name).joint_order:
        raise ValueError(f"workload {cell['name']}: task.motion_joint_order is not the joint "
                         f"order of robot {name!r} (inputs.ROBOTS)")
    return inputs.write_inputs(directory, clip_seed=seed, name=name)


def compose(cell: dict, mjcf: str, clip: str, seed: int) -> dict:
    """The config a run hands to the program and to the reference alike:
    the configuration's, with the traffic's keys set, the input files and
    the seed."""
    cfg = _configured(cell)
    set_dotted(cfg, "robot.asset_path", mjcf)
    set_dotted(cfg, "task.motion_file", clip)
    cfg["seed"] = int(seed)
    return cfg
