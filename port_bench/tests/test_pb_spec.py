"""BENCHMARK.json and the files it names: every workload resolves to its
configuration, traffic and limits, every metric to its reader, and a cell,
a configuration and a metric defined only in new files resolve as well."""

import json
import os
import re

import numpy as np
import pytest

from port_bench import check, inputs, run, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(name):
    cell = spec.workload(name, BENCH)
    assert cell["config"]["config"]["agent"]
    assert set(cell["traffic"]) >= {"set", "check"}
    assert cell["limits"] and set(cell["limits"]) <= set(check.NUMBERS)
    cfg = spec.compose(cell, "robot.xml", "clip.motion", seed=2**31 + 7)
    for key, value in cell["traffic"]["set"].items():
        assert spec.get_dotted(cfg, key) == value
    assert cfg["robot"]["asset_path"] == "robot.xml" and cfg["seed"] == 2**31 + 7
    for trace in (False, True):
        for metric in spec.metric_names(BENCH, name, trace):
            assert callable(run.importlib.import_module(f"port_bench.metrics.{metric}").read)


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("robot", [None, "g1_dex3"])
def test_scratch_cell_from_new_files_only(tmp_path, monkeypatch, robot):
    """A new configuration, traffic mix, limits file and metric reader,
    and their BENCHMARK.json entries, are all a new cell needs: it
    resolves, and a run of it at a tiny size on the CPU reports its
    metrics and its checks, and comes out correct.  A configuration that
    names another robot (``"inputs": {"robot": ...}``, its joint order as
    ``task.motion_joint_order``) runs on that robot's fixture and a clip
    in that order."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    base = spec.workload("g1_add.cloud", BENCH)
    config = json.loads(json.dumps(base["config"]))
    if robot is not None:
        config["inputs"] = {"robot": robot}
        config["config"]["task"]["motion_joint_order"] = inputs.ROBOTS[robot].joint_order
    (tmp_path / "configs" / "scratch_cfg.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "scratch_mix.json").write_text(json.dumps(
        {"set": {"engine.num_envs": 8, "agent.steps_per_iter": 4, "agent.batch_size": 2},
         "check": {"iterations": 1, "control_steps": 1}}))
    (tmp_path / "limits" / "scratch_cfg.scratch_mix.json").write_text(json.dumps(base["limits"]))
    (tmp_path / "metrics" / "scratch_metric.py").write_text(
        "def read(ctx):\n    return dict(value=float(ctx['iterations']), unit='1')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "scratch_cfg.scratch_mix", "config": "scratch_cfg",
                               "traffic": "scratch_mix", "chips": 1, "why": "scratch"})
    bench["per_layer"].append({"name": "scratch_metric", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "scratch",
                               "moves": "env_steps_per_s", "workloads": ["scratch_cfg.scratch_mix"]})
    cell = spec.workload("scratch_cfg.scratch_mix", bench, here=str(tmp_path))
    assert spec.compose(cell, "a.xml", "b.motion", 1)["engine"]["num_envs"] == 8
    assert "scratch_metric" in spec.metric_names(bench, "scratch_cfg.scratch_mix", True)
    assert "scratch_metric" not in spec.metric_names(bench, "g1_add.cloud", True)
    import port_bench.metrics as metrics_pkg
    monkeypatch.setattr(metrics_pkg, "__path__", list(metrics_pkg.__path__) + [str(tmp_path / "metrics")])
    assert run.read_metric("scratch_metric", dict(iterations=3)) == dict(value=3.0, unit="1")
    assert spec.robot(cell) == (robot or "g1")
    ctx = run.measure(cell, 2**31 + 5, 0.0, False, "cpu")
    out = run.result(ctx, ["env_steps_per_s", "setup_s", "scratch_metric"])
    assert set(out["metrics"]) == {"env_steps_per_s", "setup_s", "scratch_metric"}
    assert set(out["checks"]) == set(base["limits"]) and out["attempted"] >= 1
    assert out["correct"], out["checks"]
    fixture = inputs.ROBOTS[robot or "g1"].write
    mjcf, clip = ctx["cfg"]["robot"]["asset_path"], ctx["cfg"]["task"]["motion_file"]
    assert os.path.basename(mjcf) == os.path.basename(fixture(str(tmp_path)))
    frames = np.loadtxt(clip, delimiter=",")
    assert frames.shape[1] == 7 + len(config["config"]["task"]["motion_joint_order"])
    assert ctx["model_counts"]["num_dofs"] == frames.shape[1] - 7
