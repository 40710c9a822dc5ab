"""The port's program spans (``add_gym_torch.utils.trace``) on the CPU.

* With no profiler running, ``span`` is the shared no-op and a
  ``train_iter`` records nothing.
* Under a CPU ``torch.profiler`` one ``train_iter`` records the tree of
  spans: the root ``train_iter``; ``rollout`` (``rollout.draws``, one
  ``rollout.step`` a control step holding ``policy``, ``env.step`` and
  ``rollout.record``, then ``rollout.stack``), ``data``, ``update`` (one
  ``update.minibatch`` a minibatch step holding ``update.batch``,
  ``update.loss``, ``update.grad``, ``update.allreduce`` and
  ``update.opt``) and ``normalizers``; ``env.step`` holds ``env.physics``,
  ``env.motion``, ``env.reward_done``, ``env.reset`` and ``env.obs`` on the
  shiftable path and ``env.physics``, ``env.reset``, ``env.obs`` on the
  other; all under one iteration id, and no trace row carries a span's
  name.
* Mapped through the iteration's anchor, each ``update.opt`` and
  ``env.physics`` span encloses the ``aten::`` host rows issued inside it
  (no row crosses its edges; the optimizer's ``aten::_foreach_sqrt`` rows
  lie in ``update.opt`` spans), and the anchor maps within 50 us.
* On fixed draws and minibatch orders, the state after ``train_iter`` is
  the same bit for bit with and without a profiler.
* The ``Trainer``'s ``profile`` window writes the spans into
  ``trace_rank0.json`` as complete events on a track of their own.
"""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.learning.add_agent import pick_shuffle_block, state_digest
from add_gym_torch.learning.runner import Trainer
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils import trace
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T, EPOCHS, BATCH = 4, 4, 2, 2           # 2 epochs x 2 minibatches
ENV_SPANS = {True: {"env.physics", "env.motion", "env.reward_done", "env.reset", "env.obs"},
             False: {"env.physics", "env.reset", "env.obs"}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    return fx.write_g1_fixture(str(d)), fx.write_motion_csv(str(d / "clip.motion"), seed=5,
                                                            num_frames=120)


def _cfg(files, **top):
    cfg = load_config("train")
    cfg["robot"]["asset_path"], cfg["task"]["motion_file"] = files
    cfg["task"]["max_episode_length"] = 0.5
    cfg["engine"]["num_envs"] = N
    cfg["agent"].update(steps_per_iter=T, update_epochs=EPOCHS, batch_size=BATCH,
                        mixed_precision=False, actor_net="fc_2layers_64units",
                        critic_net="fc_2layers_64units", disc_net="fc_2layers_64units")
    cfg.update(device="cpu", test_episodes=0)
    cfg.update(top)
    return cfg


def _setup(files, shiftable=True):
    """Env, agent and (ts, es, obs) from fixed seeds, and fixed draws and
    minibatch orders for one iteration."""
    cfg = _cfg(files)
    if not shiftable:
        cfg["task"]["tar_obs_steps"] = [1, 3]
    env = build_env(cfg, device="cpu")
    assert env._aux_shiftable == shiftable
    g = torch.Generator().manual_seed(3)
    agent = build_agent(cfg, env, generator=g)
    ts = agent.init_train_state(torch.Generator().manual_seed(4))
    es = env.reset_where(env.init_state(N), torch.ones(N, dtype=torch.bool), ts.sampler,
                         generator=g)
    draws = agent.sample_rollout_draws(ts, N, T, torch.Generator().manual_seed(5))
    M, nb = T * N, math.ceil(T / BATCH)
    nblk = M // pick_shuffle_block(M, nb, M // nb, N, agent.cfg.minibatch_blocks)
    pg = torch.Generator().manual_seed(6)
    perms = torch.stack([torch.randperm(nblk, generator=pg) for _ in range(EPOCHS)])
    return agent, [ts, es, env.compute_obs(es)], dict(draws=draws, perms=perms)


def _traced_iter(files, shiftable=True, warm=False):
    """One profiled ``train_iter``; returns (records, kineto events, state).
    ``warm`` runs a profiled iteration before it, whose records are dropped."""
    agent, state, fixed = _setup(files, shiftable)
    trace.take()
    if warm:
        with profile(activities=[ProfilerActivity.CPU]):
            state = list(agent.train_iter(*state, **fixed)[:3])
        trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = list(agent.train_iter(*state, **fixed)[:3])
    return trace.take(), list(prof.profiler.kineto_results.events()), state


def test_no_profiler_records_nothing(files):
    trace.take()
    assert trace.span("rollout.step") is trace.NOOP
    assert trace.span("train_iter") is trace.NOOP
    agent, state, fixed = _setup(files)
    agent.train_iter(*state, **fixed)
    assert trace.spans() == []


@pytest.mark.parametrize("shiftable", [True, False], ids=["shiftable", "composed"])
def test_train_iter_records_the_span_tree(files, shiftable):
    records, events, _ = _traced_iter(files, shiftable)
    spans = [r for r in records if r[0] != trace.ANCHOR]
    anchors = [r for r in records if r[0] == trace.ANCHOR]
    names = [r[0] for r in spans]
    assert len(anchors) == 1
    assert names.count("train_iter") == 1
    assert names.count("rollout.step") == T
    assert names.count("update.minibatch") == EPOCHS * math.ceil(T / BATCH)
    assert len({r[4] for r in records}) == 1            # one iteration id
    parents = {"train_iter": None, "rollout": "train_iter", "data": "train_iter",
               "update": "train_iter", "normalizers": "train_iter",
               "rollout.draws": "rollout", "rollout.step": "rollout", "rollout.stack": "rollout",
               "policy": "rollout.step", "env.step": "rollout.step",
               "rollout.record": "rollout.step", "update.minibatch": "update"}
    parents.update({n: "update.minibatch" for n in ("update.batch", "update.loss", "update.grad",
                                                   "update.allreduce", "update.opt")})
    parents.update({n: "env.step" for n in ENV_SPANS[shiftable]})
    assert {(n, p) for n, _, _, p, _ in spans} == set(parents.items())
    for n in ENV_SPANS[shiftable]:
        assert names.count(n) == T
    for _, start, end, _, _ in spans:
        assert start <= end
    # a child lies inside its parent
    by_name = {}
    for r in spans:
        by_name.setdefault(r[0], []).append(r)
    for n, s, e, p, _ in spans:
        if p is not None:
            assert any(ps <= s and e <= pe for _, ps, pe, _, _ in by_name[p]), n
    # the spans are not profiler ranges: only the zero-width anchor is
    assert not set(parents) & {e.name() for e in events}
    assert [e.name() for e in events].count(trace.ANCHOR) == 1


def test_spans_enclose_their_host_rows_through_the_anchor(files):
    records, events, _ = _traced_iter(files, warm=True)
    rows = [e for e in events if e.name() == trace.ANCHOR]
    (_, before, after, _, _), = [r for r in records if r[0] == trace.ANCHOR]
    off = trace.offset(rows[0].start_ns(), rows[0].end_ns(), before, after)
    assert abs(off) < 50_000
    placed = trace.place(records, [(e.start_ns(), e.end_ns()) for e in rows])
    assert len(placed) == len(records) - 1
    aten = [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.name().startswith("aten::") and e.device_type() == torch.autograd.DeviceType.CPU]
    for name in ("update.opt", "env.physics"):
        spans = [(s, e) for n, s, e, _, _ in placed if n == name]
        assert spans
        for s, e in spans:
            inside = [r for r in aten if s <= r[1] <= e]
            assert inside, name
            assert all(r[2] <= e for r in inside), name
            # no row that started before the span ends inside it
            assert not [r for r in aten if r[1] < s < r[2] < e], name
    opt = [(s, e) for n, s, e, _, _ in placed if n == "update.opt"]
    sqrt = [r for r in aten if r[0] == "aten::_foreach_sqrt"]
    assert len(sqrt) == len(opt)
    assert all(any(s <= r[1] and r[2] <= e for s, e in opt) for r in sqrt)


def test_profiler_leaves_train_iter_bitwise(files):
    out = []
    for traced in (False, True):
        agent, state, fixed = _setup(files)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                ts, es, obs, _ = agent.train_iter(*state, **fixed)
            assert trace.take()
        else:
            ts, es, obs, _ = agent.train_iter(*state, **fixed)
        out.append((state_digest(ts), es, obs))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][2], out[1][2])
    assert torch.equal(out[0][1].sim.dof_vel, out[1][1].sim.dof_vel)
    assert torch.equal(out[0][1].motion_ids, out[1][1].motion_ids)


def test_trainer_profile_window_writes_spans(files, tmp_path):
    cfg = _cfg(files, log_dir=str(tmp_path), experiment_name="run",
               profile=dict(start_iter=1, num_iters=2))
    t = Trainer(cfg)
    t.train(max_iters=4)
    t.close()
    doc = json.load(open(tmp_path / "run" / "profile" / "trace_rank0.json"))
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    anchors = [e for e in doc["traceEvents"] if e.get("name") == trace.ANCHOR]
    iters = [e for e in spans if e["name"] == "train_iter"]
    assert len(iters) == len(anchors) == 2
    assert sorted(e["args"]["iteration"] for e in iters)[1] == iters[0]["args"]["iteration"] + 1
    assert sum(e["name"] == "rollout.step" for e in spans) == 2 * T
    assert {e["pid"] for e in spans} == {"add_gym_torch spans"}
    for it, a in zip(sorted(iters, key=lambda e: e["ts"]), sorted(anchors, key=lambda e: e["ts"])):
        # each root span starts just after its anchor ends, on the trace's clock (us)
        assert 0 <= it["ts"] - (a["ts"] + a["dur"]) < 1000.0
    assert trace.spans() == []
