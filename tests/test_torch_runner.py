"""The port's training loop and CLI on one process (CPU).

* ``Trainer`` checkpoints: a resume restores the saved train state bit for
  bit and the iteration; ``save_intermediate`` writes numbered snapshots;
  ``resume_path`` loads through ``file://``; the ``profile`` window writes
  a ``torch.profiler`` trace;
  a non-finite loss writes a post-mortem into ``crash/`` and raises; a
  checkpoint saved under ``optimizer: adam`` loads under ``fused_adam``
  and back (one Adam state in the port; the counterpart of
  tests/test_ckpt_migration.py); one saved under ``sgd`` does not load
  under ``adam``, nor the other way round; an ``amp``, a ``none`` and an
  ``sgd`` Trainer save and resume bit for bit.
* Every top-level config of the port composes (the counterpart of
  tests/test_configs.py::test_config_composes).
* ``debug.nans``: a NaN in the obs raises ``FloatingPointError`` naming the
  phase and the tensor; a clean run with the flag on is bitwise the run
  with it off.
* ``episode_stats`` equals the JAX package's exactly on numpy-seeded
  rewards and dones.
* ``ADDAgent.eval_rollout`` (the rich rollout with ``train=False``)
  against the JAX package's on the mini biped, from the same state with
  the reset draws JAX takes from each step's key: rewards, the final obs
  and env state within 1e-4 (the tolerance of tests/test_torch_env.py for
  what derives from a physics step), dones and motion ids exactly.
* ``ADDAgent.rollout(train=True)`` with ``rollout_lean``'s draws takes
  the same actions, log-probs and rewards as ``rollout_lean``.
* ``Trainer.evaluate`` counts whole episodes only, does not depend on the
  training state it interrupts, and with ``eval_isolated`` leaves that
  state untouched (the counterparts of tests/test_runner_eval.py, which
  needs the G1 assets).
* ``cli.train.main`` with ``device=cpu`` in ``mode=train`` (auto-resume
  included) and with config ``test``; ``video_interval`` writes the
  video's pose dump, and ``debug.nans`` raises ``FloatingPointError`` on a
  NaN that gets into a run.
* Without ``device=cpu``, ``build_env``, the ``Trainer`` and the CLIs
  ``train``, ``view`` and ``probe`` run on the card, and raise without one.
"""

import code
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.learning.runner import episode_stats as jax_episode_stats
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import _use_kernel, build_agent, build_env
from add_gym_torch.cli.probe import main as probe_main
from add_gym_torch.cli.train import main as cli_main
from add_gym_torch.cli.view import main as view_main
from add_gym_torch.envs.imitation import ImitationEnv
from add_gym_torch.learning.add_agent import state_digest
from add_gym_torch.learning.convert import from_jax
from add_gym_torch.learning.runner import CKPT_FILE, Trainer, episode_stats
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 4, 4
MAX_LEN = 0.5            # seconds: 50 control steps at 100 Hz


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("runner")
    return fx.write_g1_fixture(str(d)), fx.write_motion_csv(str(d / "clip.motion"), seed=5,
                                                            num_frames=120)


def _cfg(files, log_dir, **top):
    cfg = load_config("train")
    cfg["robot"]["asset_path"], cfg["task"]["motion_file"] = files
    cfg["task"]["max_episode_length"] = MAX_LEN
    cfg["engine"]["num_envs"] = N
    cfg["agent"].update(steps_per_iter=T, update_epochs=1, batch_size=2, mixed_precision=False,
                        actor_net="fc_2layers_64units", critic_net="fc_2layers_64units",
                        disc_net="fc_2layers_64units")
    cfg.update(device="cpu", test_episodes=0, log_dir=str(log_dir), experiment_name="run")
    cfg.update(top)
    return cfg


def _assert_state_equal(a, b):
    assert state_digest(a) == state_digest(b)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_resume_is_bitwise_with_snapshots(files, tmp_path):
    cfg = _cfg(files, tmp_path, iters_per_output=1, save_intermediate=True,
               profile=dict(start_iter=0, num_iters=1))
    t1 = Trainer(cfg)
    t1.train(max_iters=2)
    assert t1.iter == 2
    assert os.path.exists(tmp_path / "run" / "profile" / "trace_rank0.json")
    t2 = Trainer(cfg)                                  # the experiment's checkpoint wins
    assert t2.iter == 2
    _assert_state_equal(t2.ts, t1.ts)
    snaps = sorted(os.listdir(tmp_path / "run" / "intermediate_outputs"))
    assert snaps == [f"model_{k * T * N:012d}" for k in (1, 2)]
    for s in snaps:
        assert os.path.exists(tmp_path / "run" / "intermediate_outputs" / s / CKPT_FILE)
    # a resume_path elsewhere loads when the experiment has no checkpoint
    # (a periodic save records the iteration before its count advances, as
    # in the JAX package)
    t3 = Trainer(_cfg(files, tmp_path / "other",
                      resume_path=f"file://{tmp_path}/run/intermediate_outputs/{snaps[0]}"))
    assert t3.iter == 0 and int(t3.ts.sample_count) == T * N
    t1.close(), t2.close(), t3.close()


def test_nan_loss_writes_crash_checkpoint(files, tmp_path):
    t = Trainer(_cfg(files, tmp_path))
    real = t.agent.train_iter

    def poisoned(*a, **kw):
        ts, es, obs, info = real(*a, **kw)
        return ts, es, obs, dict(info, loss=torch.tensor(float("nan")))

    t.agent.train_iter = poisoned
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 0"):
        t.train(max_iters=3)
    assert os.path.exists(tmp_path / "run" / "crash" / CKPT_FILE)
    t.close()


@pytest.mark.parametrize("save_opt,load_opt", [("adam", "fused_adam"), ("fused_adam", "adam")])
def test_checkpoint_loads_under_the_other_adam(files, tmp_path, save_opt, load_opt):
    cfg = _cfg(files, tmp_path)
    cfg["agent"]["optimizer"] = save_opt
    t1 = Trainer(cfg)
    t1.train(max_iters=1)
    assert int(t1.ts.opt_state.count) == 2             # 1 epoch x 2 minibatches
    cfg = _cfg(files, tmp_path)
    cfg["agent"]["optimizer"] = load_opt
    t2 = Trainer(cfg)
    assert t2.iter == 1 and t2.agent.cfg.optimizer == load_opt
    _assert_state_equal(t2.ts, t1.ts)
    t2.train(max_iters=2)                               # and training goes on
    assert int(t2.ts.opt_state.count) == 4
    t1.close(), t2.close()


@pytest.mark.parametrize("mode", ["amp", "none", "sgd"])
def test_mode_checkpoint_resume_is_bitwise(files, tmp_path, mode):
    cfg = _cfg(files, tmp_path)
    if mode == "sgd":
        cfg["agent"]["optimizer"] = "sgd"
    else:
        cfg["agent"]["disc_mode"] = mode
    t1 = Trainer(cfg)
    t1.train(max_iters=2)
    t2 = Trainer(cfg)
    assert t2.iter == 2
    _assert_state_equal(t2.ts, t1.ts)
    assert type(t2.ts.disc_norm) is type(t1.ts.disc_norm)
    assert type(t2.ts.opt_state) is type(t1.ts.opt_state)
    t2.train(max_iters=3)                               # and training goes on
    assert t2.iter == 3 and int(t2.ts.sample_count) == 3 * T * N
    t1.close(), t2.close()


@pytest.mark.parametrize("save_opt,load_opt", [("sgd", "adam"), ("fused_adam", "sgd")])
def test_checkpoint_across_optimizer_families_raises(files, tmp_path, save_opt, load_opt):
    cfg = _cfg(files, tmp_path)
    cfg["agent"]["optimizer"] = save_opt
    Trainer(cfg).train(max_iters=1)
    cfg["agent"]["optimizer"] = load_opt
    with pytest.raises(ValueError, match=f"does not match the configured optimizer '{load_opt}'"):
        Trainer(cfg)


@pytest.mark.parametrize("entry", ["build_env", "Trainer", "cli.train", "cli.view", "cli.probe"])
def test_entry_points_default_to_the_card(files, tmp_path, entry, monkeypatch):
    """Without ``device=cpu`` each entry point runs on the card: where
    there is none it raises, and nothing falls back to the CPU."""
    cfg = _cfg(files, tmp_path)
    del cfg["device"]
    tools = [f"robot.asset_path={files[0]}", f"task.motion_file={files[1]}"]

    def run():
        if entry == "build_env":
            return build_env(cfg).device
        if entry == "Trainer":
            return Trainer(cfg).device
        if entry == "cli.view":
            view_main(tools + [f"out={tmp_path / 'view.npz'}", "max_seconds=0.1"])
            return torch.device("cuda")
        if entry == "cli.probe":
            monkeypatch.setattr(code, "interact", lambda **kw: None)
            monkeypatch.setitem(sys.modules, "IPython", None)
            probe_main(tools)
            return torch.device("cuda")
        cli_main([a for a in _cli_args(files, tmp_path) if a != "device=cpu"] + ["max_iters=1"])
        return torch.device("cuda")

    if torch.cuda.is_available():
        assert run().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


# --------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["train", "dr_pod", "multihost", "ppo256", "test", "add4096",
                                  "parity_cpu4"])
def test_config_composes(name):
    cfg = load_config(name)
    for group in ("task", "engine", "agent", "robot"):
        assert group in cfg, group
    assert int(cfg["engine"]["num_envs"]) > 0 and cfg["agent"].get("actor_net")
    assert cfg["task"].get("motion_file")
    agent = cfg["agent"]
    assert agent.get("disc_mode", "add") in ("add", "amp", "none")
    want = dict(ppo256=("none", 256, "train"), test=("add", 32, "test"),
                add4096=("add", 4096, "train"), parity_cpu4=("add", 4, "train"))
    if name in want:
        assert (agent.get("disc_mode", "add"), cfg["engine"]["num_envs"], cfg["mode"]) == want[name]
    fused = bool(cfg["engine"].get("fused", True))
    if name == "parity_cpu4":
        assert cfg["device"] == "cpu" and not fused
        assert cfg["engine"]["kernel"] == "off"
        assert not _use_kernel(cfg["engine"]["kernel"], torch.device("cpu"), fused)
    else:                       # the kernel on the card
        assert _use_kernel(cfg["engine"].get("kernel", "auto"), torch.device("cuda"), fused)
    if name == "ppo256":
        assert agent["task_reward_weight"] == 1.0 and "disc_net" not in agent


@pytest.mark.parametrize("group", ["amp_g1", "ppo_g1"])
def test_agent_group_matches_jax(group):
    assert load_config("train", [f"agent={group}"])["agent"] == \
        jax_load_config("train", [f"agent={group}"])["agent"]


# ------------------------------------------------------------- debug.nans


def test_debug_nans_names_the_phase(files, tmp_path):
    t = Trainer(_cfg(files, tmp_path, debug=dict(nans=True)))
    t.obs = t.obs.clone()
    t.obs[1, 3] = float("nan")
    with pytest.raises(FloatingPointError, match=r"debug.nans: .* rollout output 'norm_obs'"):
        t.train(max_iters=1)
    t.close()


def test_debug_nans_clean_run_is_bitwise(files, tmp_path):
    digests = []
    for nans in (False, True):
        t = Trainer(_cfg(files, tmp_path / str(nans), debug=dict(nans=nans)))
        t.train(max_iters=2)
        digests.append(state_digest(t.ts))
        t.close()
    assert digests[0] == digests[1]


# ------------------------------------------------------------ evaluation


def test_episode_stats_matches_jax():
    rng = np.random.default_rng(3)
    rewards = rng.normal(size=(40, 7)).astype(np.float32)
    dones = rng.choice(4, size=(40, 7), p=[0.85, 0.05, 0.05, 0.05]).astype(np.int32)
    got, want = episode_stats(rewards, dones), jax_episode_stats(rewards, dones)
    assert len(got[0]) > 5
    assert got == want


MINI_JOINTS = ["left_leg_joint", "right_leg_joint"]


def _mini_cfg(load, mjcf, clip):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["robot"]["joints"] = [{"match": ".*leg_joint", "tags": ["hip"]}]
    cfg["task"]["motion_file"] = clip
    cfg["task"]["motion_joint_order"] = MINI_JOINTS
    cfg["task"]["contact_bodies"] = ["left_leg_link", "right_leg_link"]
    cfg["engine"]["num_envs"] = 8
    cfg["agent"]["mixed_precision"] = False
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    return cfg


def test_eval_rollout_matches_jax(tmp_path):
    n, steps = 8, 6
    mjcf = fx.write_mini_mjcf(str(tmp_path))
    clip = fx.write_motion_csv(str(tmp_path / "mini.motion"), seed=3, num_frames=90,
                               joint_order=MINI_JOINTS, height=0.65)
    jcfg = _mini_cfg(jax_load_config, mjcf, clip)
    jenv = jax_build_env(jcfg)
    jagent = jax_build_agent(jcfg, jenv)
    jts = jagent.init_train_state(jax.random.PRNGKey(7))
    tcfg = _mini_cfg(load_config, mjcf, clip)
    tenv = build_env(tcfg, device="cpu")
    tagent = build_agent(tcfg, tenv)
    tts = from_jax(tagent, jts)

    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(n), jnp.ones(n, bool), jts.sampler)
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, n)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)
    tes = tenv.reset_where(tenv.init_state(n), torch.ones(n, dtype=torch.bool), tts.sampler,
                           draws=(np.asarray(r_ids), np.asarray(r_times)))
    # episodes that run out of time at the first step and near the fourth
    ep_time = np.zeros(n, np.float32)
    ep_time[[1, 5]] = jcfg["task"]["max_episode_length"] - 0.005
    ep_time[3] = jcfg["task"]["max_episode_length"] - 0.035
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    jobs, tobs = jenv.compute_obs(jes), tenv.compute_obs(tes)

    key = jax.random.PRNGKey(4)
    ids, times = [], []
    k = key
    for _ in range(steps):              # the reset draws of each step's key
        k, _, k_reset = jax.random.split(k, 3)
        ka, kb, _ = jax.random.split(k_reset, 3)
        ids.append(np.asarray(jenv.motion.sample_motions(ka, n)))
        times.append(np.asarray(jenv._sample_times(kb, jnp.asarray(ids[-1]), jts.sampler)))
    jes2, jobs2, jr, jd = jagent.eval_rollout(jts, jes, jobs, steps, key)
    tes2, tobs2, tr, td = tagent.eval_rollout(tts, tes, tobs, steps,
                                              draws=(None, None, np.stack(ids), np.stack(times)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (np.asarray(jd)[0, [1, 5]] != 0).all() and (np.asarray(jd) != 0).sum() >= 3
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tes2.motion_ids.numpy(), np.asarray(jes2.motion_ids))
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(tes2.sim, f).numpy(), np.asarray(getattr(jes2.sim, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_rich_train_rollout_matches_lean_rollout(files):
    cfg = _cfg(files, "unused")
    env = build_env(cfg, device="cpu")
    agent = build_agent(cfg, env)
    ts = agent.init_train_state()
    g = torch.Generator().manual_seed(5)
    es = env.reset_where(env.init_state(N), torch.ones(N, dtype=torch.bool), ts.sampler,
                         generator=g)
    ep_time = torch.zeros(N)
    ep_time[1] = MAX_LEN - 0.005                       # one reset on the first step
    es = dataclasses.replace(es, time=ep_time)
    obs = env.compute_obs(es)
    draws = agent.sample_rollout_draws(ts, N, T, g)
    _, obs_l, lean, _ = agent.rollout_lean(ts, es, obs, T, draws=draws)
    _, obs_r, rich = agent.rollout(ts, es, obs, T, train=True, draws=draws)
    assert bool((rich["done"][0, 1] != 0))
    for k in ("a_logp", "rand_mask", "reward", "done", "motion_ids"):
        assert torch.equal(rich[k], lean[k]), k
    assert torch.equal(rich["action"], lean["norm_a"] * agent.a_std + agent.a_mean)
    assert torch.equal(obs_r, obs_l)


def _cap_steps(max_len, dt=0.01):
    """Control steps until an episode's f32 time reaches ``max_len``."""
    t, k = np.float32(0.0), 0
    while t < np.float32(max_len):
        t, k = np.float32(t + np.float32(dt)), k + 1
    return k


def test_evaluate_counts_whole_episodes_and_ignores_training_state(files, tmp_path):
    t = Trainer(_cfg(files, tmp_path))
    g0 = t.generator.get_state()
    stats1 = t.evaluate(4)
    assert stats1["num_eps"] >= 4
    # every counted episode started at the entry reset: none exceeds the cap
    assert 0 < stats1["mean_ep_len"] <= _cap_steps(MAX_LEN)

    # interrupt a training state with episodes mid-flight, replay the same
    # evaluation draws: the same statistics
    g = torch.Generator().manual_seed(123)
    t.es, t.obs, _, _ = t.agent.eval_rollout(t.ts, t.es, t.obs, 7, generator=g)
    t.generator.set_state(g0)
    assert t.evaluate(4) == stats1
    t.close()


def test_eval_isolated_restores_training_state(files, tmp_path):
    t = Trainer(_cfg(files, tmp_path, eval_isolated=True))
    es0, obs0 = t.es, t.obs.clone()
    fields0 = dataclasses.asdict(es0)                  # deep copies
    info = t.evaluate(4)
    assert info["num_eps"] >= 1
    assert t.es is es0 and torch.equal(t.obs, obs0)
    for k, v in dataclasses.asdict(t.es).items():
        if k == "sim":
            assert all(torch.equal(v[f], fields0["sim"][f]) for f in v), k
        elif k == "dr":
            assert all(torch.equal(v[f], fields0["dr"][f]) for f in v), k
        else:
            assert torch.equal(v, fields0[k]), k
    t.close()


# ------------------------------------------------------------------- CLI


def _cli_args(files, log_dir):
    mjcf, clip = files
    return ["train", "device=cpu", f"robot.asset_path={mjcf}", f"task.motion_file={clip}",
            f"engine.num_envs={N}", f"agent.steps_per_iter={T}", "agent.batch_size=2",
            "agent.update_epochs=1", "agent.actor_net=fc_2layers_64units",
            "agent.critic_net=fc_2layers_64units", "agent.disc_net=fc_2layers_64units",
            f"task.max_episode_length={MAX_LEN}", "test_episodes=2", "iters_per_output=1",
            f"log_dir={log_dir}", "experiment_name=cli"]


def test_cli_train_resume_and_test(files, tmp_path):
    args = _cli_args(files, tmp_path)
    assert cli_main(args + ["max_iters=2"]) is None
    assert cli_main(args + ["max_iters=3"]) is None       # resumes at iteration 2
    exp = tmp_path / "cli"
    cfg = json.loads((exp / "config.json").read_text())
    assert cfg["device"] == "cpu" and cfg["engine"]["num_envs"] == N
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["samples"] for r in rows] == [T * N, 2 * T * N, 3 * T * N]
    assert all(np.isfinite(r["loss"]) and r["test_num_eps"] >= 2 for r in rows)
    log = (exp / "log.txt").read_text().splitlines()
    assert len(log) == 2 + 3 and log[0].split()[0] == "samples"     # a header per run
    # config test (mode test): the checkpoint's greedy policy
    info = cli_main(["test"] + args[1:] + [f"checkpoint={exp / 'checkpoint'}"])
    assert info["num_eps"] >= 2 and np.isfinite(info["mean_return"])


@pytest.mark.parametrize("override,match", [("video_interval=1", "video"),
                                            ("debug.nans=true", "debug.nans")])
def test_unported_options_raise(files, tmp_path, monkeypatch, override, match):
    """Both options are ported: ``video_interval`` records a video at each
    output iteration (here a short one: its pose dump is written, and
    without visual meshes in the fixture the render falls back to the stick
    figure); ``debug.nans`` raises on a NaN that gets into the run (here the
    first step's obs)."""
    if override.startswith("video"):
        monkeypatch.setattr(Trainer, "record_video",
                            functools.partialmethod(Trainer.record_video, seconds=0.03))
        cli_main(_cli_args(files, tmp_path) + ["max_iters=1", "test_episodes=0", override])
        d = np.load(tmp_path / "cli" / "rollout_0000000.gif.npz")
        assert d["body_pos"].shape == (3, 30, 3) and np.isfinite(d["body_pos"]).all()
        assert os.path.getsize(tmp_path / "cli" / "rollout_0000000.gif") > 0
        return
    real = ImitationEnv.rollout_step_cached

    def poisoned(self, *a, **kw):
        state, obs, aux, out = real(self, *a, **kw)
        return state, torch.full_like(obs, float("nan")), aux, out

    monkeypatch.setattr(ImitationEnv, "rollout_step_cached", poisoned)
    with pytest.raises(FloatingPointError, match=match):
        cli_main(_cli_args(files, tmp_path) + ["max_iters=1", "test_episodes=0", override])
