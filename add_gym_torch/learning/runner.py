"""Host-side training loop: checkpoints, auto-resume, evaluation, logging.

Counterpart of ``add_gym_tpu/learning/runner.py``: :class:`Trainer` runs
``ADDAgent.train_iter`` in a loop with periodic greedy evaluation, saves
``{train_state, iter}`` and resumes from the experiment's checkpoint (a
spot restart) or from ``resume_path``.

Under data parallelism every rank builds a Trainer on its own device and
its shard of the envs (``parallel.mesh.Dist``).  The train state starts
the same on every rank: initialized from the config seed, or read from a
checkpoint by rank 0, then rank 0's copy broadcast to all; each rank draws its own rollouts and minibatch
permutations from its own generator (``rank_seed``); ``train_iter`` keeps
the learner's state identical across ranks.  Every rank calls
:meth:`Trainer.save` and meets the others at a barrier, and rank 0 writes;
evaluation runs the same number of chunks on every rank and reduces its
episode sums.

``video_interval: k`` records a video every k-th output iteration
(:meth:`Trainer.record_video`): every rank rolls its envs forward the same
number of steps through the env's backend, and rank 0 writes env 0's
poses (``<path>.npz``) and renders them.

``debug.nans: true`` (the closest counterpart of the JAX package's
``jax_debug_nans``) checks every floating output of each phase of every
``train_iter`` (the rollout's trajectory and next obs, the train data, the
update's infos) and raises ``FloatingPointError`` naming the phase and the
tensor; off, it adds no work.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.envs.done import DoneFlags
from add_gym_torch.learning.add_agent import (
    load_train_state_dict, state_digest, state_tensors, train_state_dict,
)
from add_gym_torch.parallel.mesh import Dist, rank_seed
from add_gym_torch.utils.device import resolve_device
from add_gym_torch.utils import trace
from add_gym_torch.utils.logger import TrainLogger

CKPT_FILE = "train_state.pt"


def _opt_family(name: str) -> str:
    """``adam`` and ``fused_adam`` share one Adam state; ``sgd`` has traces."""
    return "sgd" if name == "sgd" else "adam"


def nan_check_hook(iteration: int):
    """A ``train_iter`` hook that raises ``FloatingPointError`` at the first
    non-finite floating tensor of a phase's outputs (``debug.nans``)."""

    def hook(phase, outputs):
        for k, v in outputs.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise FloatingPointError(
                    f"debug.nans: non-finite values in the {phase} output {k!r} at iter "
                    f"{iteration}")

    return hook


def episode_stats(rewards: np.ndarray, dones: np.ndarray):
    """Per-episode returns and lengths from time-major ``[T, N]`` buffers:
    returns accumulate per env and flush at each done."""
    T, N = rewards.shape
    ret = np.zeros(N)
    length = np.zeros(N, np.int64)
    ep_returns, ep_lens = [], []
    for t in range(T):
        ret += rewards[t]
        length += 1
        done = dones[t] != int(DoneFlags.NULL)
        if done.any():
            ep_returns.extend(ret[done].tolist())
            ep_lens.extend(length[done].tolist())
            ret[done] = 0.0
            length[done] = 0
    return ep_returns, ep_lens


def _write_checkpoint(directory: str, payload: dict) -> None:
    """``torch.save`` into ``directory``, through a temporary file."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{CKPT_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(directory, CKPT_FILE))


class Trainer:
    """``cfg`` is a composed config (``utils.config.load_config``); ``dist``
    this process's place in the data-parallel group (by default a single
    process on ``device``, itself by default the config's ``device`` or
    ``cuda``)."""

    def __init__(self, cfg: Dict, dist: Dist | None = None, device=None):
        self.cfg = cfg
        if dist is None:
            dist = Dist(device=resolve_device(device or cfg.get("device", "cuda")))
        self.dist = dist
        self.device = dist.device
        self.num_envs = int(cfg.get("engine", {}).get("num_envs", 256))
        self.local_envs = dist.shard(self.num_envs).size
        seed = int(cfg.get("seed", 0))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rank_seed(seed, dist.rank))
        self.env = build_env(cfg, device=self.device, dist=dist)
        self.agent = build_agent(cfg, self.env, generator=self.generator, dist=dist)

        # the run-length keys may sit at the top level or in the agent group
        agent_cfg = cfg.get("agent", {}) or {}
        run_key = lambda key, default: agent_cfg.get(key, cfg.get(key, default))
        self.iters_per_output = int(run_key("iters_per_output", 100))
        self.test_episodes = int(run_key("test_episodes", 10))
        self.max_samples = int(run_key("max_samples", 10**14))
        self.debug_nans = bool((cfg.get("debug", {}) or {}).get("nans", False))
        self.video_interval = int(cfg.get("video_interval", 0) or 0)
        self.exp_dir = os.path.join(cfg.get("log_dir", "logs/"), cfg.get("experiment_name", "exp"))
        self.logger = TrainLogger(self.exp_dir, is_main=dist.is_main)
        self.iter = 0

        init = torch.Generator(device=self.device)
        init.manual_seed(seed)
        self.ts = self.agent.init_train_state(init)
        self.es, self.obs = self._reset_all(self.env.init_state(self.local_envs))
        self._maybe_resume()

    def _sync_from_main(self) -> None:
        """Rank 0's train state and ``iter`` on every rank (a copy of the
        state, broadcast tensor by tensor and loaded; the same state at
        one rank)."""
        d = copy.deepcopy(train_state_dict(self.ts))
        for t in state_tensors(d):
            self.dist.broadcast(t)
        self.ts = load_train_state_dict(self.ts, d)
        it = self.dist.broadcast(torch.tensor([self.iter], dtype=torch.int64, device=self.device))
        self.iter = int(it[0])

    def _reset_all(self, es):
        mask = torch.ones(self.local_envs, dtype=torch.bool, device=self.device)
        es = self.env.reset_where(es, mask, self.ts.sampler, generator=self.generator)
        return es, self.env.compute_obs(es)

    # ------------------------------------------------------------ checkpoint

    def _ckpt_dir(self):
        return os.path.abspath(os.path.join(self.exp_dir, "checkpoint"))

    def save(self, path=None, numbered: bool = False):
        """Save ``{train_state, iter}`` into the directory ``path`` (default
        the experiment's ``checkpoint/``).  Every rank calls it; rank 0
        writes and the ranks meet at a barrier, so a rank cannot read a
        checkpoint that is still being written.  ``numbered`` also writes a
        snapshot ``intermediate_outputs/model_<sample count>``."""
        path = path or self._ckpt_dir()
        if self.dist.is_main:
            payload = {"train_state": train_state_dict(self.ts), "iter": self.iter,
                       "optimizer": self.agent.cfg.optimizer}
            _write_checkpoint(path, payload)
            print(f"Saved {path} at iter {self.iter} (state sha256 {state_digest(self.ts)})")
            if numbered:
                samples = int(self.ts.sample_count)
                _write_checkpoint(os.path.abspath(os.path.join(
                    self.exp_dir, "intermediate_outputs", f"model_{samples:012d}")), payload)
        self.dist.barrier()

    def _read(self, path) -> None:
        """This rank's state from a checkpoint directory, local or a
        ``gs://``, ``s3://`` or ``file://`` URI."""
        from add_gym_torch.utils.remote import fetch_dir

        path = fetch_dir(str(path))
        payload = torch.load(os.path.join(path, CKPT_FILE), map_location=self.device,
                             weights_only=True)
        saved, active = payload.get("optimizer", self.agent.cfg.optimizer), self.agent.cfg.optimizer
        if _opt_family(saved) != _opt_family(active):
            raise ValueError(
                f"checkpoint at {path} does not match the configured optimizer '{active}' "
                f"and no adam-family migration applies; set agent.optimizer to the config "
                f"the checkpoint was saved with (it was saved under '{saved}')")
        self.ts = load_train_state_dict(self.ts, payload["train_state"])
        self.iter = int(payload["iter"])
        print(f"Loaded {path} at iter {self.iter} (state sha256 {state_digest(self.ts)})")
        if saved != active:
            print(f"Loaded Adam moments saved under '{saved}' into '{active}' (the same state)")

    def load(self, path):
        """Load a checkpoint (a directory, local or a ``gs://``, ``s3://``
        or ``file://`` URI).  Every rank calls it: rank 0 reads ``path``
        and every rank receives its train state and ``iter``, so the ranks
        go on as one model even where only rank 0 can see the checkpoint.
        ``adam`` and ``fused_adam`` share one Adam state, so a checkpoint
        of either loads under the other; one saved under ``sgd`` loads
        only under ``sgd``, and the other way round (``ValueError``)."""
        if self.dist.is_main:
            self._read(path)
        self._sync_from_main()

    def _maybe_resume(self):
        """The experiment's checkpoint wins (a spot restart); else a
        configured ``resume_path``.  Rank 0 decides and reads, and every
        rank receives its state: with nothing to resume, the parameters
        initialized from the seed (rank 0's copy is the guard)."""
        if self.dist.is_main:
            path = self._ckpt_dir()
            if os.path.exists(os.path.join(path, CKPT_FILE)):
                self._read(path)
                print(f"Resumed from {path} at iter {self.iter}")
            elif self.cfg.get("resume_path"):
                self._read(self.cfg["resume_path"])
                print(f"Resuming from resume_path {self.cfg['resume_path']} at iter {self.iter}")
        self._sync_from_main()

    # ---------------------------------------------------------------- train

    def train(self, max_iters: int | None = None):
        """Train until ``max_samples`` (or ``max_iters``): evaluation and a
        checkpoint every ``iters_per_output`` iterations, metrics every
        ``metrics_every``, a ``torch.profiler`` trace over the ``profile``
        window; a non-finite loss saves a post-mortem into ``crash/`` and
        raises ``FloatingPointError``, and so does, under ``debug.nans``, a
        non-finite output of any phase of an iteration."""
        start = time.time()
        test_info = {}
        samples_per_iter = self.agent.cfg.steps_per_iter * self.num_envs
        metrics_every = max(1, int(self.cfg.get("metrics_every", 1)))
        prof_cfg = self.cfg.get("profile", {}) or {}
        prof_start = int(prof_cfg.get("start_iter", 10)) if prof_cfg else -1
        prof_count = int(prof_cfg.get("num_iters", 3)) if prof_cfg else 0
        prof = None

        samples = int(self.ts.sample_count)
        t_block = time.time()
        last_metrics_iter = self.iter - 1
        while samples < self.max_samples:
            if max_iters is not None and self.iter >= max_iters:
                break
            output_iter = self.iter % self.iters_per_output == 0
            metrics_iter = output_iter or self.iter % metrics_every == 0
            if output_iter and self.test_episodes > 0:
                with trace.span("trainer.evaluate"):
                    test_info = self.evaluate(self.test_episodes)
            if prof_count and self.iter == prof_start:
                prof = self._start_profile()

            t_iter = time.time()
            self.ts, self.es, self.obs, info = self.agent.train_iter(
                self.ts, self.es, self.obs, generator=self.generator,
                hook=nan_check_hook(self.iter) if self.debug_nans else None)
            samples += samples_per_iter

            if prof is not None and self.iter == prof_start + prof_count - 1:
                self._stop_profile(prof, prof_cfg)
                prof = None
            if not metrics_iter:
                self.iter += 1
                continue
            metrics = {k: float(v) for k, v in info.items()}
            span = max(self.iter - last_metrics_iter, 1)
            last_metrics_iter = self.iter
            iter_s = (time.time() - t_block) / span if metrics_every > 1 else time.time() - t_iter
            t_block = time.time()

            # the infos are global, so every rank stops here together
            if not math.isfinite(metrics.get("loss", 0.0)):
                self.save(os.path.abspath(os.path.join(self.exp_dir, "crash")))
                raise FloatingPointError(f"non-finite loss at iter {self.iter}: {metrics}")

            metrics["wall_hours"] = (time.time() - start) / 3600.0
            metrics["iter_seconds"] = iter_s
            metrics["env_steps_per_s"] = samples_per_iter / max(iter_s, 1e-9)
            for k, v in test_info.items():
                metrics[f"test_{k}"] = v
            sample_count = int(self.ts.sample_count)
            self.logger.log(metrics, sample_count)
            if output_iter:
                with trace.span("trainer.save"):
                    self.save(numbered=bool(self.cfg.get("save_intermediate", False)))
                self.logger.log_sampler_image(self.ts.sampler.errors.cpu().numpy(), sample_count)
                outputs = self.iter // self.iters_per_output
                if self.video_interval and outputs % self.video_interval == 0:
                    # every rank rolls forward; rank 0 writes
                    with trace.span("trainer.video"):
                        self.record_video(os.path.join(self.exp_dir,
                                                       f"rollout_{self.iter:07d}.gif"))
            self.iter += 1
        if prof is not None:
            self._stop_profile(prof, prof_cfg)
        self.save()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, prof_cfg):
        """Stop the profiler and export its chrome trace, with the program's
        spans of the window (``utils.trace``) added as complete events on
        the trace's clock, on a track of their own."""
        prof.stop()
        out = prof_cfg.get("dir", os.path.join(self.exp_dir, "profile"))
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_rank{self.dist.rank}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"]
        base = int(doc.get("baseTimeNanoseconds", 0))
        ns = lambda us: base + round(float(us) * 1000)
        anchors = [(ns(e["ts"]), ns(e["ts"]) + round(float(e.get("dur", 0)) * 1000))
                   for e in events if e.get("name") == trace.ANCHOR and "ts" in e]
        spans = trace.place(trace.take(), anchors)
        events.append(dict(ph="M", name="process_name", pid="add_gym_torch spans", tid=0,
                           args=dict(name="add_gym_torch spans")))
        for name, start, end, parent, it in spans:
            events.append(dict(ph="X", cat="program_span", name=name, pid="add_gym_torch spans",
                               tid=0, ts=(start - base) / 1000, dur=(end - start) / 1000,
                               args=dict(parent=parent, iteration=it)))
        with open(path, "w") as f:
            json.dump(doc, f)

    # ----------------------------------------------------------------- video

    def record_video(self, path: str, seconds: float = 4.0):
        """Mean-action rollout of env 0 -> pose dump ``path + ".npz"`` and a
        mesh video at ``path`` (GIF through PIL, MP4 through imageio).

        Every rank runs ``int(seconds / ctrl_dt)`` steps of
        ``ADDAgent.eval_rollout_states`` and keeps the advanced env state,
        so the ranks stay in step.  Rank 0 then runs the forward kinematics
        of the agent and of the ghost (the reference motion at the recorded
        ids and times) on its device and writes the npz (``body_pos``,
        ``body_rot``, ``ghost_body_pos``, ``ghost_body_rot``,
        ``body_names``, ``parents``: the JAX package's keys).  The mesh
        model is read from the MJCF the env was built from
        (``robot.asset_path``).  A failed render prints and falls back to
        the stick figure (``cli.view.render_video``); a failed fallback
        prints too: rendering never stops training, and the npz is the
        contract.

        Returns, on rank 0, ``{"frames", "rollout_ms", "render_ms_per_frame"}``
        (the last None where no video was written); None on other ranks.
        """
        steps = int(seconds / self.env.ctrl_dt)
        t0 = time.perf_counter()
        self.es, self.obs, states = self.agent.eval_rollout_states(
            self.ts, self.es, self.obs, steps, generator=self.generator)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rollout_ms = 1e3 * (time.perf_counter() - t0)
        if not self.dist.is_main:
            return None
        char = self.env.char
        body_pos, body_rot = char.forward_kinematics(
            states["root_pos"], states["root_quat"], char.dof_to_rot(states["dof_pos"]))
        rp, rq, _, _, dp, _ = self.env.motion.get_motion_step(states["motion_id"],
                                                              states["motion_time"])
        ghost_pos, ghost_rot = char.forward_kinematics(rp, rq, char.dof_to_rot(dp))
        poses = {k: v.cpu().numpy() for k, v in dict(
            body_pos=body_pos, body_rot=body_rot, ghost_body_pos=ghost_pos,
            ghost_body_rot=ghost_rot).items()}
        np.savez_compressed(path + ".npz", **poses, body_names=np.asarray(char.body_names),
                            parents=char.parent_indices)
        fps = 1.0 / self.env.ctrl_dt
        t0 = time.perf_counter()
        try:
            from add_gym_torch.render.mesh import RobotMeshModel, render_frames, save_video
            from add_gym_torch.utils.assets import asset_path

            robot_cfg = self.cfg.get("robot", {})
            mm = RobotMeshModel(asset_path(robot_cfg.get("asset_path", "g1_description/g1_29.xml")),
                                list(char.body_names))
            frames = render_frames(mm, poses["body_pos"], poses["body_rot"],
                                   poses["ghost_body_pos"], poses["ghost_body_rot"])
            save_video(frames, path, fps=fps)
        except Exception as e:  # rendering must never stop training
            print(f"mesh render failed ({e!r}); falling back to stick figure")
            try:
                from add_gym_torch.cli.view import render_video

                render_video(char, poses["body_pos"], path, fps=fps)
            except Exception as e2:
                print(f"video render failed: {e2!r}")
        render_ms = 1e3 * (time.perf_counter() - t0)
        written = os.path.exists(path)
        return dict(frames=steps, rollout_ms=rollout_ms,
                    render_ms_per_frame=render_ms / max(steps, 1) if written else None)

    # ----------------------------------------------------------------- eval

    def _all_ranks_done(self, done: bool) -> bool:
        flag = torch.tensor([0.0 if done else 1.0], dtype=torch.float64, device=self.device)
        return float(self.dist.all_reduce_sum(flag)[0]) == 0.0

    def evaluate(self, num_episodes: int) -> Dict:
        """Greedy-policy evaluation.

        Resets every env at entry, so every counted episode starts fresh
        and the statistics do not depend on the training state it
        interrupts; then rolls the mean action in chunks until every env of
        every rank has finished ceil(num_episodes / num_envs) episodes, or
        an episode-length cap.  Episodes still running at the end are not
        counted.  Every rank runs the same number of chunks: a rank whose
        envs are done keeps stepping until all are.  ``mean_return`` and
        ``mean_ep_len`` are means over the episodes of all ranks.

        The post-eval env state carries into training, as in the
        reference; ``eval_isolated: true`` restores the pre-eval state.
        """
        isolated = bool(self.cfg.get("eval_isolated", False))
        es_saved, obs_saved = self.es, self.obs
        min_eps = int(np.ceil(num_episodes / self.num_envs))
        max_ep_steps = int(self.env.task.max_episode_length / self.env.ctrl_dt)
        chunk = max(1, min(256, max_ep_steps))
        max_steps = min_eps * max_ep_steps + chunk
        es, obs = self._reset_all(self.es)

        all_r, all_d = [], []
        eps_per_env = np.zeros(self.local_envs, np.int64)
        steps = 0
        while steps < max_steps and not self._all_ranks_done(bool((eps_per_env >= min_eps).all())):
            es, obs, r, d = self.agent.eval_rollout(self.ts, es, obs, chunk,
                                                    generator=self.generator)
            r, d = r.cpu().numpy(), d.cpu().numpy()
            all_r.append(r)
            all_d.append(d)
            eps_per_env += (d != int(DoneFlags.NULL)).sum(axis=0)
            steps += chunk

        ep_returns, ep_lens = (episode_stats(np.concatenate(all_r), np.concatenate(all_d))
                               if all_r else ([], []))
        if isolated:
            self.es, self.obs = es_saved, obs_saved
        else:
            self.es, self.obs = es, obs
        sums = torch.tensor([np.sum(ep_returns), np.sum(ep_lens), len(ep_returns)],
                            dtype=torch.float64, device=self.device)
        ret_sum, len_sum, n_eps = self.dist.all_reduce_sum(sums).tolist()
        if n_eps == 0:
            return {"mean_return": 0.0, "mean_ep_len": float(steps), "num_eps": 0}
        return {"mean_return": ret_sum / n_eps, "mean_ep_len": len_sum / n_eps,
                "num_eps": int(n_eps)}

    def close(self):
        self.logger.close()
