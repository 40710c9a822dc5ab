"""One rank of the port's data-parallel CPU tests (tests/test_torch_distributed.py).

    python tests/torch_distributed_worker.py <mode> <rank> <world> <port> <dir>

Joins a gloo process group on ``localhost:<port>`` through
``parallel.mesh.initialize_distributed`` (the variables
``torch.distributed.run`` would set) and runs one mode on the CPU:

* ``train_iter``: reads ``<dir>/inputs.pt`` (the config, the global reset
  and rollout draws, each rank's minibatch permutations and the starting
  train state), resets this rank's shard of the envs with its slice of the
  draws, runs one ``train_iter`` and writes ``<dir>/result_<rank>.pt``.
* ``resume``: a ``Trainer`` on the config of ``<dir>/inputs.pt`` trains 2
  iterations and saves; a second ``Trainer`` on the same experiment
  directory resumes and trains to 3 iterations; a third resumes where only
  rank 0's ``log_dir`` holds the checkpoint; writes
  ``<dir>/result_<rank>.pt``.

Imports nothing of JAX.
"""

import dataclasses
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from add_gym_torch.builder import build_agent, build_env  # noqa: E402
from add_gym_torch.learning.add_agent import (  # noqa: E402
    load_train_state_dict, state_digest, train_state_dict,
)
from add_gym_torch.learning.runner import Trainer  # noqa: E402
from add_gym_torch.parallel.mesh import initialize_distributed  # noqa: E402


def run_train_iter(dist, inp):
    cfg = inp["cfg"]
    env = build_env(cfg, device="cpu", dist=dist)
    agent = build_agent(cfg, env, dist=dist)
    sl = env.shard.slice
    ts = load_train_state_dict(agent.init_train_state(), inp["train_state"])
    n = env.shard.size
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool), ts.sampler,
                         draws=(inp["reset_ids"][sl], inp["reset_times"][sl]))
    es = dataclasses.replace(es, time=inp["ep_time"][sl])
    obs = env.compute_obs(es)
    draws = tuple(x[:, sl] for x in inp["draws"])
    ts, es, obs, info = agent.train_iter(ts, es, obs, draws=draws, perms=inp["perms"][dist.rank])
    return dict(train_state=train_state_dict(ts), info=info, obs=obs,
                motion_ids=es.motion_ids, hash=state_digest(ts))


def run_resume(dist, inp):
    cfg = inp["cfg"]
    t1 = Trainer(cfg, dist=dist)
    t1.train(max_iters=2)
    saved = state_digest(t1.ts)
    samples_run1 = int(t1.ts.sample_count)
    t2 = Trainer(cfg, dist=dist)           # the experiment's checkpoint wins
    out = dict(samples_run1=samples_run1, resumed_iter=t2.iter,
               samples_resumed=int(t2.ts.sample_count), resume_bitwise=state_digest(t2.ts) == saved)
    t2.train(max_iters=3)
    out.update(samples_final=int(t2.ts.sample_count), hash=state_digest(t2.ts))
    # only rank 0 sees the checkpoint: the other ranks' log_dir is empty
    own = cfg if dist.rank == 0 else dict(cfg, log_dir=os.path.join(cfg["log_dir"], f"rank{dist.rank}"))
    t3 = Trainer(own, dist=dist)
    out.update(rank0_only_iter=t3.iter, rank0_only_hash=state_digest(t3.ts))
    return out


def main():
    mode, rank, world, port, out_dir = sys.argv[1:6]
    os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=world, MASTER_ADDR="localhost",
                      MASTER_PORT=port)
    torch.set_num_threads(1)
    dist = initialize_distributed("cpu")
    try:
        inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
        result = dict(train_iter=run_train_iter, resume=run_resume)[mode](dist, inp)
        result.update(rank=dist.rank, world_size=dist.world_size)
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
    finally:
        dist.close()


if __name__ == "__main__":
    main()
