"""Readings that set the check's limits, on the card at a cell's own size.

    python -m port_bench.control --workload <name> --seeds 11 12 13 [--what sound tf32 ...]

For each seed and each of ``--what`` it runs set-up as the benchmark does
(the followed iterations, no measured window) and lets the reference
follow, then prints one JSON line of every number the check can compare:

* ``sound``: the program as it is (the lower readings);
* ``tf32``: the control of the learning, the program with its own TF32
  path switched on (``torch.backends.cuda.matmul.allow_tf32``): the f32
  disc and heads in TF32, the precision next below the configuration's
  f32 with TF32 off;
* ``physics_bf16``: the control of the physics, each control step's
  state as the program returns it rounded to bf16, the precision next
  below the kernel's f32;
* each fault of ``faults.py``, planted in the program.

The benchmark's own runs do not run it.  Lines go to standard output and
to ``--out`` (default ``chiprun_out/port_bench_control.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import fields, replace

from port_bench import faults, run, spec


def physics_bf16(env, agent):
    """Every float field of the state each control step returns, rounded
    to bf16 and back."""
    import torch

    step = env._step_fn

    def step_fn(params, sim, pd_target):
        sim, contact = step(params, sim, pd_target)
        rounded = {f.name: getattr(sim, f.name).to(torch.bfloat16).to(torch.float32)
                   for f in fields(sim) if getattr(sim, f.name).is_floating_point()}
        return replace(sim, **rounded), contact

    env._step_fn = step_fn


CONTROLS = dict(tf32=None, physics_bf16=physics_bf16)
PLANTS = dict(CONTROLS, **faults.FAULTS)


def reading(cell, seed, what, device):
    import torch

    run.set_tf32(what == "tf32")
    sess, cfg, followed = run.set_up(cell, seed, device, plant=PLANTS.get(what))
    del sess
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    run.set_tf32(False)
    return run.follow(cfg, device, followed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["sound", "tf32"], choices=["sound", *PLANTS])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "port_bench_control.jsonl"))
    args = ap.parse_args(argv)
    run.cache_env(spec.ROOT)
    cell = spec.workload(args.workload)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        for what in args.what:
            t0 = time.perf_counter()
            numbers = reading(cell, seed, what, args.device)
            line = json.dumps(dict(workload=args.workload, seed=seed, what=what,
                                   seconds=time.perf_counter() - t0, **numbers))
            print(line, flush=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
