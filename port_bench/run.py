"""One run of one cell of the port's benchmark.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up writes the inputs (the robot the configuration names, by
default the G1-shaped fixture, and a synthetic clip from the seed),
builds the program's env and agent on the composed config (the
control-step kernel is built with nvcc into ``build/add_gym_torch``
at first use, and kept there), hands it the initial weights drawn from the
seed and drives it through the iterations the reference follows, the
first of which warms up every shape the window uses.  The window then
calls ``train_iter`` for ``--seconds``; with ``--trace 1`` under
``torch.profiler``.  Afterwards the program is freed and the reference
follows the recorded iterations (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (iterations in the window), ``failed`` (those with a
non-finite info), ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones, each read by ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, as the last lines of standard error
give them too.  It exits non-zero and prints no result without enough
CUDA devices, or where JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import importlib     # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import sys           # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "add_gym_tpu")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Top-level names of ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root: str) -> None:
    """The program's build and kernel caches at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    cache = os.path.join(root, "build", "port_bench", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def read_metric(name: str, ctx: dict):
    return importlib.import_module(f"port_bench.metrics.{name}").read(ctx)


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def set_up(cell: dict, seed: int, device: str, plant=None, build=None):
    """The session after the followed iterations, and what the reference
    follows them by: (session, cfg, followed = dict(recs, prog_params,
    weights))."""
    from port_bench import check, session, spec

    files = os.path.join(spec.ROOT, "build", "port_bench", "inputs")
    mjcf, clip = spec.write_inputs(cell, files, seed)
    cfg = spec.compose(cell, mjcf, clip, seed)
    sess = session.Session(cfg, seed, device, plant=plant, build=build)
    log(f"built env and agent: {sess.num_envs} envs, {sess.steps} steps an iteration, "
        f"kernel {getattr(sess.env, 'kernel', None)}")
    chk = cell["traffic"]["check"]
    recs = []
    for k in range(int(chk["iterations"])):
        keep = check.kept_steps(seed, k, sess.steps, int(chk["control_steps"]))
        recs.append(sess.followed_iteration(keep))
        log(f"followed iteration {k + 1} done")
    followed = dict(recs=recs, prog_params=sess.params_host(),
                    weights={n: w.cpu() for n, w in sess.weights.items()})
    return sess, cfg, followed


def follow(cfg: dict, device: str, followed: dict) -> dict:
    from port_bench import check

    t0 = time.perf_counter()
    numbers = check.follow(cfg, device, followed["weights"], followed["recs"],
                           followed["prog_params"], log=log)
    log(f"reference followed {len(followed['recs'])} iterations in {time.perf_counter() - t0:.1f} s")
    log("numbers " + json.dumps(numbers))
    return numbers


def measure(cell: dict, seed: int, seconds: float, trace: bool, device: str, plant=None) -> dict:
    """Set-up, the window and the check of one run; returns the context the
    metric readers take, with ``numbers`` (the compared numbers)."""
    import torch

    cuda = device.startswith("cuda")
    if cuda:
        set_tf32(False)                 # the disc is f32 with TF32 off
    sess, cfg, followed = set_up(cell, seed, device, plant)

    from add_gym_torch.physics import cuda_step as cs
    launches0 = (cs.cuda_step.launches, cs.cuda_step.dr_launches)
    hook = traced = None
    if trace:
        from port_bench import trace as tr
        hook = tr.PhaseHook()
        traced = tr.TracedWindow()
        traced.__enter__()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    def on_start():
        if traced is not None:
            traced.mark("window_start")

    iters, window_s, infos = sess.window(seconds, hook=hook, on_start=on_start,
                                         before=hook.start if hook is not None else None)
    if traced is not None:
        traced.mark("window_end")
        traced.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    launches = (cs.cuda_step.launches - launches0[0], cs.cuda_step.dr_launches - launches0[1])
    failed = sum(1 for info in infos
                 if not all(bool(torch.isfinite(v).all()) for v in info.values()))
    log(f"window: {iters} iterations in {window_s:.3f} s, peak {peak} B, launches {launches}")
    if sess.iter_ms:
        log("iteration ms (device timeline): " + " ".join(f"{x:.1f}" for x in sess.iter_ms))
    ctx = dict(cfg=cfg, cell=cell, traced=trace, iterations=iters,
               window_s=window_s, setup_s=setup_s, peak_bytes=peak,
               env_steps=iters * sess.steps * sess.num_envs, launches=launches,
               num_envs=sess.num_envs, steps=sess.steps, per_env=bool(sess.env.dr.enabled),
               device_kind=torch.cuda.get_device_name() if cuda else "cpu", failed=failed)
    if hook is not None:
        ctx["phase_ms"] = hook.phase_ms()
        t0 = time.perf_counter()
        ctx["trace"] = traced.read()
        log(f"trace read: {len(ctx['trace']['device'])} device ops, "
            f"{len(ctx['trace']['host'])} host ops in {time.perf_counter() - t0:.1f} s")
    del sess, infos, hook, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx["numbers"] = follow(cfg, device, followed)
    ctx["model_counts"] = _model_counts(cfg)
    return ctx


def _model_counts(cfg):
    """The kernel's bound's counts from the reference's own model of the
    fixture."""
    from port_bench import ceiling
    from port_bench.reference.builder import build_env as ref_build_env

    env = ref_build_env(cfg, device="cpu")
    return dict(counts=ceiling.model_counts(env.model, env.params.substeps,
                                            env.params.self_collision),
                obs_dim=env.obs_dim(), disc_obs_dim=env.disc_obs_dim(), num_dofs=env.num_dofs)


def result(ctx: dict, names: list) -> dict:
    from port_bench import check

    metrics = {}
    for name in names:
        got = read_metric(name, ctx)
        if got is not None:
            metrics[name] = got
    ok, checks = check.judge(ctx.get("numbers", {}), ctx["cell"]["limits"])
    out = dict(correct=bool(ok and ctx["failed"] == 0), attempted=ctx["iterations"],
               failed=ctx["failed"], metrics=metrics,
               device=dict(platform="gpu" if ctx["device_kind"] != "cpu" else "cpu",
                           kind=ctx["device_kind"], count=1, memory_peak_bytes=ctx["peak_bytes"]))
    if ctx["traced"]:
        from port_bench import breakdown
        out["device"].update(breakdown.busy(ctx))
        out["breakdown"] = breakdown.breakdown(ctx)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache_env(root)

    from port_bench import spec

    bench = spec.benchmark(root)
    cell = spec.workload(args.workload, bench)
    chips = int(cell["entry"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s): cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    import add_gym_torch

    if os.path.commonpath([os.path.abspath(add_gym_torch.__file__), root]) != root:
        log(f"add_gym_torch comes from {add_gym_torch.__file__}, outside the checkout {root}")
        return 2
    names = spec.metric_names(bench, args.workload, bool(args.trace))
    ctx = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    out = result(ctx, names)
    forbidden = loaded_forbidden()
    if forbidden:
        log(f"JAX or the JAX package is loaded: {forbidden}")
        return 3
    for name, (value, limit) in out["checks"].items():
        log(f"check {name}: {value!r} limit {limit!r}")
    import resource

    log(f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    log(f"correct {out['correct']}, attempted {out['attempted']}, failed {out['failed']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
