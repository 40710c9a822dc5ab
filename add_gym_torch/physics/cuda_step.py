"""Physics control step through the hand-written CUDA kernel.

Counterpart of ``add_gym_tpu/physics/pallas_step.py``: :func:`cuda_step`
has the contract of ``pallas_step`` / ``fused_step`` (state in, state and
last-substep contact out, ``[N, ...]`` layouts).  For tensors on a CUDA
device it launches ``agt_control_step_kernel`` (``csrc/control_step.cu``,
one warp per env; the per-env step in ``csrc/control_step.cuh``) and
raises if the launch fails;
for CPU tensors it runs the plain version, ``fused_step.fused_step``.
The kernel has one instance per body capacity (:data:`INSTANCES`); a
model goes to the narrowest that holds its bodies (:func:`instance`), and
one past the widest is refused.
Parameters with per-env leaves (domain randomization: ``kp``/``kv``
``[N, nd]``, ``friction_mu`` ``[N]``, a mass scale) go to the kernel's
per-env variant, the rest to its main variant; each counts its launches.
A model with narrowphase tables (``model.attach_geoms``) sends the held
narrowphase wrenches of ``fused_step.compute_np_ext`` into either variant
as ``6 * n_np`` extra input rows, counted as well.
:func:`sharded_cuda_step`, the counterpart of ``sharded_pallas_step``,
launches the same kernel on one data-parallel rank's shard of the envs.

The kernel is built at first use with ``nvcc`` into a shared library with a
plain C interface under ``build/add_gym_torch/`` beside the package (the
file name carries a hash of the sources and flags, so an edit rebuilds),
and is bound with ``ctypes``.  Model constants travel as two packed device
buffers (:func:`pack_model`), cached per model and shared parameters;
the per-env state crosses in one env-minor ``[13 + 4 nd, N]`` block (the
per-env variant appends ``kp``/``kv`` ``[nd]``, ``mu`` and ``ms`` rows:
``[15 + 6 nd, N]``, so per-env values never enter the cached buffers; the
narrowphase rows come last) and comes back in one ``[13 + 3 nd + nb, N]``
block.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np
import torch

from add_gym_torch.physics.engine import EngineParams, SimState, is_per_env, mass_scale_or_none
from add_gym_torch.physics.fused_step import (
    FusedModelConstants, compute_np_ext, fused_step, np_rows, shard_params, sharded_fused_step,
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "add_gym_torch")
SOURCES = ("control_step.cu", "control_step.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# buffer layout: keep in step with the AGT_* constants in control_step.cuh
HDR, BODY, DOF, PT, SPH, PAIR = 8, 52, 7, 7, 4, 3
# the body capacities of the kernel's instances, narrowest first: keep in
# step with AgtShape in control_step.cu
INSTANCES = (32, 48)

_lib = None


def _nvcc() -> str:
    # torch resolves the toolkit from $CUDA_HOME / $CUDA_PATH, nvcc on PATH,
    # or the default install location
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libagt_control_step_{h.hexdigest()[:16]}.so")


def build_library() -> dict:
    """Compile the kernel library if it is not built yet.

    Returns {"path", "seconds", "log"}; ``log`` holds ptxas's register and
    spill report of a fresh build.  Raises if nvcc fails.
    """
    path = library_path()
    if os.path.exists(path):
        return dict(path=path, seconds=0.0, log="")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, "control_step.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return dict(path=path, seconds=seconds, log=proc.stdout + proc.stderr)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library()["path"])
        for fn in (lib.agt_control_step, lib.agt_control_step_dr):
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ]
        lib.agt_kernel_info.restype = ctypes.c_int
        lib.agt_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def instance(nb: int) -> int:
    """The body capacity of the kernel instance that steps a model of
    ``nb`` bodies: the narrowest of :data:`INSTANCES` that holds them.
    Raises ValueError past the widest."""
    for cap in INSTANCES:
        if nb <= cap:
            return cap
    raise ValueError(f"model has {nb} bodies; the kernel takes at most {INSTANCES[-1]}")


def kernel_info(per_env: bool = False, capacity: int = INSTANCES[0]) -> dict:
    """The launch shape of the main or per-env variant of the instance of
    body capacity ``capacity`` on the current CUDA device: envs (warps) a
    block, dynamic shared memory bytes a block, blocks resident per SM,
    registers a thread, and envs resident per SM."""
    info = (ctypes.c_int * 4)()
    rc = _library().agt_kernel_info(int(capacity), int(per_env), info)
    if rc != 0:
        raise RuntimeError(f"control step kernel attributes ({capacity} bodies): CUDA error {rc}")
    return dict(capacity=capacity, envs_per_block=info[0], shared_bytes=info[1],
                blocks_per_sm=info[2], registers=info[3], envs_per_sm=info[0] * info[2])


def tree_tables(parent):
    """(depth [nb], children [nb]) of a tree given by ``parent`` (parent[i] <
    i, parent[0] = -1): each body's depth, and a 64-bit mask of its
    children (bit c set when parent[c] = i, as u64; at most 64 bodies)."""
    parent = np.asarray(parent)
    nb = len(parent)
    if nb > 64:
        raise ValueError(f"model has {nb} bodies; the child masks take at most 64")
    depth = np.zeros(nb, np.int64)
    children = np.zeros(nb, np.uint64)
    for i in range(1, nb):
        p = int(parent[i])
        if not 0 <= p < i:
            raise ValueError(f"body {i} has parent {p}: parents must come first")
        depth[i] = depth[p] + 1
        children[p] |= np.uint64(1) << np.uint64(i)
    return depth, children


def pack_model(fc: FusedModelConstants, params: EngineParams, per_env: bool | None = None):
    """Host buffers of the kernel's model constants.

    Returns (fbuf f32, ibuf i32, counts) with counts = (nb, nd, ncp, nsph,
    npair, substeps, n_np); the layout is documented in control_step.cuh
    (f32 sections field-major; i32 parent, depth + the tree's depth, bits
    0-31 of the child masks, contact-point CSR, spheres, pairs, bits 32-63
    of the child masks, narrowphase bodies).  For
    the per-env variant (``per_env``, by default ``is_per_env(params)``)
    the shared kp/kv/mu slots hold 0: it reads them from its input block.
    """
    nb, nd = fc.nb, fc.nd
    dt = params.ctrl_dt / params.substeps
    if per_env is None:
        per_env = is_per_env(params)
    mu = 0.0 if per_env else float(params.friction_mu)
    hdr = np.array([dt, params.max_torque, params.position_limit_margin,
                    params.max_target_delta, mu, params.gravity, 0.0, 0.0])
    body = np.concatenate(
        [fc.C0.reshape(nb, 9), fc.C1.reshape(nb, 9), fc.C2.reshape(nb, 9), fc.r, fc.axis,
         fc.IA_A.reshape(nb, 9), fc.IA_B.reshape(nb, 9), fc.mass[:, None]], axis=1,
    )
    if per_env:
        kp = kv = np.zeros(nd)
    else:
        kp = torch.as_tensor(params.kp).detach().cpu().numpy().astype(np.float64)
        kv = torch.as_tensor(params.kv).detach().cpu().numpy().astype(np.float64)
    dof = np.stack([fc.armature, fc.damping, fc.friction, fc.lo, fc.hi, kp, kv], axis=1)
    k, b, stick = fc.contact_gains(params, dt)
    pt = np.concatenate(
        [fc.cp_pos, fc.cp_radius[:, None], k[:, None], b[:, None], stick[:, None]], axis=1
    )
    sph = np.concatenate([fc.sc_pos, fc.sc_radius[:, None]], axis=1)
    pairs = fc.sc_pairs if params.self_collision else fc.sc_pairs[:0]
    k_sc, b_sc = fc.sc_gains(params, dt)
    rsum = fc.sc_radius[pairs[:, 0]] + fc.sc_radius[pairs[:, 1]]
    pair = np.stack([rsum, k_sc[: len(pairs)], b_sc[: len(pairs)]], axis=1)
    assert body.shape[1] == BODY and dof.shape[1] == DOF and pt.shape[1] == PT
    # field-major sections: a warp's lanes read one constant of 32 bodies
    fbuf = np.concatenate(
        [hdr, body.T.ravel(), dof.T.ravel(), pt.T.ravel(), sph.T.ravel(), pair.T.ravel()]
    ).astype(np.float32)
    depth, children = tree_tables(fc.parent)
    lo, hi = ((w.astype(np.uint32).view(np.int32))
              for w in (children & np.uint64(0xFFFFFFFF), children >> np.uint64(32)))
    cp_start = np.searchsorted(fc.cp_body, np.arange(nb + 1))
    ibuf = np.concatenate(
        [fc.parent, depth, [depth.max()], lo, cp_start, fc.sc_body, pairs.ravel(), hi,
         fc.np_bodies]
    ).astype(np.int32)
    counts = (nb, nd, len(fc.cp_body), len(fc.sc_body), len(pairs), int(params.substeps),
              len(fc.np_bodies))
    return fbuf, ibuf, counts


def _model_tag(params: EngineParams, per_env: bool):
    """What the packed buffers depend on: the scalar fields, and for shared
    parameters the gain tensors (by identity) and the friction."""
    scalars = (params.ctrl_dt, params.substeps, params.max_torque, params.max_target_delta,
               params.position_limit_margin, params.contact_timeconst,
               params.contact_dampratio, params.gravity, params.self_collision)
    if per_env:
        return scalars, None, None, None
    return scalars, params.kp, params.kv, float(params.friction_mu)


def _device_model(fc: FusedModelConstants, params: EngineParams, device, per_env: bool):
    """Packed model buffers on ``device``, cached on ``fc``.  Per-env
    parameters, new at every step, share one entry per scalar fields."""
    key = ("cuda_pack", torch.device(device))
    tag = _model_tag(params, per_env)
    hit = fc._dev.get(key)
    if (hit is None or hit[0][0] != tag[0] or hit[0][1] is not tag[1]
            or hit[0][2] is not tag[2] or hit[0][3] != tag[3]):
        fbuf, ibuf, counts = pack_model(fc, params, per_env)
        hit = (
            tag,
            torch.as_tensor(fbuf, device=device),
            torch.as_tensor(ibuf, device=device),
            counts,
        )
        fc._dev[key] = hit
    return hit[1:]


def per_env_rows(params: EngineParams, n: int, nd: int, device):
    """The per-env variant's extra input rows [2 nd + 2, N]: kp, kv, mu, ms
    (shared values broadcast over the envs, ms = 1 without a mass scale).
    A Python number becomes its rows on the device directly (a fill, no
    copy from the host: a CUDA graph can capture it)."""
    def rows(x, k):
        if isinstance(x, (int, float)):
            return torch.full((k, n), float(x), dtype=torch.float32, device=device)
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if x.ndim == 2:                      # per-env gains [N, nd]
            return x.T
        return x.reshape(k, -1).expand(k, n)  # [k] / [N] / scalar

    ms = mass_scale_or_none(params)
    return torch.cat([
        rows(params.kp, nd), rows(params.kv, nd), rows(params.friction_mu, 1),
        rows(1.0 if ms is None else ms, 1),
    ], dim=0)


def pack_state(state: SimState, pd_target, params: EngineParams | None = None,
               per_env: bool | None = None, np_ext=None):
    """Env-minor input block (f32, contiguous): [13 + 4 nd, N], or for the
    per-env variant [15 + 6 nd, N] with ``params``' rows appended, then the
    held narrowphase wrenches ``np_ext`` (``fused_step.compute_np_ext``) as
    ``6 * len(np_ext)`` rows.  ``per_env`` defaults to
    ``is_per_env(params)``."""
    rows = [state.root_pos.T, state.root_quat.T, state.root_vel.T, state.root_ang_vel.T,
            state.dof_pos.T, state.dof_vel.T, state.pd_target.T, pd_target.T]
    if per_env is None:
        per_env = params is not None and is_per_env(params)
    if per_env:
        n, nd = state.dof_pos.shape
        rows.append(per_env_rows(params, n, nd, state.root_pos.device))
    if np_ext is not None:
        rows.append(np_rows(np_ext))
    return torch.cat(rows, dim=0).contiguous()


def unpack_state(out, nd: int):
    """Split the env-minor output block into (SimState, contact [N, nb])."""
    rows = torch.split(out, [3, 4, 3, 3, nd, nd, nd, out.shape[0] - 13 - 3 * nd], dim=0)
    rp, rq, rv, ra, q, qd, tgt, contact = (r.T for r in rows)
    state = SimState(root_pos=rp, root_quat=rq, root_vel=rv, root_ang_vel=ra,
                     dof_pos=q, dof_vel=qd, pd_target=tgt)
    return state, contact


def launch_control_step(fc: FusedModelConstants, params: EngineParams, inp,
                        per_env: bool | None = None):
    """Launch the kernel on an env-minor input block; returns the output block.

    ``per_env`` (by default ``is_per_env(params)``) picks the variant:
    ``inp`` is a contiguous f32 CUDA tensor (see :func:`pack_state`) of
    [13 + 4 nd, N] rows for the main variant, [15 + 6 nd, N] for the
    per-env one, each plus 6 narrowphase rows per body of ``fc.np_bodies``.
    Launches the instance :func:`instance` picks on the current stream;
    raises past the widest instance, or if the launch fails.  Does not
    count launches (see :func:`cuda_step`).
    """
    if not inp.is_cuda or inp.dtype != torch.float32 or not inp.is_contiguous():
        raise ValueError("control step kernel takes a contiguous f32 CUDA tensor")
    nb, nd = fc.nb, fc.nd
    if per_env is None:
        per_env = is_per_env(params)
    want = (15 + 6 * nd if per_env else 13 + 4 * nd) + 6 * len(fc.np_bodies)
    if inp.shape[0] != want:
        raise ValueError(f"input block has {inp.shape[0]} rows, expected {want}")
    cap = instance(nb)
    lib = _library()
    launch = lib.agt_control_step_dr if per_env else lib.agt_control_step
    n = inp.shape[1]
    fbuf, ibuf, counts = _device_model(fc, params, inp.device, per_env)
    out = torch.empty((13 + 3 * nd + nb, n), dtype=torch.float32, device=inp.device)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        rc = launch(
            cap, fbuf.data_ptr(), ibuf.data_ptr(), *counts, inp.data_ptr(), out.data_ptr(), n,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"control step kernel launch failed: CUDA error {rc}")
    return out


def cuda_step(fc: FusedModelConstants, params: EngineParams, state: SimState, pd_target):
    """Control step with the contract of ``fused_step`` / ``pallas_step``.

    CUDA tensors go through the kernel: shared parameters through the main
    variant (``cuda_step.launches`` counts its launches), per-env ones
    through the per-env variant (``cuda_step.dr_launches``); a launch with
    narrowphase rows counts in ``cuda_step.np_launches`` too, and one of an
    instance wider than the narrowest (a model of more than 32 bodies) in
    ``cuda_step.wide_launches``.  CPU tensors go through the plain version.
    """
    if not state.root_pos.is_cuda:
        return fused_step(fc, params, state, pd_target)
    per_env = is_per_env(params)
    np_ext = compute_np_ext(fc, params, params.ctrl_dt / params.substeps, state)
    inp = pack_state(state, pd_target, params, per_env, np_ext)
    out = launch_control_step(fc, params, inp, per_env)
    if per_env:
        cuda_step.dr_launches += 1
    else:
        cuda_step.launches += 1
    if np_ext is not None:
        cuda_step.np_launches += 1
    if fc.nb > INSTANCES[0]:
        cuda_step.wide_launches += 1
    return unpack_state(out, fc.nd)


cuda_step.launches = 0
cuda_step.dr_launches = 0
cuda_step.np_launches = 0
cuda_step.wide_launches = 0


def sharded_cuda_step(fc: FusedModelConstants, params: EngineParams, state: SimState,
                      pd_target, shard):
    """The control step on one rank's envs: the counterpart of the JAX
    package's ``sharded_pallas_step`` (a ``shard_map`` of the Pallas kernel
    over the env axis).

    ``shard`` (``parallel.mesh.EnvShard``) names the rank's envs; ``state``
    and ``pd_target`` hold only those.  Per-env parameter leaves of the
    global env count are sliced to the shard and shared ones pass whole
    (``fused_step.shard_params``; the env passes leaves already of the
    local size, drawn for its shard); the narrowphase rows come from the
    local state.  The step adds no arithmetic and no collective: each rank
    launches the same kernel (:func:`cuda_step`, main or per-env variant,
    with or without narrowphase rows) on its local ``[rows, N_local]``
    block, on its device's current stream, counted in
    ``sharded_cuda_step.launches`` as well as in ``cuda_step``'s counts.
    CPU tensors go through the plain version, ``fused_step.sharded_fused_step``.
    """
    if not state.root_pos.is_cuda:
        return sharded_fused_step(fc, params, state, pd_target, shard)
    out = cuda_step(fc, shard_params(params, shard), state, pd_target)
    sharded_cuda_step.launches += 1
    return out


sharded_cuda_step.launches = 0
