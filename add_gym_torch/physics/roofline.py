"""The least time the card could take: peaks, and the control-step
kernel's operation and byte counts.

The peaks are NVIDIA's data sheet for the H100 SXM part (dense rates, at
its 700 W power limit), keyed by ``torch.cuda.get_device_name()``; a card
not listed has no peaks, so nothing is divided by a guessed one.  The
counts read the work of one control step off ``csrc/control_step.cuh``:
they count what the step must do, whatever implements it, so a faster
kernel does not move them.  ``chip_smoke.py`` and ``add_gym_torch.bench``
share them.
"""

from __future__ import annotations

H100_SXM = dict(bf16=989e12, f32=67e12, bytes=3.35e12)   # f32 outside the tensor cores
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def device_peaks(device_kind: str):
    """The peak rates of ``device_kind`` (``bf16``, ``f32`` in FLOP/s,
    ``bytes`` in B/s), or None for a card not listed."""
    return PEAKS.get(device_kind)


def control_step_flops(nb: int, nd: int, ncp: int, npair: int, substeps: int,
                       per_env: bool = False, n_np: int = 0) -> int:
    """f32 operations per env of one control step, counted from
    csrc/control_step.cuh (a fused multiply-add counts as 2, a sqrt, a
    division or a transcendental as 1).  The per-env variant adds the mass
    scale's products: per body and substep the contact sum, the two summed
    wrenches (6), the A, B and D blocks (9 + 9 + 1) and the bias forces
    (6).  The narrowphase rows add 6 additions per touched body."""
    fk = 45 + (nb - 1) * 134            # root rotation + per-joint FK and velocities
    contact = ncp * 63                  # per point: frame, velocity, normal, friction, torque
    pass1 = nb * 177                    # body velocities, bias forces, external forces
    torque = nd * 20                    # PD, damping, friction, limit springs
    pass2 = (nb - 1) * 728              # U, D, projected inertia, sandwiches, parent updates
    solve6 = 250                        # 6x6 Cholesky + two triangular solves
    pass3 = (nb - 1) * 77               # accelerations, qdd, joint integration
    root = 120                          # root integration + quaternion update
    substep = fk + contact + pass1 + torque + pass2 + solve6 + pass3 + root
    held_sc = fk + npair * 80           # FK of the input state + sphere pairs
    pd = nd * 6                         # target clamp + slew limit
    if per_env:
        substep += nb * 32
    return substeps * substep + held_sc + pd + 6 * n_np


def control_step_bytes(fbuf, ibuf, n: int, nb: int, nd: int, per_env: bool = False,
                       n_np: int = 0) -> int:
    """Bytes one launch must move: the input block (13 + 4 nd rows, plus
    2 nd + 2 per-env rows and 6 n_np narrowphase rows), the output block
    (13 + 3 nd + nb rows) and the model buffers, each once."""
    rows_in = 13 + 4 * nd + (2 * nd + 2 if per_env else 0) + 6 * n_np
    return 4 * n * (rows_in + 13 + 3 * nd + nb) + fbuf.nbytes + ibuf.nbytes


def control_step_bound(fbuf, ibuf, counts, n: int, per_env: bool = False):
    """(bound ms, bound by) of one launch over n envs at the H100's peaks;
    ``fbuf, ibuf, counts`` are ``cuda_step.pack_model``'s."""
    nb, nd, ncp, nsph, npair, substeps, n_np = counts
    flops = control_step_flops(nb, nd, ncp, npair, substeps, per_env=per_env, n_np=n_np) * n
    io_bytes = control_step_bytes(fbuf, ibuf, n, nb, nd, per_env=per_env, n_np=n_np)
    ops_s, bytes_s = flops / H100_SXM["f32"], io_bytes / H100_SXM["bytes"]
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"
