"""The yardstick: the card's peaks and the operations of one training
iteration, counted from shapes.

A frozen copy of the port's ``bench.trunk_flops`` / ``derived_ceiling`` and
``physics/roofline.py`` at the commit that added this benchmark, so that a
later change to the program cannot move it.  The peaks are NVIDIA's data
sheet for the H100 SXM part (dense rates at its 700 W limit), keyed by
``torch.cuda.get_device_name()``.  Each trunk's matmul operations are
divided by the peak of the precision it runs in (bf16 actor and critic
under ``mixed_precision``; the disc in f32 with TF32 off, or bf16 under
``disc_mixed_precision``), and the physics term is T launches of the
control-step kernel's bound by operations, so the same work reads the same
whatever implements it.
"""

from __future__ import annotations

H100_SXM = dict(bf16=989e12, f32=67e12, bytes=3.35e12)   # f32 outside the tensor cores
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}

# hidden layer sizes of the trunks the configurations name
NET_WIDTHS = {
    "fc_2layers_1024units": (1024, 512),
    "fc_3layers_1024units": (1024, 1024, 512),
}


def device_peaks(device_kind: str):
    """The peak rates of ``device_kind`` (``bf16``, ``f32`` in FLOP/s,
    ``bytes`` in B/s), or None for a card not listed."""
    return PEAKS.get(device_kind)


def matmul_params(in_dim: int, widths, out_dim: int) -> int:
    """The sum of in x out over an MLP's layers."""
    tot, d = 0, in_dim
    for w in widths:
        tot, d = tot + d * w, w
    return tot + d * out_dim


def trunk_params(agent_cfg: dict, obs_dim: int, disc_obs_dim: int, num_dofs: int) -> dict:
    return dict(
        actor=matmul_params(obs_dim, NET_WIDTHS[agent_cfg["actor_net"]], num_dofs),
        critic=matmul_params(obs_dim, NET_WIDTHS[agent_cfg["critic_net"]], 1),
        disc=matmul_params(disc_obs_dim, NET_WIDTHS[agent_cfg["disc_net"]], 1),
    )


def trunk_precisions(agent_cfg: dict) -> dict:
    mixed = "bf16" if agent_cfg.get("mixed_precision", False) else "f32"
    return dict(actor=mixed, critic=mixed,
                disc="bf16" if agent_cfg.get("disc_mixed_precision", False) else "f32")


def trunk_flops(agent_cfg: dict, params: dict, num_envs: int) -> dict:
    """Matmul operations of one iteration by trunk over M = T x N samples:
    the update's epochs x M x [6 (Pa + Pc) + 12 Pd] (forward 2P and
    backward 4P a trunk, the disc twice for the gradient penalty's double
    backward), the rollout's actor M x 2 Pa and the data build's
    M x (4 Pc + 2 Pd)."""
    m, e = int(agent_cfg["steps_per_iter"]) * num_envs, int(agent_cfg["update_epochs"])
    pa, pc, pd = params["actor"], params["critic"], params["disc"]
    return dict(actor=e * m * 6 * pa + m * 2 * pa,
                critic=e * m * 6 * pc + m * 4 * pc,
                disc=e * m * 12 * pd + m * 2 * pd)


def derived_ceiling(agent_cfg: dict, params: dict, num_envs: int, peaks: dict,
                    phys_ms_per_step: float):
    """(env-steps/s, seconds, seconds by term) of one iteration at
    ``peaks``: each precision's matmul time and ``physics``, T control
    steps of ``phys_ms_per_step``."""
    prec = trunk_precisions(agent_cfg)
    terms = {}
    for trunk, flops in trunk_flops(agent_cfg, params, num_envs).items():
        terms[prec[trunk]] = terms.get(prec[trunk], 0.0) + flops / peaks[prec[trunk]]
    steps = int(agent_cfg["steps_per_iter"])
    terms["physics"] = steps * phys_ms_per_step * 1e-3
    floor_s = sum(terms.values())
    return steps * num_envs / floor_s, floor_s, terms


def control_step_flops(nb: int, nd: int, ncp: int, npair: int, substeps: int,
                       per_env: bool = False, n_np: int = 0) -> int:
    """f32 operations per env of one control step, counted from the
    kernel's step (a fused multiply-add counts as 2, a sqrt, a division or
    a transcendental as 1); the per-env variant adds the mass scale's
    products, the narrowphase rows 6 additions per touched body."""
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


def model_bytes(nb: int, nd: int, ncp: int, nsph: int, npair: int, n_np: int = 0) -> int:
    """Bytes of the kernel's packed model: the f32 header, body, dof,
    contact-point, sphere and pair sections, and the i32 tree tables,
    contact-point starts, sphere bodies, pairs and narrowphase bodies."""
    floats = 8 + nb * 52 + nd * 7 + ncp * 7 + nsph * 4 + npair * 3
    ints = 3 * nb + 1 + (nb + 1) + nsph + 2 * npair + n_np
    return 4 * (floats + ints)


def control_step_bytes(n: int, nb: int, nd: int, model_nbytes: int, per_env: bool = False,
                       n_np: int = 0) -> int:
    """Bytes one launch must move: the input block (13 + 4 nd rows, plus
    2 nd + 2 per-env rows and 6 n_np narrowphase rows), the output block
    (13 + 3 nd + nb rows) and the model, each once."""
    rows_in = 13 + 4 * nd + (2 * nd + 2 if per_env else 0) + 6 * n_np
    return 4 * n * (rows_in + 13 + 3 * nd + nb) + model_nbytes


def control_step_bound(counts, n: int, per_env: bool = False):
    """(bound ms, bound by) of one launch over ``n`` envs at the H100's
    peaks; ``counts`` = (nb, nd, ncp, nsph, npair, substeps, n_np)."""
    nb, nd, ncp, nsph, npair, substeps, n_np = counts
    flops = control_step_flops(nb, nd, ncp, npair, substeps, per_env=per_env, n_np=n_np) * n
    io = control_step_bytes(n, nb, nd, model_bytes(nb, nd, ncp, nsph, npair, n_np),
                            per_env=per_env, n_np=n_np)
    ops_s, bytes_s = flops / H100_SXM["f32"], io / H100_SXM["bytes"]
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def model_counts(model, substeps: int, self_collision: bool = True):
    """(nb, nd, ncp, nsph, npair, substeps, n_np) of a reference
    ``PhysicsModel`` without narrowphase pairs."""
    npair = len(model.sc_pairs) if self_collision else 0
    return (int(model.nb), int(model.nd), len(model.cp_body), len(model.sc_body), npair,
            int(substeps), 0)
