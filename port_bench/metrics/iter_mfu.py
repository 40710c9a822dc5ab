"""iter_mfu: env_steps_per_s of the traced run over the frozen ceiling of
one iteration (ceiling.derived_ceiling: each trunk's matmul operations
over the peak of its precision, plus T times the control-step kernel's
bound by operations), in %.  Nothing on a card without listed peaks."""

from port_bench import ceiling


def read(ctx):
    peaks = ceiling.device_peaks(ctx["device_kind"])
    if peaks is None or not ctx["traced"]:
        return None
    mc = ctx["model_counts"]
    params = ceiling.trunk_params(ctx["cfg"]["agent"], mc["obs_dim"], mc["disc_obs_dim"],
                                  mc["num_dofs"])
    bound_ms, _ = ceiling.control_step_bound(mc["counts"], ctx["num_envs"], per_env=ctx["per_env"])
    rate, _, _ = ceiling.derived_ceiling(ctx["cfg"]["agent"], params, ctx["num_envs"], peaks,
                                         bound_ms)
    return dict(value=100.0 * ctx["env_steps"] / ctx["window_s"] / rate, unit="%")
