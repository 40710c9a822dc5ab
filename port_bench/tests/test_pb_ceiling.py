"""The frozen yardstick equals the program's at the shapes it was copied
at: ``add_gym_torch.bench.derived_ceiling`` and
``physics.roofline.control_step_bound`` on the ``train`` (cloud job) and
``dr_pod`` configurations."""

import pytest
import torch

from port_bench import ceiling, spec


@pytest.mark.parametrize("workload", ["g1_add.cloud", "g1_dr.pod_one_card"])
def test_ceiling_and_bound_equal_the_programs(tmp_path, workload):
    from add_gym_torch import bench
    from add_gym_torch.builder import build_agent, build_env
    from add_gym_torch.physics import cuda_step as cs
    from add_gym_torch.physics.roofline import H100_SXM, control_step_bound

    from port_bench.reference.builder import build_env as ref_build_env

    cell = spec.workload(workload)
    cfg = spec.compose(cell, *spec.write_inputs(cell, str(tmp_path), 0), seed=1)
    n = int(cfg["engine"]["num_envs"])
    small = dict(cfg, device="cpu")
    small["engine"] = dict(cfg["engine"], num_envs=8, kernel="off")
    env = build_env(small, device="cpu")
    agent = build_agent(small, env, generator=torch.Generator().manual_seed(0))
    params = env._effective_params(env.reset_where(
        env.init_state(8), torch.ones(8, dtype=torch.bool), agent.init_train_state().sampler,
        generator=torch.Generator().manual_seed(1)))
    per_env = bool(env.dr.enabled)
    fbuf, ibuf, counts = cs.pack_model(env._fc, params, per_env)
    want_ms, want_by = control_step_bound(fbuf, ibuf, counts, n, per_env)

    renv = ref_build_env(small, device="cpu")
    mine = ceiling.model_counts(renv.model, renv.params.substeps, renv.params.self_collision)
    assert mine == counts
    got_ms, got_by = ceiling.control_step_bound(mine, n, per_env)
    assert (got_ms, got_by) == (want_ms, want_by)

    want = bench.derived_ceiling(agent, n, H100_SXM, want_ms)
    tp = ceiling.trunk_params(cfg["agent"], renv.obs_dim(), renv.disc_obs_dim(), renv.num_dofs)
    assert tp == agent.net_params_by_trunk()
    got = ceiling.derived_ceiling(cfg["agent"], tp, n, ceiling.device_peaks("NVIDIA H100 80GB HBM3"),
                                  got_ms)
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    assert got[2] == pytest.approx(want[2], rel=1e-12)


def test_cloud_ceiling_is_the_flagships():
    """Every term scales with the samples: the cloud job's ceiling is the
    flagship's 1,388,336.6 env-steps/s (PERF.md, PR 8)."""
    cell = spec.workload("g1_add.cloud")
    acfg = cell["config"]["config"]["agent"]
    tp = ceiling.trunk_params(acfg, 264, 114, 29)
    bound, by = ceiling.control_step_bound((30, 29, 248, 20, 107, 4, 0), 4096)
    rate, _, _ = ceiling.derived_ceiling(dict(acfg, steps_per_iter=128), tp, 4096,
                                         ceiling.H100_SXM, bound)
    assert by == "operations"
    assert rate == pytest.approx(1388336.6, abs=0.1)
