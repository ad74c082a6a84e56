"""The in-repo object-session config (config.object_session_config)."""

import dataclasses

import numpy as np
import pytest

from obvi_slam_tpu import config as cfg


def _assert_same(a, b, path="config"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("pgo", [True, False])
def test_round_trips_through_read_config(tmp_path, pgo):
    c = cfg.object_session_config(pgo=pgo)
    path = tmp_path / "config.json"
    cfg.write_config(c, str(path))
    _assert_same(dataclasses.asdict(c), dataclasses.asdict(cfg.read_config(str(path))))


def test_documented_values():
    c = cfg.object_session_config()
    # SURVEY.md §5 (paper config): local phase-one ftol 1e-3, global 1e-6.
    assert c.local_ba_iteration_params.phase_one_opt_params.function_tolerance == 1e-3
    assert c.global_ba_iteration_params.phase_one_opt_params.function_tolerance == 1e-6
    en = c.optimization_factors_enabled_params
    assert en.use_pose_graph_on_global_ba and en.use_pose_graph_on_final_global_ba
    assert not cfg.object_session_config(pgo=False).optimization_factors_enabled_params.use_pose_graph_on_global_ba
    priors = cfg.shape_prior_map(c)
    np.testing.assert_allclose(priors["chair"][0], [0.62, 0.62, 0.975])
    np.testing.assert_allclose(np.diag(priors["chair"][1]), [0.05**2] * 3)
