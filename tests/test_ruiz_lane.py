"""Batch-last Ruiz equilibration (``admm_lane.ruiz_equilibrate_lane``, the
norm-only jnp iteration every platform runs) against the reference Ruiz of
``ops/ruiz.py`` vmapped over the batch-leading problems."""
import jax
import numpy as np
import pytest

from osqp_solver_tpu.gomp.trajectory_qp_lane import to_lane
from osqp_solver_tpu.ops.admm_lane import ruiz_equilibrate_lane
from osqp_solver_tpu.ops.ruiz import ruiz_equilibrate

from test_admm_lane import build_batch


def _bl(a):
    return np.moveaxis(np.asarray(a), -1, 0)


def _check(qps, iters):
    sc_r, s_r = jax.vmap(lambda q: ruiz_equilibrate(q, iters))(qps)
    sc_l, s_l = ruiz_equilibrate_lane(to_lane(qps), iters)
    np.testing.assert_allclose(_bl(s_l.D), np.asarray(s_r.D), rtol=1e-12)
    np.testing.assert_allclose(_bl(s_l.E), np.asarray(s_r.E), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(s_l.c), np.asarray(s_r.c), rtol=1e-12)
    np.testing.assert_allclose(
        _bl(sc_l.q), np.asarray(jax.vmap(lambda q: q.q)(sc_r)),
        rtol=1e-11, atol=1e-14,
    )
    np.testing.assert_allclose(
        _bl(sc_l.l), np.asarray(jax.vmap(lambda q: q.l)(sc_r)),
        rtol=1e-11, atol=1e-14,
    )


@pytest.mark.parametrize("honest", [True, False])
@pytest.mark.parametrize("p_structure", ["vel_diag", "block"])
def test_ruiz_lane_matches_reference(honest, p_structure):
    _check(build_batch(honest=honest).replace(p_structure=p_structure), 10)


def test_ruiz_lane_few_iters():
    _check(build_batch(honest=True), 3)
