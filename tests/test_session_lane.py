"""Batched lane sessions (ops/session_lane.py): OSQP session semantics —
frozen scaling, cached factor, warm-started re-solves — for a whole batch
on the fused lane driver (reference anchor: osqp-wrapper.h:12-60 sessions +
the warm-started sequential Solve() loop, gomp-solver.h:41-52)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm
from osqp_solver_tpu.ops.admm_lane import solve_batched_lane
from osqp_solver_tpu.ops.session_lane import (
    mpc_scan_lane,
    setup_lane,
    solve_lane,
    update_bounds_lane,
)
from osqp_solver_tpu.ops.status import ExitCode

from test_admm_fused import build_wp_batch

SETTINGS = dataclasses.replace(
    admm.Settings(), check_termination=5, fused_chunk="on"
)
SETTINGS_OFF = dataclasses.replace(SETTINGS, fused_chunk="off")


@pytest.fixture(autouse=True)
def _kernel(interpret_chunk_kernel):
    """Sessions run the fused chunk kernel (interpreted) unless a test
    asks for 'off'."""


def test_setup_solve_matches_batched_solve():
    lane = build_wp_batch(honest=True, batch=32)
    sess = setup_lane(lane, SETTINGS)
    sess, res = solve_lane(sess, SETTINGS)
    ref = solve_batched_lane(lane, SETTINGS)
    np.testing.assert_array_equal(
        np.asarray(res.status), np.asarray(ref.status)
    )
    np.testing.assert_array_equal(
        np.asarray(res.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-9, atol=1e-9
    )


def test_warm_resolve_converges_faster():
    lane = build_wp_batch(honest=True, batch=32)
    sess = setup_lane(lane, SETTINGS)
    sess, res0 = solve_lane(sess, SETTINGS)
    assert np.all(np.asarray(res0.status) == ExitCode.kOptimal)

    d = jnp.full((lane.n_dim, 1), 1e-4, lane.q.dtype)  # broadcast over B
    sess = update_bounds_lane(
        sess,
        pos_l=sess.base.pos_l.at[-1].add(d),
        pos_u=sess.base.pos_u.at[-1].add(d),
    )
    sess, res1 = solve_lane(sess, SETTINGS)
    assert np.all(np.asarray(res1.status) == ExitCode.kOptimal)
    # Warm start from the previous solution: no problem should need more
    # iterations than its cold solve.
    assert np.all(np.asarray(res1.iterations) <= np.asarray(res0.iterations))
    # The factor was NOT recomputed by the bounds update (object identity
    # through update_bounds_lane).
    assert sess.factor is not None


def test_mpc_scan_matches_manual_loop():
    lane = build_wp_batch(honest=True, batch=32)
    T = 3
    deltas = 1e-4 * jnp.arange(1, T + 1, dtype=lane.q.dtype)[
        :, None, None
    ] * jnp.ones((lane.n_dim, 1), lane.q.dtype)

    def shift_goal(base, d):
        return base.replace(
            pos_l=base.pos_l.at[-1].add(d), pos_u=base.pos_u.at[-1].add(d)
        )

    sess = setup_lane(lane, SETTINGS)
    _, (st_scan, it_scan) = mpc_scan_lane(sess, deltas, shift_goal, SETTINGS)

    sess2 = setup_lane(lane, SETTINGS)
    st_man, it_man = [], []
    for t in range(T):
        sess2 = update_bounds_lane(
            sess2,
            pos_l=shift_goal(sess2.base, deltas[t]).pos_l,
            pos_u=shift_goal(sess2.base, deltas[t]).pos_u,
        )
        sess2, r = solve_lane(sess2, SETTINGS)
        st_man.append(np.asarray(r.status))
        it_man.append(np.asarray(r.iterations))
    np.testing.assert_array_equal(np.asarray(st_scan), np.stack(st_man))
    np.testing.assert_array_equal(np.asarray(it_scan), np.stack(it_man))


def test_session_fused_off_parity():
    """Session semantics are kernel-independent: fused on == fused off."""
    lane = build_wp_batch(honest=True, batch=32)
    sa = setup_lane(lane, SETTINGS)
    sb = setup_lane(lane, SETTINGS_OFF)
    sa, ra = solve_lane(sa, SETTINGS)
    sb, rb = solve_lane(sb, SETTINGS_OFF)
    np.testing.assert_array_equal(np.asarray(ra.status), np.asarray(rb.status))
    np.testing.assert_allclose(
        np.asarray(ra.x), np.asarray(rb.x), rtol=1e-8, atol=1e-8
    )


def test_session_hrec_factor_form():
    """Sessions through the fused kernel's gain-free ('hrec') substitution
    match their direct batched solve, and the XLA chunk path (which applies
    the factor's gain blocks) on the same cached factor, up to rounding."""
    lane = build_wp_batch(honest=True, batch=32)

    sh = setup_lane(lane, SETTINGS)
    sh, rh = solve_lane(sh, SETTINGS)
    ref = solve_batched_lane(lane, SETTINGS)
    np.testing.assert_array_equal(
        np.asarray(rh.status), np.asarray(ref.status)
    )
    np.testing.assert_allclose(
        np.asarray(rh.x), np.asarray(ref.x), rtol=1e-9, atol=1e-9
    )

    sg = setup_lane(lane, SETTINGS_OFF)
    assert sg.factor.chol.shape == sh.factor.chol.shape
    sg, rg = solve_lane(sg, SETTINGS_OFF)
    np.testing.assert_array_equal(
        np.asarray(rh.status), np.asarray(rg.status)
    )
    np.testing.assert_allclose(
        np.asarray(rh.x), np.asarray(rg.x), rtol=1e-6, atol=1e-6
    )
