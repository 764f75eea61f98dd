"""Fused ADMM chunk kernel (ops/admm_fused.py) parity vs the unfused loop.

Runs the Triton-route Pallas kernel in interpret mode on the CPU and pins
it against ``check_termination`` applications of ``admm_lane._iteration``
— same OSQP iteration semantics (reference src/osqp-wrapper.h; SURVEY
§3.4 hot loop).  Small tiles (``block_b`` 8/16) make small batches span
several programs; odd batch sizes exercise the padding of the last tile.
``test_kernel_on_gpu`` is the compiled kernel (``gpu`` marker).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu import RobotBall
from osqp_solver_tpu.gomp.geometry import HorizontalLine
from osqp_solver_tpu.gomp.trajectory import calc_warm_start_jnp
from osqp_solver_tpu.gomp.trajectory_qp import (
    empty_trajectory_qp,
    linearize_workspace,
    with_gomp_boxes,
)
from osqp_solver_tpu.gomp.trajectory_qp_lane import to_lane
from osqp_solver_tpu.ops import admm, backend
from osqp_solver_tpu.ops.admm_fused import fused_admm_chunk
from osqp_solver_tpu.ops.admm_lane import (
    _iteration,
    _termination_quantities,
    init_state_lane,
    ruiz_equilibrate_lane,
    solve_batched_lane,
)
from osqp_solver_tpu.ops.status import ExitCode

W, N, B = 8, 3, 128
RNG = np.random.default_rng(11)
JAC0 = RNG.normal(size=(3, N))


def build_wp_batch(honest=True, dtype=jnp.float64, batch=B, n_obstacles=1):
    """Waypoint-layout lane batch; ``honest`` adds two balls (one with
    workspace rows) and ``n_obstacles`` line obstacles (0 or 1)."""
    fk0 = lambda s: 0.1 * jnp.array([jnp.sum(s), jnp.sum(s**2), s[0]])
    jac0 = lambda s: jnp.asarray(JAC0, s.dtype) + 0.01 * s[None, :]
    fk1 = lambda s: s[:3]
    jac1 = lambda s: jnp.eye(3, N, dtype=s.dtype)
    balls = (
        RobotBall(fk=fk0, jacobian=jac0, radius=0.15, is_gripper=False),
        RobotBall(fk=fk1, jacobian=jac1, radius=0.05, is_gripper=True),
    )
    if honest:
        obstacles = [
            HorizontalLine.create((0.0, 1.0), (100.0, 100.0, 0.15))
        ][:n_obstacles]
        flags = (False, True)
    else:
        obstacles, flags = [], ()
    con3d = (jnp.full(3, -50.0, dtype), jnp.full(3, 50.0, dtype))
    pos = (jnp.full(N, -10.0, dtype), jnp.full(N, 10.0, dtype))
    vel = (jnp.full(N, -1.0, dtype), jnp.full(N, 1.0, dtype))
    acc = (jnp.full(N, -2.0, dtype), jnp.full(N, 2.0, dtype))
    base = empty_trajectory_qp(
        W, N, gripper_flags=flags, n_obstacles=len(obstacles), dtype=dtype
    )

    def one(i):
        start = 0.02 * jnp.sin(jnp.arange(N, dtype=dtype) + i)
        end = 1.0 + 0.02 * jnp.cos(jnp.arange(N, dtype=dtype) * 1.3 + i)
        qp = with_gomp_boxes(base, start, end, pos, vel, acc)
        if honest:
            warm = calc_warm_start_jnp(start, end, W)
            qp = linearize_workspace(qp, balls, obstacles, con3d, warm)
        return qp

    lane = to_lane(jax.vmap(one)(jnp.arange(batch, dtype=dtype)))
    return lane.replace(row_layout="waypoint")


def _chunk_case(honest, batch, n_obstacles=1, ct=3):
    settings = dataclasses.replace(admm.Settings(), check_termination=ct)
    lane = build_wp_batch(honest=honest, batch=batch, n_obstacles=n_obstacles)
    scaled, scaling = ruiz_equilibrate_lane(lane, settings.scaling)
    st = init_state_lane(scaled, settings)
    # Freeze a few problems to exercise the done mask.
    done = jnp.zeros((batch,), bool).at[5].set(True).at[batch - 3].set(True)
    st = st.replace(done=done, dx=st.dx + 0.25, dy=st.dy + 0.5)
    ref = st
    for _ in range(settings.check_termination):
        ref = _iteration(scaled, ref.replace(factor=None), st.factor, settings)
    return lane, scaled, scaling, settings, st, ref


@pytest.mark.parametrize(
    "honest,batch,block_b,n_obstacles",
    [
        (True, 32, 16, 1),  # 2 balls, 1 obstacle, two full tiles
        (False, 32, 8, 0),  # box-only, four tiles
        (True, 20, 8, 0),  # 2 balls, no obstacle, padded last tile
        (True, 37, 16, 1),  # padded last tile
    ],
)
def test_fused_chunk_matches_unfused_iterations(
    honest, batch, block_b, n_obstacles
):
    _, scaled, _, settings, st, ref = _chunk_case(honest, batch, n_obstacles)
    x2, z2, y2, dx2, dy2 = fused_admm_chunk(
        scaled, st.factor, st.x, st.z, st.y, st.rho_vec, st.done, settings,
        block_b=block_b, interpret=True,
    )
    assert x2.shape == st.x.shape and z2.shape == st.z.shape
    tol = dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(ref.x), **tol)
    np.testing.assert_allclose(np.asarray(z2), np.asarray(ref.z), **tol)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(ref.y), **tol)
    # dx/dy: last iteration's deltas; zeros for frozen problems (their
    # certificates/status are already fixed).
    mask = np.asarray(~st.done)
    np.testing.assert_allclose(
        np.asarray(dx2)[:, mask], np.asarray(ref.dx)[:, mask], **tol
    )
    np.testing.assert_allclose(
        np.asarray(dy2)[:, mask], np.asarray(ref.dy)[:, mask], **tol
    )
    np.testing.assert_array_equal(np.asarray(dx2)[:, 5], 0.0)
    np.testing.assert_array_equal(np.asarray(dy2)[:, batch - 3], 0.0)
    # Frozen problems kept their pre-chunk state bit-for-bit.
    for new, old in ((x2, st.x), (z2, st.z), (y2, st.y)):
        np.testing.assert_array_equal(
            np.asarray(new[:, 5]), np.asarray(old[:, 5])
        )


def test_gain_is_upper_triangular():
    """The block-Cholesky gain G_t = Ml_t·C_t⁻ᵀ of the trajectory QP family
    is exactly upper-triangular (Ml couples q_{t+1}/v_{t+1} only to
    same-index q_t/v_t diagonals) — the sparsity the kernel's gain-free
    substitution relies on when it applies Ml instead of G."""
    lane = build_wp_batch(honest=True)
    scaled, _ = ruiz_equilibrate_lane(lane, 10)
    rho = jnp.full((scaled.m, B), 0.1, scaled.q_vec.dtype)
    f = scaled.kkt_factor(rho, 1e-6)
    g = np.asarray(f.gain)  # (W-1, 2N, 2N, B)
    tril = np.tril_indices(2 * N, k=-1)
    assert np.max(np.abs(g[:, tril[0], tril[1], :])) == 0.0


@pytest.mark.parametrize("honest", [True, False])
def test_kernel_deltas_feed_termination(honest):
    """The termination quantities (XLA) computed from the kernel's state and
    deltas match those of the unfused iterations field for field, every
    infeasibility-certificate quantity included."""
    lane, scaled, scaling, settings, st, ref = _chunk_case(honest, 32)
    x2, z2, y2, dx2, dy2 = fused_admm_chunk(
        scaled, st.factor, st.x, st.z, st.y, st.rho_vec, st.done, settings,
        block_b=16, interpret=True,
    )
    # Frozen problems: the kernel zeroes their deltas, the flat loop keeps
    # the old ones; their decisions are final either way.
    live = ~st.done
    ref = ref.replace(
        dx=jnp.where(live, ref.dx, 0.0), dy=jnp.where(live, ref.dy, 0.0)
    )
    got = st.replace(x=x2, z=z2, y=y2, dx=dx2, dy=dy2)
    tq = _termination_quantities(lane, scaled, scaling, got)
    tq_ref = _termination_quantities(lane, scaled, scaling, ref)
    for name in tq._fields:
        a, b = np.asarray(getattr(tq, name)), np.asarray(getattr(tq_ref, name))
        np.testing.assert_allclose(
            a, b, rtol=1e-9, atol=1e-12, err_msg=f"field {name}"
        )


@pytest.mark.parametrize("warmup", [0, 6])
def test_fused_solve_end_to_end(interpret_chunk_kernel, warmup):
    settings = dataclasses.replace(
        admm.Settings(), check_termination=10, termination_warmup=warmup,
    )
    lane = build_wp_batch(honest=True, batch=40)
    assert backend.admm_chunk(lane, settings) == backend.TRITON
    ref = solve_batched_lane(
        lane, dataclasses.replace(settings, fused_chunk="off")
    )
    got = solve_batched_lane(lane, settings)
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(ref.status))
    assert np.all(np.asarray(got.status) == ExitCode.kOptimal)
    np.testing.assert_array_equal(
        np.asarray(got.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-7, atol=1e-9
    )


@pytest.mark.parametrize("fused", [False, True])
def test_warmup_chunk_keeps_the_cadence(interpret_chunk_kernel, fused):
    """The warmup runs as the loop's first chunk on both paths: no check
    follows it, so every executed-iteration count is the warmup plus whole
    cadence chunks, and statuses equal a solve without a warmup."""
    ct, warmup = 4, 6
    settings = dataclasses.replace(
        admm.Settings(), check_termination=ct, termination_warmup=warmup,
        fused_chunk="on" if fused else "off",
    )
    lane = build_wp_batch(honest=True, batch=40)
    got = solve_batched_lane(lane, settings)
    ref = solve_batched_lane(
        lane, dataclasses.replace(settings, termination_warmup=0)
    )
    it = np.asarray(got.iterations)
    assert np.all(it > warmup) and np.all((it - warmup) % ct == 0)
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(ref.status))
    assert np.all(np.asarray(got.status) == ExitCode.kOptimal)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("fused", [False, True])
def test_warmup_longer_than_max_iter(interpret_chunk_kernel, fused):
    """A warmup past ``max_iter`` is cut to it: the solve stops at
    ``max_iter`` with no check run, so every problem reports
    kMaxIterations."""
    settings = dataclasses.replace(
        admm.Settings(), check_termination=4, termination_warmup=50,
        max_iter=7, fused_chunk="on" if fused else "off",
    )
    lane = build_wp_batch(honest=True, batch=20)
    got = solve_batched_lane(lane, settings)
    np.testing.assert_array_equal(np.asarray(got.iterations), 7)
    assert np.all(np.asarray(got.status) == ExitCode.kMaxIterations)


def test_fused_solve_with_rho_adaptation(interpret_chunk_kernel):
    """A mid-solve ρ adaptation refactors between chunks; the kernel then
    reads the new factor and ρ and stays at parity with the XLA driver,
    which adapts on the identical schedule."""
    settings = dataclasses.replace(
        admm.Settings(), check_termination=4, adaptive_rho=True,
        adaptive_rho_interval=4,
        # Start far from the tuned ρ so adaptation actually fires.
        rho=1.0,
    )
    lane = build_wp_batch(honest=True, batch=40)
    ref = solve_batched_lane(
        lane, dataclasses.replace(settings, fused_chunk="off")
    )
    got = solve_batched_lane(lane, settings)
    assert np.all(np.asarray(got.status) == ExitCode.kOptimal)
    assert np.any(np.asarray(got.rho) != settings.rho)
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(
        np.asarray(got.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-6, atol=1e-8
    )


def test_block_p_structure_fused_driver(interpret_chunk_kernel):
    """A dense-block P has no gain-free substitution: 'auto' takes the XLA
    path explicitly, 'on' raises, and the solve matches the 'off' path."""
    lane = build_wp_batch(honest=True).replace(p_structure="block")
    settings = dataclasses.replace(admm.Settings(), check_termination=5)
    assert backend.admm_chunk(lane, settings) == backend.XLA
    with pytest.raises(ValueError, match="velocity-diagonal"):
        backend.admm_chunk(
            lane, dataclasses.replace(settings, fused_chunk="on")
        )
    got = solve_batched_lane(lane, settings)
    ref = solve_batched_lane(
        lane, dataclasses.replace(settings, fused_chunk="off")
    )
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(ref.status))
    assert np.all(np.asarray(got.status) == ExitCode.kOptimal)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-8, atol=1e-8
    )


@pytest.mark.gpu
def test_kernel_on_gpu(gpu):
    """The compiled kernel (not the interpreter) against the XLA iterations
    in f32 at a batch that spans several tiles and pads the last one."""
    _, scaled, _, settings, st, ref = _chunk_case(True, 100)
    settings = dataclasses.replace(settings, fused_chunk="on")
    cast = lambda a: a.astype(jnp.float32)  # noqa: E731
    scaled32 = jax.tree_util.tree_map(cast, scaled)
    st32 = jax.tree_util.tree_map(
        lambda a: cast(a) if a.dtype == jnp.float64 else a, st
    )
    ref32 = st32
    for _ in range(settings.check_termination):
        ref32 = _iteration(
            scaled32, ref32.replace(factor=None), st32.factor, settings
        )
    x2, z2, y2, _, _ = jax.jit(
        lambda s, t: fused_admm_chunk(
            s, t.factor, t.x, t.z, t.y, t.rho_vec, t.done, settings
        )
    )(scaled32, st32)
    # f32 with a different summation order than the scan: relative 1e-4.
    for a, b in ((x2, ref32.x), (z2, ref32.z), (y2, ref32.y)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4,
            atol=1e-4 * float(jnp.max(jnp.abs(b))),
        )
