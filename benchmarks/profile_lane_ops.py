"""Per-op timing of the lane-major ADMM hot loop at batch 1024.

Times each constituent op by chaining REPS applications inside one jitted
fori_loop (a data dependency defeats dead-code elimination; one dispatch
amortizes host dispatch).
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from bench import build_honest_batch
from osqp_solver_tpu.ops import admm
from osqp_solver_tpu.ops.admm_lane import (
    init_state_lane,
    ruiz_equilibrate_lane,
    _iteration,
    _termination,
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(a):
    return float(jnp.sum(a))


REPS = 50


def timed(name, f, *args):
    g = jax.jit(f)
    r = g(*args)
    sync(jax.tree.leaves(r)[0])
    t0 = time.time()
    r = g(*args)
    sync(jax.tree.leaves(r)[0])
    dt = (time.time() - t0) / REPS
    log(f"{name:30s} {dt*1e6:9.1f} us/op")
    return dt


def main():
    dtype = jnp.float32
    BATCH, W, N = 1024, 100, 6
    settings = dataclasses.replace(
        admm.Settings(), check_termination=10, adaptive_rho_interval=20
    )
    lane = build_honest_batch(BATCH, W, N, dtype)
    sync(lane.q_vec)
    log("built")

    scaled, scaling = jax.jit(lambda q: ruiz_equilibrate_lane(q, 10))(lane)
    st = jax.jit(
        lambda s: init_state_lane(s, settings), static_argnums=()
    )(scaled)
    sync(st.x)
    log("setup done")

    x = st.x
    y = st.y

    def chain(op, v0):
        def f(v):
            return jax.lax.fori_loop(0, REPS, lambda i, a: op(a) + 0.0, v)
        return f, v0

    # primitive operators
    timed("A_matvec", *chain(lambda v: scaled.AT_matvec(scaled.A_matvec(v)), x))
    timed("P_matvec", *chain(lambda v: scaled.P_matvec(v), x))
    timed(
        "kkt_solve",
        *chain(lambda v: scaled.kkt_solve(st.factor, v), x),
    )
    timed(
        "kkt_factor",
        lambda r: jax.lax.fori_loop(
            0,
            REPS,
            lambda i, rv: jax.tree.leaves(
                scaled.kkt_factor(rv, settings.sigma)
            )[0][0, 0, 0] * 1e-20 + rv,
            r,
        ),
        st.rho_vec,
    )

    # full iteration x10 (one chunk) and termination
    def one_chunk(st):
        factor = st.factor
        return jax.lax.fori_loop(
            0,
            settings.check_termination,
            lambda i, s: _iteration(scaled, s.replace(factor=None), factor, settings),
            st.replace(factor=None),
        ).replace(factor=factor)

    g = jax.jit(one_chunk)
    r = g(st)
    sync(r.x)
    t0 = time.time()
    r2 = g(g(g(g(g(st)))))
    sync(r2.x)
    dt = (time.time() - t0) / 50
    log(f"{'iteration (in 10-chunk)':30s} {dt*1e6:9.1f} us/op")

    h = jax.jit(lambda s: _termination(lane, scaled, scaling, s, settings)[0])
    r = h(st)
    sync(r.x)
    t0 = time.time()
    outs = [h(st) for _ in range(10)]
    for o in outs:
        sync(o.x)
    log(f"{'termination check':30s} {(time.time()-t0)/10*1e6:9.1f} us/op")


if __name__ == "__main__":
    main()
