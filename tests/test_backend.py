"""The kernel-site decision (ops/backend.py), the pytree dataclass helper
(osqp_solver_tpu/struct.py) and the compile-cache helper
(utils/compile_cache.py)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu import struct
from osqp_solver_tpu.ops import admm, backend

from test_admm_fused import build_wp_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lane():
    return build_wp_batch(honest=True, batch=4)


def _on_gpu(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")


def test_cpu_takes_xla(lane):
    assert backend.platform() == "cpu"
    assert backend.admm_chunk(lane, admm.Settings()) == backend.XLA


def test_fused_chunk_on_without_kernel_raises(lane):
    s = dataclasses.replace(admm.Settings(), fused_chunk="on")
    with pytest.raises(ValueError, match="CUDA GPUs only"):
        backend.admm_chunk(lane, s)


def test_gpu_auto_takes_kernel(monkeypatch, lane):
    _on_gpu(monkeypatch)
    assert backend.admm_chunk(lane, admm.Settings()) == backend.TRITON
    on = dataclasses.replace(admm.Settings(), fused_chunk="on")
    assert backend.admm_chunk(lane, on) == backend.TRITON
    off = dataclasses.replace(admm.Settings(), fused_chunk="off")
    assert backend.admm_chunk(lane, off) == backend.XLA


@pytest.mark.parametrize(
    "change,problem,reason",
    [
        ({}, {"row_layout": "type"}, "row_layout"),
        ({}, {"p_structure": "block"}, "velocity-diagonal"),
        ({"kkt_refine": 1}, {}, "kkt_refine"),
        ({"kkt_method": "cg"}, {}, "kkt_method"),
        ({}, {"row_layout": "type", "p_structure": "block"}, "row_layout"),
    ],
)
def test_unimplemented_cases_take_xla(monkeypatch, lane, change, problem, reason):
    """What the kernel does not implement selects XLA under 'auto' and is
    refused, with the reason, under 'on'."""
    _on_gpu(monkeypatch)
    qp = lane.replace(**problem)
    s = dataclasses.replace(admm.Settings(), **change)
    assert backend.admm_chunk(qp, s) == backend.XLA
    with pytest.raises(ValueError, match=reason):
        backend.admm_chunk(qp, dataclasses.replace(s, fused_chunk="on"))


def test_invalid_fused_chunk_value(lane):
    s = dataclasses.replace(admm.Settings(), fused_chunk="yes")
    with pytest.raises(ValueError, match="fused_chunk"):
        backend.admm_chunk(lane, s)


def test_kernel_interprets_only_when_asked(lane):
    """No interpret default comes from the platform: without
    ``interpret=True`` the Triton kernel refuses to run on the CPU."""
    from osqp_solver_tpu.ops.admm_fused import fused_admm_chunk
    from osqp_solver_tpu.ops.admm_lane import init_state_lane

    s = admm.Settings()
    st = init_state_lane(lane, s)
    with pytest.raises(Exception, match="(?i)interpret|gpu|cuda|triton"):
        fused_admm_chunk(lane, st.factor, st.x, st.z, st.y, st.rho_vec, st.done, s)


@struct.dataclass
class _Rec:
    a: jnp.ndarray
    tag: str = struct.field(pytree_node=False, default="t")
    b: object = None


def test_struct_pytree_roundtrip():
    r = _Rec(a=jnp.arange(3.0), b=jnp.ones(2))
    leaves, tree = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2  # tag is static
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert back.tag == "t" and np.array_equal(back.a, r.a)
    doubled = jax.jit(lambda x: jax.tree_util.tree_map(lambda v: 2 * v, x))(r)
    assert doubled.tag == "t"
    np.testing.assert_array_equal(doubled.a, 2 * np.arange(3.0))


def test_struct_replace_and_static_fields():
    r = _Rec(a=jnp.zeros(2))
    r2 = r.replace(tag="u", a=jnp.ones(2))
    assert r.tag == "t" and r2.tag == "u"
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.a = jnp.ones(2)
    # Static fields are part of the structure: different tags never share a
    # treedef (and so never share a compiled program).
    assert jax.tree_util.tree_structure(r) != jax.tree_util.tree_structure(r2)
    # None fields are empty subtrees.
    assert len(jax.tree_util.tree_leaves(r)) == 1


def _cache_dir_in_child(env):
    code = (
        "import jax; from osqp_solver_tpu.utils.compile_cache import "
        "enable_compile_cache as e; p = e(); "
        "print(p); print(jax.config.jax_compilation_cache_dir)"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, **env}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split()
    return out


def test_compile_cache_default_dir():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code_env = {"JAX_COMPILATION_CACHE_DIR": ""}
    got, cfg = _cache_dir_in_child(code_env)
    want = os.path.join(REPO, ".jax_cache")
    assert got == want and cfg == want


def test_compile_cache_honours_env(tmp_path):
    got, cfg = _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert got == str(tmp_path) and cfg == str(tmp_path)
