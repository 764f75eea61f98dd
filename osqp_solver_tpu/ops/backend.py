"""The one place that decides which implementation a kernel site runs.

Every hot-path operation has a plain ``jax.numpy``/``lax`` form that XLA
compiles for any platform.  A hand-written kernel replaces it only where one
exists for the platform the process runs on and measured faster there.
Today that is one site: the fused ADMM chunk (:mod:`.admm_fused`, Pallas
through Triton), on CUDA GPUs.  Ruiz equilibration, the KKT factor, the
block-tridiagonal solve, the termination reductions and the dense path are
XLA everywhere.

Interpret mode is never chosen here: only tests ask for it, by passing
``interpret=True`` to a kernel call.
"""
from __future__ import annotations

import jax

TRITON = "triton"
XLA = "xla"

FUSED_CHUNK_VALUES = ("auto", "on", "off")


def platform() -> str:
    """The platform new computations are placed on: the default device's
    (``jax.default_device``) when one is set, else JAX's default backend —
    ``"gpu"``, ``"cpu"``, ..."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def admm_chunk(qp, settings) -> str:
    """Implementation of one chunk of ADMM iterations for ``qp`` (the scaled
    lane problem) under ``settings``: :data:`TRITON` or :data:`XLA`.

    ``Settings.fused_chunk``: ``"auto"`` takes the kernel where it runs and
    implements the problem and settings; ``"off"`` always takes XLA;
    ``"on"`` demands the kernel and raises ``ValueError`` when it cannot
    run."""
    from .admm_fused import kernel_unsupported_reason

    mode = settings.fused_chunk
    if mode not in FUSED_CHUNK_VALUES:
        raise ValueError(
            f"Settings.fused_chunk={mode!r}: allowed values are "
            f"{FUSED_CHUNK_VALUES}"
        )
    if mode == "off":
        return XLA
    if platform() != "gpu":
        if mode == "on":
            raise ValueError(
                "Settings.fused_chunk='on': the fused ADMM chunk kernel is "
                f"compiled for CUDA GPUs only; this process runs on "
                f"{platform()!r}. Use 'auto' or 'off'."
            )
        return XLA
    reason = kernel_unsupported_reason(qp, settings)
    if reason is not None:
        if mode == "on":
            raise ValueError(
                "Settings.fused_chunk='on': the fused ADMM chunk kernel "
                f"does not implement this case ({reason}). Use 'auto' or "
                "'off'."
            )
        return XLA
    return TRITON
