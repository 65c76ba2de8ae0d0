"""Auto CPU/accelerator dispatch with transparent fallback.

Analog of ``core/dispatch.rs``: size-thresholded routing between the
accelerated JAX path and the host-side big-int oracle (which plays BLST /
best_fft's role, SURVEY.md §1), with accelerator failures logged and
transparently degraded to the CPU path, the error preserved in the result
(DispatchResult{Gpu,GpuFailed,Cpu}, core/dispatch.rs:207-297).

Host-level inputs here are Python ints / int pairs (the consumer-facing
form); device-array callers use the contexts directly.
"""

from __future__ import annotations

import enum
import logging
from dataclasses import dataclass
from typing import Any

logger = logging.getLogger("bls12_381_jax.dispatch")


class Route(enum.Enum):
    ACCEL = "accel"
    ACCEL_FAILED = "accel_failed"
    CPU = "cpu"


@dataclass
class DispatchResult:
    value: Any
    route: Route
    error: Exception | None = None


def dispatch_msm(scalars: list[int], bases: list, curve: str = "g1") -> DispatchResult:
    """MSM on int scalars and affine int-pair bases (None = identity).

    Returns the affine int-pair result (or None) plus the route taken.
    """
    from .. import oracle
    from .config import config

    n = len(scalars)
    ops_ns = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    if config().use_accel_msm(n):
        try:
            value = _accel_msm(scalars, bases, curve)
            return DispatchResult(value, Route.ACCEL)
        except Exception as e:  # noqa: BLE001 - transparent fallback by design
            logger.warning("accelerated MSM failed (%s); falling back to CPU", e)
            value = oracle.jac_to_affine(_host_msm(scalars, bases, curve), ops_ns)
            return DispatchResult(value, Route.ACCEL_FAILED, e)
    value = oracle.jac_to_affine(_host_msm(scalars, bases, curve), ops_ns)
    return DispatchResult(value, Route.CPU)


def _host_msm(scalars, bases, curve: str):
    """CPU MSM: native Pippenger (native/msm_host.cpp, the BLST multi_exp
    analog) when the compiled library is present, else the big-int oracle's
    naive double-and-add."""
    from .. import native, oracle

    if native.available():
        return native.msm_host(scalars, bases, curve)
    ops_ns = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    return oracle.msm(scalars, bases, ops_ns)


def _accel_msm(scalars: list[int], bases: list, curve: str):
    import jax.numpy as jnp

    from .. import oracle
    from ..fields import FR
    from ..fields.limbs import ints_to_limbs

    sc = jnp.asarray(ints_to_limbs([FR.to_mont(s % FR.modulus) for s in scalars],
                                   FR.num_limbs))
    if curve == "g1":
        from ..curves import g1 as cm

        ctx_adapter = _g1_ctx()
    else:
        from ..curves import g2 as cm

        ctx_adapter = _g2_ctx()
    A = cm.affine_from_ints(bases)
    P = ctx_adapter.msm(sc, A)
    out = cm.jacobian_to_ints(
        __import__("jax").tree_util.tree_map(lambda c: c[..., None], P))[0]
    # validate the result is on-curve before handing it to the consumer —
    # the same defense as the reference's icicle_to_g1_projective
    # (core/types.rs:353-368 routes results through from_xy validation);
    # an off-curve result raises, which dispatch_msm turns into a CPU
    # fallback with the error preserved.
    from .. import oracle as _oracle

    ok = (_oracle.g1_is_on_curve(out) if curve == "g1"
          else _oracle.g2_is_on_curve(out))
    if not ok:
        raise RuntimeError("accelerated MSM produced an off-curve point")
    return out


_G1_CTX = None
_G2_CTX = None


def _g1_ctx():
    global _G1_CTX
    if _G1_CTX is None:
        from .msm_context import g1_context

        _G1_CTX = g1_context()
    return _G1_CTX


def _g2_ctx():
    global _G2_CTX
    if _G2_CTX is None:
        from .msm_context import g2_context

        _G2_CTX = g2_context()
    return _G2_CTX


def dispatch_ntt(values: list[int], inverse: bool = False) -> DispatchResult:
    """NTT on int coefficient lists, routed by size threshold."""
    from .. import oracle
    from .config import config

    n = len(values)
    if config().use_accel_ntt(n):
        try:
            value = _accel_ntt(values, inverse)
            return DispatchResult(value, Route.ACCEL)
        except Exception as e:  # noqa: BLE001
            logger.warning("accelerated NTT failed (%s); falling back to CPU", e)
            return DispatchResult(oracle.ntt(values, inverse), Route.ACCEL_FAILED, e)
    return DispatchResult(oracle.ntt(values, inverse), Route.CPU)


_VECOPS = {
    "add": lambda a, b, p: [(x + y) % p for x, y in zip(a, b)],
    "sub": lambda a, b, p: [(x - y) % p for x, y in zip(a, b)],
    "mul": lambda a, b, p: [x * y % p for x, y in zip(a, b)],
}


def dispatch_vecop(op: str, a: list[int], b: list[int],
                   field: str = "fr") -> DispatchResult:
    """Element-wise vector op on int lists, size-routed like core/vecops.rs
    (CPU below MIDNIGHT_VECOPS_MIN_SIZE, accelerator above, transparent
    fallback on accelerator failure)."""
    from .config import config

    if op not in _VECOPS:
        raise ValueError(f"unknown vecop {op!r}")
    from ..fields import FQ, FR

    spec = FR if field == "fr" else FQ
    n = len(a)
    if config().use_accel_vecops(n):
        try:
            return DispatchResult(_accel_vecop(op, a, b, spec), Route.ACCEL)
        except Exception as e:  # noqa: BLE001 - transparent fallback
            logger.warning("accelerated vecop failed (%s); CPU fallback", e)
            return DispatchResult(_VECOPS[op](a, b, spec.modulus),
                                  Route.ACCEL_FAILED, e)
    return DispatchResult(_VECOPS[op](a, b, spec.modulus), Route.CPU)


def _accel_vecop(op: str, a: list[int], b: list[int], spec):
    import numpy as np
    import jax.numpy as jnp

    from .. import vecops
    from ..fields import ops
    from ..fields.limbs import ints_to_limbs, limbs_to_ints

    av = jnp.asarray(ints_to_limbs([spec.to_mont(v % spec.modulus) for v in a],
                                   spec.num_limbs))
    bv = jnp.asarray(ints_to_limbs([spec.to_mont(v % spec.modulus) for v in b],
                                   spec.num_limbs))
    fn = {"add": vecops.vector_add, "sub": vecops.vector_sub,
          "mul": vecops.vector_mul}[op]
    out = fn(spec, av, bv)
    return limbs_to_ints(np.asarray(ops.from_mont(spec, out)))


def _accel_ntt(values: list[int], inverse: bool):
    import numpy as np
    import jax.numpy as jnp

    from ..fields import FR, ops
    from ..fields.limbs import ints_to_limbs, limbs_to_ints
    from ..ntt import intt, ntt

    x = jnp.asarray(ints_to_limbs([FR.to_mont(v % FR.modulus) for v in values],
                                  FR.num_limbs))
    y = intt(x) if inverse else ntt(x)
    return limbs_to_ints(np.asarray(ops.from_mont(FR, y)))
