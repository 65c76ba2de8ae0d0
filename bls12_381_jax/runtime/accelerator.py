"""Consumer-facing accelerator facade + global singleton.

Analog of the reference's trait facade (core/traits/mod.rs): a stable
object bundling the MSM backends (G1/G2), the NTT backend, cached-bases
handles, and a process-global accessor (``global_accelerator()``,
core/traits/mod.rs:495-497) with ``warmup()`` (core/mod.rs:161-190) and
``backend_info()`` (core/traits/gpu_impl.rs:388-398).
"""

from __future__ import annotations

import threading

import jax

from .config import config
from .msm_context import MsmContext, PrecomputedBases, g1_context, g2_context
from .ntt_context import NttContext


class AcceleratorError(RuntimeError):
    """Accelerator-layer failure (traits/mod.rs:88-109 analog)."""


class Accelerator:
    """Bundle of MSM (G1/G2) + NTT backends over the current JAX devices."""

    def __init__(self, max_ntt_log_n: int | None = None):
        if max_ntt_log_n is None:
            max_ntt_log_n = config().ntt_max_log_n
        self.g1: MsmContext = g1_context()
        self.g2: MsmContext = g2_context()
        self.ntt: NttContext = NttContext(max_ntt_log_n)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, *, g2: bool = False, n: int = 256,
               factor: int = 1, ntt_log_n: int | None = None) -> None:
        """Compile-warm the hot paths (warmup_gpu analog, core/mod.rs:161).

        Stage jits are shape-specialized: pass the production MSM size
        ``n`` (and precompute ``factor``) and NTT ``ntt_log_n`` so first
        real calls don't pay the compile — e.g.
        ``warmup(n=1 << 20, ntt_log_n=22)``.
        """
        self.g1.warmup(n, factor=factor)
        if g2:
            self.g2.warmup(max(n // 4, 16), factor=factor)
        if ntt_log_n is not None:
            from ..fields import FR, ops

            x = ops.zeros(FR, (1 << ntt_log_n,))
            jax.block_until_ready(self.ntt.inverse(self.ntt.forward(x)))

    def is_available(self) -> bool:
        try:
            return len(jax.devices()) > 0
        except RuntimeError:
            return False

    def backend_info(self) -> str:
        devs = jax.devices()
        cfg = config()
        lines = [
            "bls12_381_jax accelerator",
            f"  platform: {devs[0].platform} x{len(devs)}"
            f" ({devs[0].device_kind})",
            f"  device policy: {cfg.device.value}"
            f" (msm>=2^{cfg.msm_min_k}, ntt>=2^{cfg.ntt_min_k})",
            f"  precompute factor: {cfg.precompute_factor}",
            f"  sharding: {cfg.sharding}",
        ]
        return "\n".join(lines)


_GLOBAL: Accelerator | None = None
_LOCK = threading.Lock()


def global_accelerator() -> Accelerator:
    """Process-wide singleton (GLOBAL_ACCELERATOR analog)."""
    global _GLOBAL
    with _LOCK:
        if _GLOBAL is None:
            _GLOBAL = Accelerator()
        return _GLOBAL


def warmup(**kw) -> None:
    global_accelerator().warmup(**kw)


def backend_info() -> str:
    return global_accelerator().backend_info()
