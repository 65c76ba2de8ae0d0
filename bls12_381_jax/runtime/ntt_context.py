"""NTT context: domain lifecycle + forward/inverse/coset/batch + async.

Analog of ``GpuNttContext`` (core/ntt.rs:303-308): wraps the global
twiddle-domain cache (ntt/domain.py plays the role of the reference's
AtomicU32+Mutex singleton, core/ntt.rs:289-293) and exposes the operation
set of the Ntt trait (core/ntt.rs:155-176): forward/inverse, batch
(leading axes), coset, orderings, async handles.
"""

from __future__ import annotations

import jax

# NB: the ntt package re-exports the `ntt` *function*, which shadows the
# ntt submodule for any attribute-based import; bind the functions directly.
from ..ntt.domain import get_domain, release_domain
from ..ntt.ntt import Ordering, coset_intt, coset_ntt, intt
from ..ntt.ntt import ntt as ntt_fn
from .config import config
from .handles import AsyncHandle
from .tracing import span


class NttContext:
    """Domain-holding NTT orchestrator for sizes up to 2^max_log_n."""

    def __init__(self, max_log_n: int = 20):
        self.max_log_n = max_log_n
        get_domain(max_log_n)  # build + cache the largest domain

    @staticmethod
    def _ordering(ordering):
        if ordering is not None:
            return ordering
        return Ordering(config().ntt_ordering)

    def _domain(self, n: int):
        log_n = n.bit_length() - 1
        return get_domain(log_n)

    # --- sync ---------------------------------------------------------------

    def forward(self, x, ordering=None):
        """Forward NTT along the last axis; leading axes are batch
        (the reference's batched NTT, ntt_kernels.cu:968-1133)."""
        with span("ntt", f"ntt.forward[n={x.shape[-1]}]"):
            out = ntt_fn(x, self._ordering(ordering), self._domain(x.shape[-1]))
            jax.block_until_ready(out)
        return out

    def inverse(self, x, ordering=None):
        with span("ntt", f"ntt.inverse[n={x.shape[-1]}]"):
            out = intt(x, self._ordering(ordering), self._domain(x.shape[-1]))
            jax.block_until_ready(out)
        return out

    def coset_forward(self, x, shift: int, ordering=None):
        return coset_ntt(x, shift, self._ordering(ordering),
                                 self._domain(x.shape[-1]))

    def coset_inverse(self, x, shift: int, ordering=None):
        return coset_intt(x, shift, self._ordering(ordering),
                                  self._domain(x.shape[-1]))

    # --- async (NttHandle analog, core/ntt.rs:945-1020) ----------------------

    def forward_async(self, x, ordering=None) -> AsyncHandle:
        return AsyncHandle(
            ntt_fn(x, self._ordering(ordering), self._domain(x.shape[-1])))

    def inverse_async(self, x, ordering=None) -> AsyncHandle:
        return AsyncHandle(
            intt(x, self._ordering(ordering), self._domain(x.shape[-1])))

    # --- domain lifecycle -----------------------------------------------------

    def release(self, log_n: int | None = None) -> None:
        release_domain(log_n)
