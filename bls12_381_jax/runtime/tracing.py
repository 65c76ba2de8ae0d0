"""Timing spans gated by MIDNIGHT_TRACE (the trace-msm/trace-fft analog).

The reference gates `std::time::Instant` timers behind cargo features
(Cargo.toml:44-46) surfaced via RUST_LOG; here a span is a context
manager that logs wall time when its tag is enabled, and optionally
feeds `jax.profiler` trace annotations for device profiling.
"""

from __future__ import annotations

import contextlib
import logging
import time

from .config import config

logger = logging.getLogger("bls12_381_jax.trace")


@contextlib.contextmanager
def span(tag: str, label: str):
    """Time a region when tracing `tag` is enabled; no-op otherwise."""
    if not config().traces(tag):
        yield
        return
    import jax.profiler

    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(label):
        yield
    logger.info("%s: %.3f ms", label, (time.perf_counter() - t0) * 1e3)


def timed_reps(reps: int, fn):
    """Best-of-``reps`` wall seconds of ``fn()``, each ending in
    ``jax.block_until_ready``."""
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best
