"""Async handles: JAX dispatch is asynchronous by construction.

The reference needs explicit CUDA streams and `wait()`-able handle
structs (core/stream.rs, core/msm.rs:1439-1640).  In JAX, every jitted
call returns immediately with futures-backed arrays; a handle just wraps
the result pytree plus an optional host-conversion step, and ``wait()``
is `jax.block_until_ready` + conversion — the same overlap semantics
(host code runs while the device computes) with no stream bookkeeping.
"""

from __future__ import annotations

from typing import Any, Callable

import jax


class AsyncHandle:
    """Wait-able result of an asynchronously dispatched device op."""

    def __init__(self, value: Any, convert: Callable[[Any], Any] | None = None):
        self._value = value
        self._convert = convert
        self._done = False

    def is_ready(self) -> bool:
        """True if the device computation has completed."""
        try:
            for leaf in jax.tree_util.tree_leaves(self._value):
                if hasattr(leaf, "is_ready") and not leaf.is_ready():
                    return False
            return True
        except RuntimeError:
            return True

    def wait(self) -> Any:
        """Block until the device result is ready; return (converted) value."""
        if not self._done:
            jax.block_until_ready(self._value)
            if self._convert is not None:
                self._value = self._convert(self._value)
            self._done = True
        return self._value


class ImmediateHandle(AsyncHandle):
    """Always-ready handle (CPU-path results, cpu_impl.rs:60-91 analog)."""

    def __init__(self, value: Any):
        super().__init__(value, None)
        self._done = True
