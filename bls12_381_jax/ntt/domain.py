"""NTT twiddle domains: per-log-size cached roots of unity (Montgomery form).

Analog of the reference's global per-log-size domain registry
(ntt.cuh:77-114, storage ntt_kernels.cu:75-95; Rust-side singleton
core/ntt.rs:289-293): a process-global cache of device-resident twiddle
tables, built once per size and reused, with explicit release.

The primitive root derivation is pinned to the reference's semantics
(core/ntt.rs:1488-1494): omega for size 2^k is FR_OMEGA squared down
(32 - k) times — this is what makes results bit-exact against vectors
generated from the reference (tests/ntt_fft_comparison.rs caveat).

Twiddle tables are built ON DEVICE in log2(n) doubling steps
(P_{2m} = [P_m, P_m * w^m], each a full-width Montgomery multiply),
not host-side bigint loops — building the 2^21-entry table for a 2^22
NTT is itself a device-sized job.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from .. import constants
from ..fields import FR, ops
from ..fields.limbs import int_to_limbs
from ..oracle import root_of_unity


@dataclass
class Domain:
    log_n: int
    tw: jnp.ndarray      # (K, n/2) forward twiddles w^0..w^(n/2-1), Montgomery
    itw: jnp.ndarray     # (K, n/2) inverse twiddles
    n_inv: jnp.ndarray   # (K,) Montgomery form of n^{-1}
    omega: int           # standard-form root (host int, for derivations)

    @property
    def n(self) -> int:
        return 1 << self.log_n


_CACHE: dict[int, Domain] = {}
_LOCK = threading.Lock()


def _powers_on_device(w_int: int, count: int) -> jnp.ndarray:
    """[w^0, .., w^(count-1)] in Montgomery form, built by doubling on device."""
    K = FR.num_limbs
    if count <= 0:
        return ops.zeros(FR, (0,))
    p = ops.one_mont(FR, (1,))  # [1]
    w_cur = FR.to_mont(w_int)
    cur = jnp.asarray(int_to_limbs(w_cur, K))[:, None]  # w^(len) at each step
    total = 1
    while total < count:
        step = jnp.broadcast_to(cur, (K, total))
        p = jnp.concatenate([p, ops.mont_mul(FR, p, step)], axis=-1)
        cur = ops.mont_sqr(FR, cur)
        total *= 2
    return p[:, :count]


def get_domain(log_n: int) -> Domain:
    """Fetch (building if needed) the twiddle domain for size 2^log_n."""
    if log_n < 0 or log_n > constants.MAX_NTT_LOG_SIZE:
        raise ValueError(f"log_n {log_n} out of range [0, {constants.MAX_NTT_LOG_SIZE}]")
    with _LOCK:
        dom = _CACHE.get(log_n)
    if dom is not None:
        return dom
    n = 1 << log_n
    omega = root_of_unity(log_n)
    omega_inv = pow(omega, FR.modulus - 2, FR.modulus)
    tw = _powers_on_device(omega, n // 2)
    itw = _powers_on_device(omega_inv, n // 2)
    n_inv = jnp.asarray(
        int_to_limbs(FR.to_mont(pow(n, FR.modulus - 2, FR.modulus)), FR.num_limbs)
    )
    dom = Domain(log_n=log_n, tw=tw, itw=itw, n_inv=n_inv, omega=omega)
    with _LOCK:
        _CACHE[log_n] = dom
    return dom


def release_domain(log_n: int | None = None) -> None:
    """Drop cached domain(s) — the analog of release_ntt_domain."""
    with _LOCK:
        if log_n is None:
            _CACHE.clear()
        else:
            _CACHE.pop(log_n, None)
