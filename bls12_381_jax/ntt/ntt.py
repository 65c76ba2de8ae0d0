"""Radix-2 Cooley-Tukey NTT over Fr (Montgomery domain), batched.

Design: each butterfly stage is a full-array reshape +
broadcast Montgomery multiply + add/sub — log2(n) fused XLA passes over a
(K, ..., n) limbs-first array.  There are no per-size kernel strategies to
pick (the reference needs warp/shared-memory/global tiers,
ntt_kernels.cu:752-811, because of the GPU memory hierarchy; XLA handles
the tiling here), and stage fusion falls out of XLA rather than being
hand-scheduled (cf. the fused 2-stage butterfly, ntt_kernels.cu:498-574).

Orderings: the reference's NN/NR/RN/RR zoo (core/config.rs:258-363) is
supported via explicit bit-reverse permutations around a single DIT core;
the mixed-radix M orderings collapse to R for a pure radix-2 transform.

Data is Montgomery-form Fr, matching the device convention everywhere in
this library (the reference likewise runs its NTT on Montgomery-form
scalars).
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp

from ..fields import FR, ops
from ..vecops import bit_reverse
from .domain import Domain, get_domain


class Ordering(enum.Enum):
    NN = "NN"  # natural in, natural out
    NR = "NR"  # natural in, bit-reversed out
    RN = "RN"  # bit-reversed in, natural out
    RR = "RR"  # bit-reversed in, bit-reversed out


def _butterflies(x, tw, log_n: int):
    """DIT butterfly ladder: expects bit-reversed input, yields natural output.

    x: (K, ..., n); tw: (K, n/2) Montgomery twiddles w^0..w^(n/2-1).
    """
    n = 1 << log_n
    K = x.shape[0]
    lead = x.shape[1:-1]
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        stride = n // m
        w = tw[:, ::stride][:, :half]  # (K, half) = w_m^j
        w = w.reshape((K,) + (1,) * (len(lead) + 1) + (half,))
        xg = x.reshape((K,) + lead + (n // m, m))
        even = xg[..., :half]
        odd = xg[..., half:]
        t = ops.mont_mul(FR, odd, jnp.broadcast_to(w, odd.shape))
        hi, lo = ops.add(FR, even, t), ops.sub(FR, even, t)
        x = jnp.concatenate([hi, lo], axis=-1)
        x = x.reshape((K,) + lead + (n,))
    return x


@partial(jax.jit, static_argnums=(1, 2, 3))
def _ntt_core(x, log_n: int, inverse: bool, ordering: Ordering, tw, n_inv):
    if ordering in (Ordering.NN, Ordering.NR):
        x = bit_reverse(x, axis=-1)
    x = _butterflies(x, tw, log_n)
    if ordering in (Ordering.NR, Ordering.RR):
        x = bit_reverse(x, axis=-1)
    if inverse:
        s = n_inv.reshape((FR.num_limbs,) + (1,) * (x.ndim - 1))
        x = ops.mont_mul(FR, x, jnp.broadcast_to(s, x.shape))
    return x


def _resolve(x, domain):
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    if domain is None:
        domain = get_domain(log_n)
    elif domain.log_n != log_n:
        raise ValueError(f"domain is for 2^{domain.log_n}, input is 2^{log_n}")
    return log_n, domain


def ntt(x, ordering: Ordering = Ordering.NN, domain: Domain | None = None):
    """Forward NTT along the last axis. x: (K, ..., n) Montgomery Fr."""
    log_n, domain = _resolve(x, domain)
    return _ntt_core(x, log_n, False, ordering, domain.tw, domain.n_inv)


def intt(x, ordering: Ordering = Ordering.NN, domain: Domain | None = None):
    """Inverse NTT along the last axis (includes the 1/n scale)."""
    log_n, domain = _resolve(x, domain)
    return _ntt_core(x, log_n, True, ordering, domain.itw, domain.n_inv)


# -----------------------------------------------------------------------------
# Coset NTT (evaluate on the coset shift * <omega>), reference ntt.cuh:128-220
# -----------------------------------------------------------------------------

_COSET_CACHE: dict = {}


def coset_powers(shift: int, n: int, inverse: bool = False):
    """[s^0, .., s^(n-1)] (or s^{-i}) Montgomery, cached per (shift, n, dir)."""
    from .domain import _powers_on_device

    key = (shift, n, inverse)
    got = _COSET_CACHE.get(key)
    if got is None:
        base = pow(shift, FR.modulus - 2, FR.modulus) if inverse else shift
        got = _powers_on_device(base, n)
        _COSET_CACHE[key] = got
    return got


def coset_ntt(x, shift: int, ordering: Ordering = Ordering.NN,
              domain: Domain | None = None):
    """Evaluate the polynomial on the coset {shift * omega^i}.

    Implemented as elementwise multiply by shift powers, then plain NTT —
    the same decomposition as the reference (coset-power multiply then NTT,
    ntt_kernels.cu:1155+).
    """
    if ordering in (Ordering.RN, Ordering.RR):
        raise ValueError("coset_ntt requires natural-order input")
    n = x.shape[-1]
    cp = coset_powers(shift, n)
    cp = cp.reshape((FR.num_limbs,) + (1,) * (x.ndim - 2) + (n,))
    x = ops.mont_mul(FR, x, jnp.broadcast_to(cp, x.shape))
    return ntt(x, ordering, domain)


def coset_intt(x, shift: int, ordering: Ordering = Ordering.NN,
               domain: Domain | None = None):
    """Inverse of coset_ntt: iNTT then divide by shift powers."""
    if ordering in (Ordering.NR, Ordering.RR):
        raise ValueError("coset_intt requires natural-order output")
    y = intt(x, ordering, domain)
    n = y.shape[-1]
    cp = coset_powers(shift, n, inverse=True)
    cp = cp.reshape((FR.num_limbs,) + (1,) * (y.ndim - 2) + (n,))
    return ops.mont_mul(FR, y, jnp.broadcast_to(cp, y.shape))
