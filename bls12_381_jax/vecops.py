"""Element-wise field vector operations over Fr/Fq (Montgomery domain).

Counterpart of the reference's vec_ops.cu kernels + core/vecops.rs
wrappers: add/sub/mul/scalar-mul/scalar-add, bit-reverse permutation, and
batch inversion via Montgomery's trick.  Everything is fused XLA over
limbs-first arrays — no dedicated kernels needed at this layer (XLA's
fusion does what the reference's hand-written elementwise kernels do).

Batch inversion mirrors the reference's 3-phase design (vec_ops.cu:155-333:
per-block prefix products -> single inversion -> suffix unwind) re-shaped
for whole-array XLA ops: row-sequential prefix products over a (R, L) tiling, one
Fermat inversion of the grand product, log-depth lane scans for the
cross-column stitching.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .fields import ops
from .fields.field import FieldSpec


# -- trivial elementwise wrappers (the public vecops API surface) -------------

def vector_add(spec, a, b):
    return ops.add(spec, a, b)


def vector_sub(spec, a, b):
    return ops.sub(spec, a, b)


def vector_mul(spec, a, b):
    return ops.mont_mul(spec, a, b)


def scalar_vec_mul(spec, s, v):
    """Broadcast single scalar s (K,) over vector v (K, n)."""
    s = s.reshape((spec.num_limbs,) + (1,) * (v.ndim - 1))
    return ops.mont_mul(spec, jnp.broadcast_to(s, v.shape), v)


def scalar_vec_add(spec, s, v):
    s = s.reshape((spec.num_limbs,) + (1,) * (v.ndim - 1))
    return ops.add(spec, jnp.broadcast_to(s, v.shape), v)


def vector_sum(spec, v):
    """Modular sum of a field vector (K, n) -> (K,).

    Tree reduction in log2(n) halving rounds of modular adds — the
    counterpart of the reference's partial-sum reduction kernel
    (vec_ops.cu:336-390), whose per-block shared-memory tree becomes a
    lane-halving loop here.
    """
    n = v.shape[-1]
    while n > 1:
        half = n // 2
        left = v[..., :half]
        right = v[..., half : 2 * half]
        red = ops.add(spec, left, right)
        if n % 2:
            red = jnp.concatenate([red, v[..., -1:]], axis=-1)
            n = half + 1
        else:
            n = half
        v = red
    return v[..., 0]


# -- bit reverse ---------------------------------------------------------------

def bit_reverse_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bit_reverse(x, axis: int = -1):
    """Permute the given power-of-two axis into bit-reversed order."""
    n = x.shape[axis]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("bit_reverse needs a power-of-two axis")
    idx = jnp.asarray(bit_reverse_indices(log_n))
    return jnp.take(x, idx, axis=axis)


# -- batch inversion (Montgomery's trick) --------------------------------------

def _mul(spec, a, b):
    return ops.mont_mul(spec, a, b)


@partial(jax.jit, static_argnums=0)
def batch_inverse(spec: FieldSpec, x):
    """Elementwise Montgomery-form inverse of x (K, n) with ONE field inversion.

    inv(0) = 0 (zeros are masked out and restored, preserving the reference's
    edge-case convention).
    """
    K = spec.num_limbs
    n = x.shape[-1]
    flat = x.reshape(K, n)
    zero_mask = ops.is_zero(spec, flat)
    one = ops.one_mont(spec, (n,))
    xs = ops.cmov(zero_mask, one, flat)

    # tile into (R, L); pad with ones
    L = min(4096, 1 << max(0, (n - 1).bit_length()))
    R = -(-n // L)
    pad = R * L - n
    if pad:
        xs = jnp.concatenate([xs, ops.one_mont(spec, (pad,))], axis=-1)
    rows = jnp.moveaxis(xs.reshape(K, R, L), 1, 0)  # (R, K, L)

    # Phase 1: inclusive prefix products down rows (lax.scan, width-L body)
    def fwd(carry, row):
        new = _mul(spec, carry, row)
        return new, new

    colprod, P = jax.lax.scan(fwd, ops.one_mont(spec, (L,)), rows)
    # P: (R, K, L) inclusive prefixes; colprod: (K, L)

    # Phase 2: exclusive prefix/suffix products across lanes (log-depth)
    def lane_scan(v, reverse):
        # inclusive scan of products along last axis
        acc = v
        d = 1
        while d < L:
            if reverse:
                shifted = jnp.concatenate(
                    [acc[..., d:], ops.one_mont(spec, acc.shape[1:-1] + (d,))], axis=-1
                )
            else:
                shifted = jnp.concatenate(
                    [ops.one_mont(spec, acc.shape[1:-1] + (d,)), acc[..., :-d]], axis=-1
                )
            acc = _mul(spec, acc, shifted)
            d *= 2
        return acc

    pre_incl = lane_scan(colprod, reverse=False)   # (K, L)
    suf_incl = lane_scan(colprod, reverse=True)
    grand = pre_incl[:, -1]  # (K,)
    ginv = ops.inv_mont(spec, grand[:, None])[:, 0]  # single inversion

    # inv(colprod[l]) = ginv * pre_excl[l] * suf_excl[l]
    one_col = ops.one_mont(spec, (1,))
    pre_excl = jnp.concatenate([one_col, pre_incl[:, :-1]], axis=-1)
    suf_excl = jnp.concatenate([suf_incl[:, 1:], one_col], axis=-1)
    icol = _mul(spec, _mul(spec, pre_excl, suf_excl),
                jnp.broadcast_to(ginv[:, None], pre_excl.shape))  # (K, L)

    # Phase 3: unwind rows backward (reverse lax.scan)
    # inv(x[r]) = inv(prefix[r]) * prefix[r-1];  iv walks down: iv *= x[r]
    ones_row = ops.one_mont(spec, (L,))
    P_prev = jnp.concatenate([ones_row[None], P[:-1]], axis=0)  # (R, K, L)

    def bwd(iv, inputs):
        row, pprev = inputs
        inv_r = _mul(spec, iv, pprev)
        iv = _mul(spec, iv, row)
        return iv, inv_r

    _, inv_rows = jax.lax.scan(bwd, icol, (rows, P_prev), reverse=True)
    invx = jnp.moveaxis(inv_rows, 0, 1).reshape(K, R * L)[:, :n]

    zero = ops.zeros(spec, (n,))
    out = ops.cmov(zero_mask, zero, invx)
    return out.reshape(x.shape)
