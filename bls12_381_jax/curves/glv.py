"""GLV endomorphism for G1: phi(x, y) = (beta*x, y) with phi(P) = lambda*P.

Counterpart of the reference's experimental GLV block
(point_ops.cu:103-480, gated by GLV_ENABLED and documented "reserved for
future optimization"): endomorphism application, scalar decomposition
k = k1 + k2*lambda with |k1|, |k2| ~ sqrt(r), and a batched GLV scalar
multiplication that halves the doubling count of the 255-bit ladder.

Constants are DERIVED, not transcribed: beta is the cube root of unity
in Fq selected so the eigenvalue relation phi(P) = lambda*P holds
(lambda = z^2 - 1 for the BLS parameter z = -0xd201000000010000, so
lambda^2 + lambda + 1 = 0 mod r), and the decomposition constant is
g = round(2^256 / r) as in the reference (point_ops.cu:195-199).

Decomposition (point_ops.cu glv_decompose analog, branch-free on device):
    k2 = (k * g) >> 256        (~128 bits)
    k1 = k - k2*lambda mod r   (~128 bits up to a few bits of slack)
Both halves then drive a joint (Shamir) double-and-add over the point
and its endomorphism image — 132 doublings instead of 255.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants
from ..fields import FQ, FR, ops
from ..fields.limbs import LIMB_BITS, LIMB_MASK, int_to_limbs
from . import points as pt
from . import projective as pj
from .field_adapters import FQ_ADAPTER

tree_map = jax.tree_util.tree_map

P_MOD = constants.FQ_MODULUS
R_MOD = constants.FR_MODULUS

BLS_Z = -0xD201000000010000
GLV_LAMBDA = (BLS_Z * BLS_Z - 1) % R_MOD
assert (GLV_LAMBDA * GLV_LAMBDA + GLV_LAMBDA + 1) % R_MOD == 0

# Joint-ladder bit length: both halves are < 2^128 (see decompose).
GLV_HALF_BITS = 128

# Barrett reciprocal for division by lambda: floor(2^384 / lambda).
# Because lambda ~ 2^128 ~ sqrt(r), plain integer division k = k2*lambda
# + k1 IS the GLV split (k1 = k mod lambda < 2^128, k2 = k//lambda <
# 2^128) — exact over the integers, no mod-r lattice rounding needed.
# (The reference's decomposition comment block, point_ops.cu:188-199, is
# marked not-yet-implemented; this is the working equivalent.)
GLV_BARRETT_SHIFT = 384
GLV_BARRETT_M = (1 << GLV_BARRETT_SHIFT) // GLV_LAMBDA


def _derive_beta() -> int:
    """The cube root of unity in Fq matching the eigenvalue lambda.

    Roots of t^2 + t + 1 mod p are (-1 +- sqrt(-3))/2; the one for which
    (beta*x_G, y_G) == lambda*G is the eigenvalue-consistent choice
    (verified against the host oracle at derivation time).
    """
    from .. import oracle

    s = pow(P_MOD - 3, (P_MOD + 1) // 4, P_MOD)  # p = 3 mod 4
    assert (s * s) % P_MOD == P_MOD - 3
    inv2 = pow(2, P_MOD - 2, P_MOD)
    candidates = [((P_MOD - 1 + s) * inv2) % P_MOD,
                  ((P_MOD - 1 - s) * inv2) % P_MOD]
    gx, gy = constants.G1_GENERATOR_X, constants.G1_GENERATOR_Y
    lam_g = oracle.jac_to_affine(
        oracle.scalar_mul(GLV_LAMBDA, (gx, gy), oracle.FQ_OPS), oracle.FQ_OPS)
    for b in candidates:
        assert pow(b, 3, P_MOD) == 1 and b != 1
        if ((b * gx) % P_MOD, gy) == lam_g:
            return b
    raise AssertionError("no eigenvalue-consistent cube root found")


_BETA: int | None = None


def beta() -> int:
    global _BETA
    if _BETA is None:
        _BETA = _derive_beta()
    return _BETA


def endomorphism(F, A):
    """phi(x, y) = (beta*x, y) on an affine batch (Montgomery form)."""
    x, y, inf = A
    bm = ops.broadcast_constant(FQ, int_to_limbs(FQ.to_mont(beta()),
                                                 FQ.num_limbs),
                                F.batch_shape(x))
    return (F.mul(x, bm), y, inf)


# -----------------------------------------------------------------------------
# Limb helpers: plain (non-Montgomery) big-int ops on (K, ...) uint32 arrays
# -----------------------------------------------------------------------------


def _limb_mul(a, b, Ka: int, Kb: int):
    """Schoolbook product of 16-bit-limb arrays -> (Ka+Kb) limb array."""
    n_shape = a.shape[1:]
    cols = [jnp.zeros(n_shape, jnp.uint32) for _ in range(Ka + Kb + 1)]
    for i in range(Ka):
        for j in range(Kb):
            prod = a[i] * b[j]
            cols[i + j] = cols[i + j] + (prod & LIMB_MASK)
            cols[i + j + 1] = cols[i + j + 1] + (prod >> LIMB_BITS)
    out = []
    carry = jnp.zeros(n_shape, jnp.uint32)
    for c in cols:
        v = c + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return jnp.stack(out[: Ka + Kb])


def _limb_sub(a, b):
    """a - b on equal-K limb arrays; returns (diff, borrow_flag)."""
    K = a.shape[0]
    d = []
    borrow = jnp.zeros(a.shape[1:], jnp.uint32)
    for i in range(K):
        v = a[i] - b[i] - borrow
        d.append(v & LIMB_MASK)
        borrow = (v >> LIMB_BITS) & 1
    return jnp.stack(d), borrow.astype(bool)


def _limb_inc_where(a, flag):
    """a + 1 on lanes where flag (carry-propagated)."""
    K = a.shape[0]
    out = []
    carry = jnp.where(flag, jnp.uint32(1), jnp.uint32(0))
    for i in range(K):
        v = a[i] + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return jnp.stack(out)


@jax.jit
def decompose(k_std):
    """Standard-form scalars (16, N) -> (k1, k2) with k = k1 + k2*lambda.

    Exact integer split by Barrett division (see GLV_BARRETT_M note):
    k2 = k // lambda (< 2^128), k1 = k mod lambda (< 2^128).  Branch-free
    limb arithmetic; the reciprocal estimate is corrected by at most two
    conditional (subtract-lambda, increment-k2) steps.
    """
    K = FR.num_limbs
    n_shape = k_std.shape[1:]
    Km = (GLV_BARRETT_M.bit_length() + LIMB_BITS - 1) // LIMB_BITS - K
    m = jnp.broadcast_to(
        jnp.asarray(int_to_limbs(GLV_BARRETT_M, K + Km), jnp.uint32
                    ).reshape((K + Km,) + (1,) * len(n_shape)),
        (K + Km,) + n_shape)
    prod = _limb_mul(k_std, m, K, K + Km)       # (2K+Km) limbs
    k2 = prod[GLV_BARRETT_SHIFT // LIMB_BITS:][:K]  # >> 384, keep 16 limbs
    lam = jnp.broadcast_to(
        jnp.asarray(int_to_limbs(GLV_LAMBDA, K), jnp.uint32
                    ).reshape((K,) + (1,) * len(n_shape)),
        (K,) + n_shape)
    k2l = _limb_mul(k2, lam, K, K)[:K]          # exact (true value < 2^255)
    rem, _ = _limb_sub(k_std, k2l)              # k - k2*lambda, in [0, 3*lam)
    for _ in range(2):                          # Barrett correction
        d, borrow = _limb_sub(rem, lam)
        take = ~borrow
        rem = jnp.where(take[None], d, rem)
        k2 = _limb_inc_where(k2, take)
    return rem, k2


# -----------------------------------------------------------------------------
# Batched GLV scalar multiplication (batch_scalar_mul_g1_glv_kernel analog)
# -----------------------------------------------------------------------------


def scalar_mul_glv(scalars_std, A, num_bits: int = GLV_HALF_BITS):
    """Batched k*P over G1 via GLV: k1*P + k2*phi(P), joint double-and-add.

    ``scalars_std``: (16, N) uint32 standard-form Fr limbs; ``A`` affine
    G1 batch.  ~num_bits doublings + 2*num_bits conditional adds instead
    of 255 of each — the reference's promised ~2x (point_ops.cu:112-116).
    Constant-time: per-bit cmov, no data-dependent branching.
    Returns a Jacobian batch (same contract as points.scalar_mul).
    """
    F = FQ_ADAPTER
    k1, k2 = decompose(scalars_std)
    phiA = endomorphism(F, A)
    batch = F.batch_shape(A[0])
    acc0 = pj.proj_identity(F, batch)
    k1 = jnp.asarray(k1, jnp.uint32)
    k2 = jnp.asarray(k2, jnp.uint32)

    def body(i, acc):
        bit_index = num_bits - 1 - i
        limb = bit_index // LIMB_BITS
        shift = (bit_index % LIMB_BITS).astype(jnp.uint32)
        b1 = (jax.lax.dynamic_index_in_dim(k1, limb, 0, keepdims=False)
              >> shift) & 1
        b2 = (jax.lax.dynamic_index_in_dim(k2, limb, 0, keepdims=False)
              >> shift) & 1
        acc = pj.proj_double(F, acc)
        a1 = pj.proj_add_mixed(F, acc, A)
        acc = pj.proj_cmov(F, b1.astype(bool), a1, acc)
        a2 = pj.proj_add_mixed(F, acc, phiA)
        acc = pj.proj_cmov(F, b2.astype(bool), a2, acc)
        return acc

    out = jax.lax.fori_loop(0, num_bits, body, acc0)
    return pj.proj_to_jac(F, out)
