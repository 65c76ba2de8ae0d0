"""Generic batched Jacobian group law for short-Weierstrass a=0 curves.

Written once against the field-adapter interface and instantiated for
G1 (Fq) and G2 (Fq2) — the counterpart of the reference's templated,
complete, constant-time point ops (point.cuh:610-915, G2 analogs :948-1271).

Representations (all batched, limbs-first):
* Jacobian point: ``(X, Y, Z)`` field elements; identity <=> Z == 0.
* Affine point:   ``(x, y, inf)`` with ``inf`` a bool batch mask (affine
  coordinates cannot encode the identity; the reference handles this with
  dedicated zero-checks, we carry an explicit mask).

Completeness strategy (same idea as the reference's cmov-based formulas):
compute the generic add formula unconditionally, then constant-time-select
the doubling result / identity / passthrough for the edge cases.  Every
lane executes everything anyway, so this is constant-time by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def jac_identity(F, batch_shape=()):
    """Canonical identity (1 : 1 : 0) in Montgomery form."""
    return (F.one(batch_shape), F.one(batch_shape), F.zero(batch_shape))


def jac_is_identity(F, P):
    return F.is_zero(P[2])


def jac_cmov(F, mask, P, Q):
    return tuple(F.cmov(mask, p, q) for p, q in zip(P, Q))


def jac_neg(F, P):
    return (P[0], F.neg(P[1]), P[2])


def affine_neg(F, A):
    return (A[0], F.neg(A[1]), A[2])


def affine_cmov(F, mask, A, B):
    return (F.cmov(mask, A[0], B[0]), F.cmov(mask, A[1], B[1]),
            jnp.where(mask, A[2], B[2]))


def jac_double(F, P):
    """dbl-2009-l, a = 0.  Complete: Z=0 in -> Z3=0 out."""
    X, Y, Z = P
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.sub(F.sub(F.sqr(F.add(X, B)), A), C)
    D = F.double(D)
    E = F.add(F.double(A), A)  # 3A
    G = F.sqr(E)
    X3 = F.sub(G, F.double(D))
    C8 = F.double(F.double(F.double(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(F.double(Y), Z)
    return (X3, Y3, Z3)


def jac_add(F, P, Q):
    """add-2007-bl with constant-time edge-case selection.

    Handles: P or Q identity, P == Q (doubling), P == -Q (identity).
    """
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    I = F.sqr(F.double(H))
    J = F.mul(H, I)
    r = F.double(F.sub(S2, S1))
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.double(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(S1, J)))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    R = (X3, Y3, Z3)

    idP = jac_is_identity(F, P)
    idQ = jac_is_identity(F, Q)
    x_eq = F.is_zero(H) & ~idP & ~idQ
    y_eq = F.is_zero(F.sub(S2, S1))
    # same point -> doubling
    R = jac_cmov(F, x_eq & y_eq, jac_double(F, P), R)
    # inverse point -> identity
    batch = F.batch_shape(X1)
    R = jac_cmov(F, x_eq & ~y_eq, jac_identity(F, batch), R)
    R = jac_cmov(F, idP, Q, R)
    R = jac_cmov(F, idQ, P, R)
    return R


def jac_add_affine(F, P, A):
    """Mixed addition madd-2007-bl (Z2 = 1) with edge-case selection.

    ``A = (x, y, inf)``.  ~8M+3S vs 12M+4S for the full add — the hot op of
    MSM bucket accumulation (reference: g1_add_mixed, point.cuh:803-915).
    """
    X1, Y1, Z1 = P
    x2, y2, inf2 = A
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    HH = F.sqr(H)
    I = F.double(F.double(HH))
    J = F.mul(H, I)
    r = F.double(F.sub(S2, Y1))
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.double(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(Y1, J)))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    R = (X3, Y3, Z3)

    idP = jac_is_identity(F, P)
    x_eq = F.is_zero(H) & ~idP & ~inf2
    y_eq = F.is_zero(F.sub(S2, Y1))
    R = jac_cmov(F, x_eq & y_eq, jac_double(F, P), R)
    batch = F.batch_shape(X1)
    R = jac_cmov(F, x_eq & ~y_eq, jac_identity(F, batch), R)
    promoted = (x2, y2, F.one(batch))
    R = jac_cmov(F, idP & ~inf2, promoted, R)
    R = jac_cmov(F, inf2, P, R)
    return R


def jac_to_affine(F, P):
    """Jacobian -> affine: (X/Z^2, Y/Z^3, inf=Z==0)."""
    X, Y, Z = P
    inf = F.is_zero(Z)
    # avoid inv(0) poisoning: substitute 1 where identity
    batch = F.batch_shape(X)
    Zs = F.cmov(inf, F.one(batch), Z)
    zi = F.inv(Zs)
    zi2 = F.sqr(zi)
    x = F.mul(X, zi2)
    y = F.mul(Y, F.mul(zi2, zi))
    zero = F.zero(batch)
    return (F.cmov(inf, zero, x), F.cmov(inf, zero, y), inf)


def affine_to_jac(F, A):
    x, y, inf = A
    batch = F.batch_shape(x)
    one = F.one(batch)
    zero = F.zero(batch)
    return (
        F.cmov(inf, one, x),
        F.cmov(inf, one, y),
        F.cmov(inf, zero, one),
    )


def jac_eq(F, P, Q):
    """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    ex = F.eq(F.mul(X1, Z2Z2), F.mul(X2, Z1Z1))
    ey = F.eq(F.mul(F.mul(Y1, Z2), Z2Z2), F.mul(F.mul(Y2, Z1), Z1Z1))
    id1 = jac_is_identity(F, P)
    id2 = jac_is_identity(F, Q)
    return (id1 & id2) | (~id1 & ~id2 & ex & ey)


def is_on_curve_affine(F, A, b_mont):
    """y^2 == x^3 + b (identity counts as on-curve)."""
    x, y, inf = A
    lhs = F.sqr(y)
    rhs = F.add(F.mul(F.sqr(x), x), b_mont)
    return F.eq(lhs, rhs) | inf


def is_on_curve_jacobian(F, P, b_mont):
    """Y^2 == X^3 + b Z^6 (identity counts as on-curve)."""
    X, Y, Z = P
    lhs = F.sqr(Y)
    z2 = F.sqr(Z)
    z6 = F.mul(F.sqr(z2), z2)
    rhs = F.add(F.mul(F.sqr(X), X), F.mul(b_mont, z6))
    return F.eq(lhs, rhs) | jac_is_identity(F, P)


# -----------------------------------------------------------------------------
# Batched scalar multiplication (the on-device double-and-add reference the
# MSM tests validate against — mirror of reference_scalar_mul_kernel,
# test_msm_security.cu:100)
# -----------------------------------------------------------------------------

def scalar_mul(F, scalars, A, num_bits=255):
    """Batched double-and-add: scalars[i] * A[i].

    ``scalars``: (Ks, *batch) uint32 16-bit limbs, **standard form**.
    ``A``: affine batch.  Returns a Jacobian batch.  Constant-time MSB-first
    loop with per-bit cmov.
    """
    x, y, inf = A
    batch = F.batch_shape(x)
    acc0 = jac_identity(F, batch)
    scalars_j = jnp.asarray(scalars, dtype=jnp.uint32)

    def body(i, acc):
        bit_index = num_bits - 1 - i  # traced loop index
        limb = bit_index // 16
        shift = (bit_index % 16).astype(jnp.uint32)
        row = jax.lax.dynamic_index_in_dim(scalars_j, limb, axis=0, keepdims=False)
        bit = (row >> shift) & jnp.uint32(1)
        acc = jac_double(F, acc)
        added = jac_add_affine(F, acc, A)
        return jac_cmov(F, bit.astype(jnp.bool_), added, acc)

    return jax.lax.fori_loop(0, num_bits, body, acc0)


def is_in_subgroup(F, A, *, num_bits: int = 255):
    """Batched r-torsion membership: [r]P == O (with P on the curve).

    The reference documents subgroup checks but leaves them TODO
    (point.cuh:403-448); this is the working (if unoptimized) check —
    one constant-time 255-bit ladder per batch.  Identity counts as a
    member.  Returns a bool batch.
    """
    from .. import constants
    from ..fields.limbs import int_to_limbs

    r_limbs = jnp.asarray(
        int_to_limbs(constants.FR_MODULUS, 16), jnp.uint32)
    batch = F.batch_shape(A[0])
    scalars = jnp.broadcast_to(
        r_limbs.reshape((16,) + (1,) * len(batch)), (16,) + batch)
    rP = scalar_mul(F, scalars, A, num_bits=num_bits)
    return jac_is_identity(F, rP) | A[2]


def sum_reduce(F, P):
    """Tree-sum a Jacobian batch along its last batch axis -> batch without it.

    log2(n) rounds of pairwise jac_add (n padded to a power of two with
    identities).
    """
    tree = jax.tree_util
    X = P[0]
    leaf0 = tree.tree_leaves(X)[0]
    n = leaf0.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = m - n
        batch = F.batch_shape(X)[:-1] + (pad,)
        ident = jac_identity(F, batch)
        P = tree.tree_map(
            lambda c, i: jnp.concatenate([c, i], axis=-1), P, ident
        )
    while m > 1:
        half = m // 2
        left = tree.tree_map(lambda c: c[..., :half], P)
        right = tree.tree_map(lambda c: c[..., half:m], P)
        P = jac_add(F, left, right)
        m = half
    return tree.tree_map(lambda c: c[..., 0], P)
