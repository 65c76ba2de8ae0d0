"""Complete homogeneous-projective group law (Renes-Costello-Batina 2016)
for short-Weierstrass a=0 curves.

The reference makes its Jacobian formulas "complete" by computing the
generic add AND a full doubling, then cmov-selecting between them plus
identity edge cases (point.cuh:610-915).  That is ~19 field-multiply
equivalents per mixed add.  The RCB16 complete formulas over homogeneous
projective coordinates (X : Y : Z), x = X/Z, y = Y/Z, need no case
analysis at all: one straight-line formula is correct for *every* input
pair, including doublings and identities (identity = (0 : 1 : 0), which
projective coordinates can represent).

Completeness condition: the formulas are exception-free on any curve
group of odd order.  For BLS12-381 both |E(Fq)| = h1*r and |E'(Fq2)| =
h2*r are odd (h1 = 0x396c...aaab, h2 = 0x5d54...8e5 — both odd
cofactors, r odd), so they are complete for ALL curve points, not just
the r-torsion subgroup.  This also preserves the reference's
constant-time discipline by construction — there is no branch to leak.

Costs (M = field mul, S = square, small = mul by 3b):
* add       (alg 7):  12M + 2 small
* mixed add (alg 8):  11M + 2 small   (vs ~19M-equiv for the cmov chain)
* double    (alg 9):   6M + 2S + 1 small

3b: G1 has b = 4 so 3b = 12 (4 add-chains); G2 has b' = 4(1+u) so
3b' = 12(1+u), i.e. (c0, c1) -> 12*(c0 - c1, c0 + c1).

Element layout matches points.py: batched limbs-first field elements via
the same adapters; a projective point is an (X, Y, Z) tuple.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .field_adapters import FQ2_ADAPTER


# -----------------------------------------------------------------------------
# mul-by-3b per curve
# -----------------------------------------------------------------------------


def _mul12(F, a):
    """12a = 4 * 3a via double/add chains (cheap vs a full multiply)."""
    t = F.add(F.double(a), a)  # 3a
    return F.double(F.double(t))


def mul_b3_g1(F, a):
    """3b = 12 for G1 (b = 4)."""
    return _mul12(F, a)


def mul_b3_g2(F2, a):
    """3b' = 12(1+u) for G2: (c0, c1) -> 12*(c0 - c1, c0 + c1)."""
    Fb = F2.base
    return (_mul12(Fb, Fb.sub(a[0], a[1])), _mul12(Fb, Fb.add(a[0], a[1])))


def mul_b3_for(F):
    if F is FQ2_ADAPTER or isinstance(F, type(FQ2_ADAPTER)):
        return mul_b3_g2
    return mul_b3_g1


# -----------------------------------------------------------------------------
# Point plumbing
# -----------------------------------------------------------------------------


def proj_identity(F, batch_shape=()):
    """(0 : 1 : 0)."""
    return (F.zero(batch_shape), F.one(batch_shape), F.zero(batch_shape))


def proj_is_identity(F, P):
    return F.is_zero(P[2])


def proj_cmov(F, mask, P, Q):
    return tuple(F.cmov(mask, p, q) for p, q in zip(P, Q))


def proj_neg(F, P):
    return (P[0], F.neg(P[1]), P[2])


def affine_to_proj(F, A):
    """(x, y, inf) -> (x : y : 1), identity -> (0 : 1 : 0)."""
    x, y, inf = A
    batch = F.batch_shape(x)
    one = F.one(batch)
    zero = F.zero(batch)
    return (
        F.cmov(inf, zero, x),
        F.cmov(inf, one, y),
        F.cmov(inf, zero, one),
    )


def proj_to_affine(F, P):
    """(X : Y : Z) -> (X/Z, Y/Z, inf = Z==0)."""
    X, Y, Z = P
    inf = F.is_zero(Z)
    batch = F.batch_shape(X)
    Zs = F.cmov(inf, F.one(batch), Z)
    zi = F.inv(Zs)
    zero = F.zero(batch)
    return (
        F.cmov(inf, zero, F.mul(X, zi)),
        F.cmov(inf, zero, F.mul(Y, zi)),
        inf,
    )


def proj_to_jac(F, P):
    """(X : Y : Z) homog -> (XZ, YZ^2, Z) Jacobian (same affine point;
    identity Z=0 maps to Jacobian identity Z=0)."""
    X, Y, Z = P
    Z2 = F.sqr(Z)
    return (F.mul(X, Z), F.mul(Y, Z2), Z)


def jac_to_proj(F, P):
    """(X, Y, Z) Jacobian -> (XZ : Y : Z^3) homogeneous."""
    X, Y, Z = P
    Z3 = F.mul(F.sqr(Z), Z)
    J = (F.mul(X, Z), Y, Z3)
    # Jacobian identity (Z=0) may carry arbitrary X/Y; canonicalize.
    return proj_cmov(F, F.is_zero(P[2]), proj_identity(F, F.batch_shape(X)), J)


# -----------------------------------------------------------------------------
# RCB16 complete formulas (a = 0); algorithm numbers from the paper.
# -----------------------------------------------------------------------------


def proj_add(F, P, Q, mul_b3=None):
    """Complete addition, RCB16 algorithm 7 (a=0, 12M + 2 small)."""
    mul_b3 = mul_b3 or mul_b3_for(F)
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t3 = F.sub(t3, F.add(t0, t1))                    # X1Y2 + X2Y1
    t4 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t4 = F.sub(t4, F.add(t1, t2))                    # Y1Z2 + Y2Z1
    X3 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    Y3 = F.sub(X3, F.add(t0, t2))                    # X1Z2 + X2Z1
    X3 = F.add(F.double(t0), t0)                     # 3 X1X2
    t2 = mul_b3(F, t2)                               # 3b Z1Z2
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = mul_b3(F, Y3)                               # 3b (X1Z2 + X2Z1)
    X3_out = F.sub(F.mul(t3, t1), F.mul(t4, Y3))
    Y3_out = F.add(F.mul(t1, Z3), F.mul(Y3, X3))
    Z3_out = F.add(F.mul(Z3, t4), F.mul(X3, t3))
    return (X3_out, Y3_out, Z3_out)


def proj_add_mixed(F, P, A, mul_b3=None):
    """Complete mixed addition, RCB16 algorithm 8 (Z2 = 1, 11M + 2 small).

    ``A = (x2, y2, inf2)``: the formula is complete for every on-curve
    (x2, y2); the affine encoding cannot represent the identity, so the
    ``inf2`` mask selects P through (the only cmov left — vs the
    four-case chain of the Jacobian path, points.py:108-139).
    """
    mul_b3 = mul_b3 or mul_b3_for(F)
    X1, Y1, Z1 = P
    x2, y2, inf2 = A
    t0 = F.mul(X1, x2)
    t1 = F.mul(Y1, y2)
    t3 = F.mul(F.add(X1, Y1), F.add(x2, y2))
    t3 = F.sub(t3, F.add(t0, t1))                    # X1y2 + x2Y1
    t4 = F.add(F.mul(x2, Z1), X1)                    # x2 Z1 + X1
    t5 = F.add(F.mul(y2, Z1), Y1)                    # y2 Z1 + Y1
    X3 = F.add(F.double(t0), t0)                     # 3 X1x2
    t2 = mul_b3(F, Z1)                               # 3b Z1
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = mul_b3(F, t4)                               # 3b (x2Z1 + X1)
    X3_out = F.sub(F.mul(t3, t1), F.mul(t5, Y3))
    Y3_out = F.add(F.mul(t1, Z3), F.mul(Y3, X3))
    Z3_out = F.add(F.mul(Z3, t5), F.mul(X3, t3))
    R = (X3_out, Y3_out, Z3_out)
    return proj_cmov(F, inf2, P, R)


def proj_double(F, P, mul_b3=None):
    """Complete doubling, RCB16 algorithm 9 (a=0, 6M + 2S + 1 small)."""
    mul_b3 = mul_b3 or mul_b3_for(F)
    X, Y, Z = P
    t0 = F.sqr(Y)
    Z3 = F.double(F.double(F.double(t0)))            # 8 Y^2
    t1 = F.mul(Y, Z)
    t2 = mul_b3(F, F.sqr(Z))                         # 3b Z^2
    X3 = F.mul(t2, Z3)
    Y3 = F.add(t0, t2)
    Z3 = F.mul(t1, Z3)
    t2 = F.add(F.double(t2), t2)                     # 9b Z^2
    t0 = F.sub(t0, t2)
    Y3 = F.add(F.mul(t0, Y3), X3)
    X3 = F.double(F.mul(t0, F.mul(X, Y)))
    return (X3, Y3, Z3)


def proj_eq(F, P, Q):
    """Cross-multiplied projective equality."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    ex = F.eq(F.mul(X1, Z2), F.mul(X2, Z1))
    ey = F.eq(F.mul(Y1, Z2), F.mul(Y2, Z1))
    id1 = proj_is_identity(F, P)
    id2 = proj_is_identity(F, Q)
    return (id1 & id2) | (~id1 & ~id2 & ex & ey)


def proj_add_mixed_signed(F, P, A, sign):
    """proj_add_mixed with a per-lane conditional negation of A's y folded
    in (sign=True adds -A) — the MSM row scan's signed-digit add."""
    x2, y2, inf2 = A
    return proj_add_mixed(F, P, (x2, F.cmov(sign, F.neg(y2), y2), inf2))
