"""Curve group-law tests (parity with test_curve_operations.cu and
test_security_edge_cases.cu): identity, inverse, commutativity,
associativity, doubling consistency, on-curve preservation, mixed-add
edge cases, scalar multiplication vs the big-int oracle.
"""

import numpy as np
import pytest

from bls12_381_jax import oracle
from bls12_381_jax.curves import g1, g2, points
from bls12_381_jax.fields.limbs import ints_to_limbs

N = 9


def rand_g1(rng, n=N):
    """Random affine G1 points (as multiples of the generator) + oracle copies."""
    ks = [rng.randrange(1, oracle.R) for _ in range(n)]
    pts = [
        oracle.jac_to_affine(oracle.scalar_mul(k, oracle.g1_generator(), oracle.FQ_OPS), oracle.FQ_OPS)
        for k in ks
    ]
    return pts


def rand_g2(rng, n=N):
    ks = [rng.randrange(1, oracle.R) for _ in range(n)]
    return [
        oracle.jac_to_affine(oracle.scalar_mul(k, oracle.g2_generator(), oracle.FQ2_OPS), oracle.FQ2_OPS)
        for k in ks
    ]


CURVES = [
    ("g1", g1, oracle.FQ_OPS, rand_g1, oracle.g1_is_on_curve),
    ("g2", g2, oracle.FQ2_OPS, rand_g2, oracle.g2_is_on_curve),
]


@pytest.mark.parametrize("name,mod,ofield,randp,oncurve", CURVES, ids=["g1", "g2"])
def test_add_double_vs_oracle(name, mod, ofield, randp, oncurve, rng):
    F = mod.F
    pts_a = randp(rng)
    pts_b = randp(rng)
    A = mod.affine_from_ints(pts_a)
    B = mod.affine_from_ints(pts_b)
    Pj = points.affine_to_jac(F, A)
    Qj = points.affine_to_jac(F, B)
    # add
    S = points.jac_add(F, Pj, Qj)
    got = mod.jacobian_to_ints(S)
    want = [
        oracle.jac_to_affine(
            oracle.jac_add(oracle.affine_to_jac(p, ofield), oracle.affine_to_jac(q, ofield), ofield),
            ofield,
        )
        for p, q in zip(pts_a, pts_b)
    ]
    assert got == want
    # double
    D = points.jac_double(F, Pj)
    got = mod.jacobian_to_ints(D)
    want = [
        oracle.jac_to_affine(oracle.jac_double(oracle.affine_to_jac(p, ofield), ofield), ofield)
        for p in pts_a
    ]
    assert got == want
    # mixed add matches full add
    M = points.jac_add_affine(F, Pj, B)
    assert mod.jacobian_to_ints(M) == mod.jacobian_to_ints(S)
    # results on curve
    oc = points.is_on_curve_jacobian(F, S, mod.b_mont(F.batch_shape(S[0])))
    assert bool(np.asarray(oc).all())


@pytest.mark.parametrize("name,mod,ofield,randp,oncurve", CURVES, ids=["g1", "g2"])
def test_group_laws(name, mod, ofield, randp, oncurve, rng):
    F = mod.F
    A = mod.affine_from_ints(randp(rng))
    B = mod.affine_from_ints(randp(rng))
    P = points.affine_to_jac(F, A)
    Q = points.affine_to_jac(F, B)
    # commutativity
    assert bool(np.asarray(points.jac_eq(F, points.jac_add(F, P, Q), points.jac_add(F, Q, P))).all())
    # identity
    I = points.jac_identity(F, F.batch_shape(P[0]))
    assert bool(np.asarray(points.jac_eq(F, points.jac_add(F, P, I), P)).all())
    assert bool(np.asarray(points.jac_eq(F, points.jac_add(F, I, P), P)).all())
    # inverse: P + (-P) = identity
    Z = points.jac_add(F, P, points.jac_neg(F, P))
    assert bool(np.asarray(points.jac_is_identity(F, Z)).all())
    # P == P edge of full add == doubling
    assert bool(np.asarray(points.jac_eq(F, points.jac_add(F, P, P), points.jac_double(F, P))).all())
    # double(identity) == identity
    assert bool(np.asarray(points.jac_is_identity(F, points.jac_double(F, I))).all())


@pytest.mark.parametrize("name,mod,ofield,randp,oncurve", CURVES, ids=["g1", "g2"])
def test_mixed_add_edges(name, mod, ofield, randp, oncurve, rng):
    F = mod.F
    pts = randp(rng, 4)
    A = mod.affine_from_ints(pts)
    P = points.affine_to_jac(F, A)
    # identity + affine = affine
    I = points.jac_identity(F, F.batch_shape(P[0]))
    R = points.jac_add_affine(F, I, A)
    assert mod.jacobian_to_ints(R) == pts
    # P + affine(-P) = identity
    R = points.jac_add_affine(F, P, points.affine_neg(F, A))
    assert bool(np.asarray(points.jac_is_identity(F, R)).all())
    # P + same affine = double
    R = points.jac_add_affine(F, P, A)
    assert bool(np.asarray(points.jac_eq(F, R, points.jac_double(F, P))).all())
    # P + infinity-masked affine = P
    Ainf = mod.affine_from_ints([None] * 4)
    R = points.jac_add_affine(F, P, Ainf)
    assert bool(np.asarray(points.jac_eq(F, R, P)).all())


@pytest.mark.parametrize("name,mod,ofield,randp,oncurve", CURVES, ids=["g1", "g2"])
def test_affine_roundtrip(name, mod, ofield, randp, oncurve, rng):
    F = mod.F
    pts = randp(rng, 5) + [None]
    A = mod.affine_from_ints(pts)
    P = points.affine_to_jac(F, A)
    back = mod.jacobian_to_ints(P)
    assert back == pts


@pytest.mark.parametrize("name,mod,ofield,randp,oncurve", CURVES, ids=["g1", "g2"])
def test_scalar_mul_vs_oracle(name, mod, ofield, randp, oncurve, rng):
    F = mod.F
    pts = randp(rng, 5)
    ks = [0, 1, 2, rng.randrange(oracle.R), oracle.R - 1]
    A = mod.affine_from_ints(pts)
    scal = ints_to_limbs(ks, 16)
    P = points.scalar_mul(F, np.asarray(scal), A)
    got = mod.jacobian_to_ints(P)
    want = [
        oracle.jac_to_affine(oracle.scalar_mul(k, p, ofield), ofield)
        for k, p in zip(ks, pts)
    ]
    assert got == want


def test_sum_reduce_g1(rng):
    F = g1.F
    pts = rand_g1(rng, 7)  # non-power-of-two
    A = g1.affine_from_ints(pts)
    P = points.affine_to_jac(F, A)
    S = points.sum_reduce(F, P)
    got = g1.affine_to_ints(points.jac_to_affine(F, tuple(c[..., None] for c in S)))
    acc = None
    for p in pts:
        acc = oracle.jac_add(acc, oracle.affine_to_jac(p, oracle.FQ_OPS), oracle.FQ_OPS)
    want = [oracle.jac_to_affine(acc, oracle.FQ_OPS)]
    assert got == want


def test_subgroup_membership(rng):
    """[r]P == O check (reference leaves this TODO, point.cuh:403-448)."""
    from bls12_381_jax import constants, oracle
    from bls12_381_jax.curves import g1
    from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
    from bls12_381_jax.curves.points import is_in_subgroup

    import jax.numpy as jnp

    P_MOD = constants.FQ_MODULUS
    R = constants.FR_MODULUS
    G = oracle.g1_generator()
    members = [
        oracle.jac_to_affine(
            oracle.scalar_mul(rng.randrange(1, R), G, oracle.FQ_OPS),
            oracle.FQ_OPS,
        )
        for _ in range(2)
    ]
    # a curve point outside G1: random x with y^2 = x^3 + 4 square; the
    # odds of landing in the r-torsion are ~1/h ~ 2^-125
    non_members = []
    x = 5
    while len(non_members) < 2:
        rhs = (x * x * x + 4) % P_MOD
        y = pow(rhs, (P_MOD + 1) // 4, P_MOD)  # p = 3 mod 4
        if (y * y) % P_MOD == rhs:
            non_members.append((x, y))
        x += 1
    A = g1.affine_from_ints(members + non_members + [None])
    got = is_in_subgroup(FQ_ADAPTER, A)
    assert list(map(bool, got)) == [True, True, False, False, True]
