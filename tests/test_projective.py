"""Complete projective group law (RCB16) vs the big-int oracle.

The projective path is the production MSM accumulator (msm/pippenger.py);
these tests pin its semantics: agreement with the oracle on generic
points, exception-freeness on every edge case the reference's cmov
chains handle explicitly (test_curve_operations.cu / point.cuh:610-915),
and round-trip consistency with the Jacobian representation.
"""


import jax
import jax.numpy as jnp
import pytest

from bls12_381_jax import constants, oracle
from bls12_381_jax.curves import g1, g2, points as pt, projective as pj
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER, FQ2_ADAPTER

R = constants.FR_MODULUS


def _g1_points(rng, n):
    G = oracle.g1_generator()
    return [
        oracle.jac_to_affine(
            oracle.scalar_mul(rng.randrange(1, R), G, oracle.FQ_OPS),
            oracle.FQ_OPS,
        )
        for _ in range(n)
    ]


def _g2_points(rng, n):
    G = oracle.g2_generator()
    return [
        oracle.jac_to_affine(
            oracle.scalar_mul(rng.randrange(1, R), G, oracle.FQ2_OPS),
            oracle.FQ2_OPS,
        )
        for _ in range(n)
    ]


def _o_add(a, b, FO):
    return oracle.jac_to_affine(
        oracle.jac_add(
            oracle.affine_to_jac(a, FO), oracle.affine_to_jac(b, FO), FO
        ),
        FO,
    )


def _o_dbl(a, FO):
    return oracle.jac_to_affine(
        oracle.jac_double(oracle.affine_to_jac(a, FO), FO), FO
    )


CURVES = {
    "g1": (FQ_ADAPTER, oracle.FQ_OPS, g1, _g1_points),
    "g2": (FQ2_ADAPTER, oracle.FQ2_OPS, g2, _g2_points),
}


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_add_double_mixed_match_oracle(rng, curve):
    F, FO, gmod, mk = CURVES[curve]
    n = 4 if curve == "g2" else 8
    pts = mk(rng, n)
    rot = pts[1:] + pts[:1]
    A = gmod.affine_from_ints(pts)
    B = gmod.affine_from_ints(rot)
    P = pj.affine_to_proj(F, A)
    Q = pj.affine_to_proj(F, B)
    to_ints = lambda S: gmod.jacobian_to_ints(pj.proj_to_jac(F, S))

    assert to_ints(pj.proj_add(F, P, Q)) == [
        _o_add(a, b, FO) for a, b in zip(pts, rot)
    ]
    want_dbl = [_o_dbl(a, FO) for a in pts]
    assert to_ints(pj.proj_double(F, P)) == want_dbl
    assert to_ints(pj.proj_add_mixed(F, P, B)) == [
        _o_add(a, b, FO) for a, b in zip(pts, rot)
    ]
    # completeness: the SAME formula handles P == Q (no doubling fallback)
    assert to_ints(pj.proj_add(F, P, P)) == want_dbl
    assert to_ints(pj.proj_add_mixed(F, P, A)) == want_dbl


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_edge_cases_exception_free(rng, curve):
    F, FO, gmod, mk = CURVES[curve]
    n = 2 if curve == "g2" else 4
    pts = mk(rng, n)
    A = gmod.affine_from_ints(pts)
    P = pj.affine_to_proj(F, A)
    ident = pj.proj_identity(F, (n,))
    to_ints = lambda S: gmod.jacobian_to_ints(pj.proj_to_jac(F, S))

    assert to_ints(pj.proj_add_mixed(F, ident, A)) == pts        # O + A
    Ainf = gmod.affine_from_ints([None] * n)
    assert to_ints(pj.proj_add_mixed(F, P, Ainf)) == pts         # P + inf
    negA = pt.affine_neg(F, A)
    assert to_ints(pj.proj_add_mixed(F, P, negA)) == [None] * n  # P - P
    assert to_ints(pj.proj_add(F, P, pj.proj_neg(F, P))) == [None] * n
    assert to_ints(pj.proj_add(F, P, ident)) == pts              # P + O
    assert to_ints(pj.proj_add(F, ident, ident)) == [None] * n   # O + O
    assert to_ints(pj.proj_double(F, ident)) == [None] * n       # 2O


def test_jac_proj_roundtrip(rng):
    F = FQ_ADAPTER
    pts = _g1_points(rng, 4)
    A = g1.affine_from_ints(pts)
    J = pt.affine_to_jac(F, A)
    J2 = pj.proj_to_jac(F, pj.jac_to_proj(F, J))
    assert bool(jnp.all(pt.jac_eq(F, J, J2)))
    # identity roundtrips too
    I = pt.jac_identity(F, (4,))
    I2 = pj.proj_to_jac(F, pj.jac_to_proj(F, I))
    assert bool(jnp.all(pt.jac_eq(F, I, I2)))
    # proj_to_affine agrees with the jacobian conversion
    got = g1.affine_to_ints(pj.proj_to_affine(F, pj.jac_to_proj(F, J)))
    assert got == pts
