"""GLV endomorphism (curves/glv.py) vs oracle.

Covers the reference's GLV block semantics (point_ops.cu:103-480):
eigenvalue relation phi(P) = lambda*P, exact scalar decomposition, and
the batched GLV scalar multiplication against the plain ladder/oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants, oracle
from bls12_381_jax.curves import g1, glv
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
from bls12_381_jax.fields import FR
from bls12_381_jax.fields.limbs import ints_to_limbs

R = constants.FR_MODULUS


def test_lambda_eigenvalue_constants():
    assert (glv.GLV_LAMBDA**2 + glv.GLV_LAMBDA + 1) % R == 0
    b = glv.beta()
    assert pow(b, 3, constants.FQ_MODULUS) == 1 and b != 1


def test_endomorphism_is_lambda_mul(rng):
    F = FQ_ADAPTER
    G = oracle.g1_generator()
    pts = [
        oracle.jac_to_affine(
            oracle.scalar_mul(rng.randrange(1, R), G, oracle.FQ_OPS),
            oracle.FQ_OPS,
        )
        for _ in range(4)
    ]
    A = g1.affine_from_ints(pts)
    phi = glv.endomorphism(F, A)
    got = g1.affine_to_ints(phi)
    want = [
        oracle.jac_to_affine(
            oracle.scalar_mul(glv.GLV_LAMBDA, p, oracle.FQ_OPS),
            oracle.FQ_OPS,
        )
        for p in pts
    ]
    assert got == want


def test_decompose_exact(rng):
    ks = [0, 1, glv.GLV_LAMBDA, R - 1] + [rng.randrange(R) for _ in range(12)]
    arr = jnp.asarray(ints_to_limbs(ks, FR.num_limbs))
    k1, k2 = glv.decompose(arr)
    from bls12_381_jax.fields.limbs import limbs_to_ints

    k1i = limbs_to_ints(np.asarray(k1))
    k2i = limbs_to_ints(np.asarray(k2))
    for k, a, b in zip(ks, k1i, k2i):
        assert a + b * glv.GLV_LAMBDA == k, (k, a, b)
        assert a < 1 << 128 and b < 1 << 128


def test_scalar_mul_glv_matches_oracle(rng):
    G = oracle.g1_generator()
    n = 6
    pts = [
        oracle.jac_to_affine(
            oracle.scalar_mul(rng.randrange(1, R), G, oracle.FQ_OPS),
            oracle.FQ_OPS,
        )
        for _ in range(n)
    ]
    ks = [0, 1] + [rng.randrange(R) for _ in range(n - 2)]
    A = g1.affine_from_ints(pts)
    arr = jnp.asarray(ints_to_limbs(ks, FR.num_limbs))
    out = glv.scalar_mul_glv(arr, A)
    got = g1.jacobian_to_ints(out)
    want = [
        oracle.jac_to_affine(oracle.scalar_mul(k, p, oracle.FQ_OPS),
                             oracle.FQ_OPS)
        if k != 0 and p is not None else None
        for k, p in zip(ks, pts)
    ]
    assert got == want
