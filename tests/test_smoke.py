"""Device smoke: one small MSM (plain + GLV) and one NTT vs the oracle.

Compiles the full staged Pippenger pipeline and the NTT ladder at tiny
shapes on whatever platform the suite runs on, and checks bit-exact
agreement with the big-int oracle (the reference's
test_msm_security.cu:100 role).  Kept deliberately small: a handful of
shapes so the compile bill stays in minutes.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants, oracle
from bls12_381_jax.curves import g1
from bls12_381_jax.fields import FR
from bls12_381_jax.fields.limbs import ints_to_limbs
from bls12_381_jax.msm import msm_g1

N = 128


def _fr_mont(vals):
    return jnp.asarray(
        ints_to_limbs([FR.to_mont(v % constants.FR_MODULUS) for v in vals],
                      FR.num_limbs))


@pytest.fixture(scope="module")
def fixture_points():
    rng = random.Random(0x5307E)
    ks = [rng.randrange(1, 1 << 48) for _ in range(N)]
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(k, G, oracle.FQ_OPS),
                                oracle.FQ_OPS) for k in ks]
    vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
    want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                oracle.FQ_OPS)
    return g1.affine_from_ints(pts), _fr_mont(vals), want


def _result(P):
    return g1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], P))[0]


class TestMsmSmoke:
    def test_plain_matches_oracle(self, fixture_points):
        A, sc, want = fixture_points
        assert _result(msm_g1(sc, A, glv=False)) == want

    def test_glv_matches_oracle(self, fixture_points):
        A, sc, want = fixture_points
        assert _result(msm_g1(sc, A, glv=True)) == want


class TestNttSmoke:
    def test_roundtrip_and_oracle(self):
        from bls12_381_jax.ntt import intt, ntt

        n = 256
        rng = random.Random(0x17E57)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
        x = _fr_mont(vals)
        y = ntt(x)
        xr = intt(y)
        assert np.array_equal(np.asarray(x), np.asarray(xr))
        # spot-check forward values against the oracle NTT
        from bls12_381_jax.fields import ops
        from bls12_381_jax.fields.limbs import limbs_to_ints

        got = limbs_to_ints(np.asarray(ops.from_mont(FR, y)))
        want = oracle.ntt(vals)
        assert got == want
