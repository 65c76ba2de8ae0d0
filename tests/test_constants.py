"""KAT / constants validation (parity with test_known_answer_vectors.cu):
primality, 2-adicity, omega primitivity, generators on-curve and in-subgroup,
Montgomery constant derivations.
"""

import random

from bls12_381_jax import constants as C
from bls12_381_jax import oracle
from bls12_381_jax.fields import FQ, FR


def _is_prime(n, k=20):
    rnd = random.Random(1)
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(k):
        a = rnd.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def test_moduli_prime():
    assert _is_prime(C.FQ_MODULUS)
    assert _is_prime(C.FR_MODULUS)
    assert C.FQ_MODULUS.bit_length() == 381
    assert C.FR_MODULUS.bit_length() == 255


def test_fr_two_adicity():
    t = C.FR_MODULUS - 1
    s = 0
    while t % 2 == 0:
        t //= 2
        s += 1
    assert s == C.FR_TWO_ADICITY == 32


def test_omega_primitive():
    r = C.FR_MODULUS
    w = C.FR_OMEGA
    assert w == pow(C.FR_MULTIPLICATIVE_GENERATOR, (r - 1) >> 32, r)
    assert pow(w, 1 << 32, r) == 1
    assert pow(w, 1 << 31, r) == r - 1  # primitive, not a smaller-order root


def test_generators():
    assert oracle.g1_is_on_curve(oracle.g1_generator())
    assert oracle.g2_is_on_curve(oracle.g2_generator())
    # subgroup: r * G == identity
    assert oracle.scalar_mul(C.FR_MODULUS, oracle.g1_generator(), oracle.FQ_OPS) is None
    assert oracle.scalar_mul(C.FR_MODULUS, oracle.g2_generator(), oracle.FQ2_OPS) is None


def test_montgomery_constants():
    for spec in (FR, FQ):
        p = spec.modulus
        assert spec.r2 == (spec.r * spec.r) % p
        assert (spec.n0_inv * p) % (1 << 16) == (1 << 16) - 1  # -p^{-1} mod 2^16
        # limb arrays round-trip
        from bls12_381_jax.fields.limbs import limbs_to_int

        assert limbs_to_int(spec.modulus_limbs) == p
        assert limbs_to_int(spec.one_mont_limbs) == spec.r % p
    # Fr Montgomery R matches the reference's 2^256, Fq's 2^384
    assert FR.r == 1 << 256
    assert FQ.r == 1 << 384
