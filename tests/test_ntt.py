"""NTT tests (parity with test_ntt_security.cu + tests/ntt_fft_comparison.rs):
bit-exact vs the big-int oracle (pinned root derivation), roundtrip,
zeros->zeros, linearity, convolution theorem, constant polynomial, batch,
coset, orderings, domain-size sweep.
"""

import numpy as np
import pytest

from bls12_381_jax import oracle, vecops
from bls12_381_jax.fields import FR, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints
from bls12_381_jax.ntt import Ordering, coset_intt, coset_ntt, get_domain, intt, ntt

R = FR.modulus


def enc(xs):
    return ops.to_mont(FR, ints_to_limbs(xs, FR.num_limbs))


def dec(v):
    return limbs_to_ints(np.asarray(ops.from_mont(FR, v)))


@pytest.mark.parametrize("log_n", [0, 1, 2, 4, 6, 8, 10])
def test_forward_matches_oracle(log_n, rng):
    n = 1 << log_n
    xs = [rng.randrange(R) for _ in range(n)]
    got = dec(ntt(enc(xs)))
    assert got == oracle.ntt(xs)


@pytest.mark.parametrize("log_n", [1, 3, 5, 9])
def test_roundtrip(log_n, rng):
    n = 1 << log_n
    xs = [rng.randrange(R) for _ in range(n)]
    assert dec(intt(ntt(enc(xs)))) == xs
    assert dec(ntt(intt(enc(xs)))) == xs


def test_inverse_matches_oracle(rng):
    xs = [rng.randrange(R) for _ in range(64)]
    assert dec(intt(enc(xs))) == oracle.ntt(xs, inverse=True)


def test_zeros_and_constant(rng):
    n = 32
    assert dec(ntt(enc([0] * n))) == [0] * n
    # constant poly -> [c*n? no: X[k] = c * sum(w^jk)] = [c, 0, ..] scaled:
    # NTT of delta: all-ones; NTT of constant c: [n*c, 0, ...]... forward of
    # constant vector gives c * N at k=0 and 0 elsewhere.
    c = rng.randrange(R)
    got = dec(ntt(enc([c] * n)))
    assert got[0] == c * n % R
    assert got[1:] == [0] * (n - 1)


def test_linearity(rng):
    n = 64
    xs = [rng.randrange(R) for _ in range(n)]
    ys = [rng.randrange(R) for _ in range(n)]
    a, b = rng.randrange(R), rng.randrange(R)
    lin = [(a * x + b * y) % R for x, y in zip(xs, ys)]
    fx, fy = oracle.ntt(xs), oracle.ntt(ys)
    want = [(a * u + b * v) % R for u, v in zip(fx, fy)]
    assert dec(ntt(enc(lin))) == want


def test_convolution_theorem(rng):
    """poly mul via NTT: intt(ntt(a) * ntt(b)) == a conv b (cyclic)."""
    n = 32
    ad = [rng.randrange(R) for _ in range(n // 2)] + [0] * (n // 2)
    bd = [rng.randrange(R) for _ in range(n // 2)] + [0] * (n // 2)
    fa, fb = ntt(enc(ad)), ntt(enc(bd))
    prod = intt(vecops.vector_mul(FR, fa, fb))
    got = dec(prod)
    want = [0] * n
    for i, x in enumerate(ad):
        for j, y in enumerate(bd):
            want[(i + j) % n] = (want[(i + j) % n] + x * y) % R
    assert got == want


def test_batch(rng):
    n, B = 64, 5
    data = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
    flat = [v for row in data for v in row]
    x = enc(flat).reshape(FR.num_limbs, B, n)
    out = ntt(x)
    got = limbs_to_ints(np.asarray(ops.from_mont(FR, out.reshape(FR.num_limbs, B * n))))
    want = [v for row in data for v in oracle.ntt(row)]
    assert got == want


def test_orderings(rng):
    n = 32
    xs = [rng.randrange(R) for _ in range(n)]
    nat = dec(ntt(enc(xs), Ordering.NN))
    rev = vecops.bit_reverse_indices(5)
    # NR: output bit-reversed
    nr = dec(ntt(enc(xs), Ordering.NR))
    assert nr == [nat[rev[i]] for i in range(n)]
    # RN: input bit-reversed
    xs_rev = [xs[rev[i]] for i in range(n)]
    rn = dec(ntt(enc(xs_rev), Ordering.RN))
    assert rn == nat
    # RR
    rr = dec(ntt(enc(xs_rev), Ordering.RR))
    assert rr == nr
    # roundtrip NR then RN
    assert dec(intt(ntt(enc(xs), Ordering.NR), Ordering.RN)) == xs


def test_coset(rng):
    n = 64
    shift = 5  # any unit works; reference uses a coset generator
    xs = [rng.randrange(R) for _ in range(n)]
    got = dec(coset_ntt(enc(xs), shift))
    assert got == oracle.coset_ntt(xs, shift)
    back = dec(coset_intt(coset_ntt(enc(xs), shift), shift))
    assert back == xs
    # coset evaluation sanity: first output = poly evaluated at `shift`
    poly_at_shift = sum(c * pow(shift, i, R) for i, c in enumerate(xs)) % R
    assert got[0] == poly_at_shift


def test_domain_reuse_and_release():
    from bls12_381_jax.ntt import release_domain

    d1 = get_domain(6)
    d2 = get_domain(6)
    assert d1 is d2
    release_domain(6)
    d3 = get_domain(6)
    assert d3 is not d1
    # omega pinned to reference derivation
    assert d3.omega == oracle.root_of_unity(6)
