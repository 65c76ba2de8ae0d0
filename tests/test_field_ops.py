"""Field arithmetic property + KAT tests (parity with the reference's
test_field_properties.cu: commutativity, associativity, identity, inverse,
distributivity, sqr==mul, Montgomery roundtrip, proper reduction, small KATs).

Oracle: python big-int arithmetic.  Batched over random vectors.
"""

import numpy as np
import pytest

from bls12_381_jax.fields import FQ, FR, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints

SPECS = [FR, FQ]
N = 17  # deliberately non-power-of-two batch


def rand_elems(rng, spec, n=N, edge=True):
    xs = [rng.randrange(spec.modulus) for _ in range(n)]
    if edge and n >= 4:
        xs[0] = 0
        xs[1] = 1
        xs[2] = spec.modulus - 1
        xs[3] = spec.modulus // 2
    return xs


def to_dev(spec, xs):
    return ints_to_limbs(xs, spec.num_limbs)


def to_ints(arr):
    return limbs_to_ints(np.asarray(arr))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_add_sub_neg(spec, rng):
    p = spec.modulus
    xs, ys = rand_elems(rng, spec), rand_elems(rng, spec)
    a, b = to_dev(spec, xs), to_dev(spec, ys)
    assert to_ints(ops.add(spec, a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert to_ints(ops.sub(spec, a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert to_ints(ops.neg(spec, a)) == [(-x) % p for x in xs]
    # a + (-a) == 0
    z = ops.add(spec, a, ops.neg(spec, a))
    assert to_ints(z) == [0] * len(xs)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_mul_matches_oracle(spec, rng):
    p, R = spec.modulus, spec.r
    xs, ys = rand_elems(rng, spec), rand_elems(rng, spec)
    a, b = to_dev(spec, xs), to_dev(spec, ys)
    got = to_ints(ops.mont_mul(spec, a, b))
    want = [x * y * pow(R, -1, p) % p for x, y in zip(xs, ys)]
    assert got == want


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_sqr_matches_mul(spec, rng):
    xs = rand_elems(rng, spec)
    a = to_dev(spec, xs)
    assert to_ints(ops.mont_sqr(spec, a)) == to_ints(ops.mont_mul(spec, a, a))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_roundtrip(spec, rng):
    xs = rand_elems(rng, spec)
    a = to_dev(spec, xs)
    am = ops.to_mont(spec, a)
    assert to_ints(am) == [x * spec.r % spec.modulus for x in xs]
    back = ops.from_mont(spec, am)
    assert to_ints(back) == xs


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_axioms_mont_domain(spec, rng):
    """Commutativity/associativity/distributivity in the Montgomery domain."""
    p = spec.modulus
    xs, ys, zs = (rand_elems(rng, spec) for _ in range(3))
    a, b, c = (ops.to_mont(spec, to_dev(spec, v)) for v in (xs, ys, zs))
    ab = ops.mont_mul(spec, a, b)
    ba = ops.mont_mul(spec, b, a)
    assert to_ints(ab) == to_ints(ba)
    abc1 = ops.mont_mul(spec, ab, c)
    abc2 = ops.mont_mul(spec, a, ops.mont_mul(spec, b, c))
    assert to_ints(abc1) == to_ints(abc2)
    # a*(b+c) == a*b + a*c
    lhs = ops.mont_mul(spec, a, ops.add(spec, b, c))
    rhs = ops.add(spec, ab, ops.mont_mul(spec, a, c))
    assert to_ints(lhs) == to_ints(rhs)
    # identity
    one = ops.one_mont(spec, a.shape[1:])
    assert to_ints(ops.mont_mul(spec, a, one)) == to_ints(a)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_inverse(spec, rng):
    xs = rand_elems(rng, spec, n=6)
    a = ops.to_mont(spec, to_dev(spec, xs))
    ainv = ops.inv_mont(spec, a)
    prod = ops.mont_mul(spec, a, ainv)
    one = limbs_to_ints(np.asarray(ops.one_mont(spec, ())))[0] * 0 + 1
    got = to_ints(ops.from_mont(spec, prod))
    # inv(0) == 0 by convention -> product 0
    want = [0 if x == 0 else 1 for x in xs]
    assert got == want


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_small_kat(spec):
    """2 * 3 == 6 (the reference's sanity KAT) and (p-1)^2 == 1."""
    p = spec.modulus
    a = ops.to_mont(spec, to_dev(spec, [2, p - 1]))
    b = ops.to_mont(spec, to_dev(spec, [3, p - 1]))
    got = to_ints(ops.from_mont(spec, ops.mont_mul(spec, a, b)))
    assert got == [6, 1]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_cmov_and_is_zero(spec, rng):
    xs, ys = rand_elems(rng, spec), rand_elems(rng, spec)
    a, b = to_dev(spec, xs), to_dev(spec, ys)
    mask = np.array([i % 2 == 0 for i in range(len(xs))])
    import jax.numpy as jnp

    sel = ops.cmov(jnp.asarray(mask), a, b)
    assert to_ints(sel) == [x if m else y for x, y, m in zip(xs, ys, mask)]
    z = np.asarray(ops.is_zero(spec, a))
    assert list(z) == [x == 0 for x in xs]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_broadcast_and_shapes(spec, rng):
    """Ops work on multi-dim batches (K, R, L)."""
    xs = rand_elems(rng, spec, n=12, edge=False)
    a = to_dev(spec, xs).reshape(spec.num_limbs, 3, 4)
    s = ops.add(spec, a, a)
    assert s.shape == a.shape
    got = to_ints(np.asarray(s).reshape(spec.num_limbs, -1))
    assert got == [(2 * x) % spec.modulus for x in xs]


# -- the whole-array forms vs the independent unrolled forms ---------------


def _chain_values(spec):
    """Values whose sums, differences and products run carry and borrow
    chains through many limbs (runs of 0xFFFF and 0x0000 limbs)."""
    K, p = spec.num_limbs, spec.modulus
    vals = [0, 1, 2, p - 1, p - 2, p // 2]
    for k in (1, 5, K // 2, K - 2):
        vals += [(1 << (16 * k)) - 1, 1 << (16 * k), ((1 << (16 * k)) - 1) << 16]
    vals += [(p >> 16) << 16, p - (1 << (16 * (K - 2)))]
    return [v % p for v in vals]


def _form_inputs(spec, rng, n):
    chain = _chain_values(spec)
    xs = chain + [rng.randrange(spec.modulus) for _ in range(n - len(chain))]
    ys = list(reversed(chain)) + [
        rng.randrange(spec.modulus) for _ in range(n - len(chain))]
    # every chain value against 1 and against itself as well
    xs += chain + chain
    ys += [1] * len(chain) + chain
    return to_dev(spec, xs), to_dev(spec, ys)


_FORMS = {
    "mul": (lambda s, a, b: ops.mont_mul(s, a, b),
            lambda s, a, b: ops.mont_mul_unrolled(s, a, b)),
    "sqr": (lambda s, a, b: ops.mont_sqr(s, a),
            lambda s, a, b: ops.mont_sqr_unrolled(s, a)),
    "add": (lambda s, a, b: ops.add(s, a, b),
            lambda s, a, b: ops.add_unrolled_impl(s, a, b)),
    "sub": (lambda s, a, b: ops.sub(s, a, b),
            lambda s, a, b: ops.sub_unrolled_impl(s, a, b)),
}


@pytest.mark.parametrize("op", sorted(_FORMS))
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_whole_array_form_matches_unrolled(spec, op, rng):
    """Each op every caller uses is bit-identical to the independent
    unrolled form, on a batch (129 lanes plus chain cases) that is not a
    power of two, with carry and borrow chains across many limbs."""
    a, b = _form_inputs(spec, rng, 129)
    chosen, reference = _FORMS[op]
    np.testing.assert_array_equal(np.asarray(chosen(spec, a, b)),
                                  np.asarray(reference(spec, a, b)))
    assert all(v < spec.modulus for v in to_ints(chosen(spec, a, b)))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_mul_cios_matches_unrolled(rng, spec):
    """Default scan-based CIOS is bit-identical to the independent
    unrolled schoolbook+REDC implementation."""
    import jax.numpy as jnp

    n = 200
    a = jnp.asarray(to_dev(spec, rand_elems(rng, spec, n)))
    b = jnp.asarray(to_dev(spec, rand_elems(rng, spec, n)))
    got = ops.mont_mul(spec, a, b)  # cios (default)
    want = ops.mont_mul_unrolled(spec, a, b)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # edge values: 0, 1, p-1
    edge = [0, 1, spec.modulus - 1, spec.modulus - 1]
    ea = jnp.asarray(ints_to_limbs(edge, spec.num_limbs))
    eb = jnp.asarray(ints_to_limbs(list(reversed(edge)), spec.num_limbs))
    np.testing.assert_array_equal(
        np.asarray(ops.mont_mul(spec, ea, eb)),
        np.asarray(ops.mont_mul_unrolled(spec, ea, eb)))
    np.testing.assert_array_equal(
        np.asarray(ops.mont_sqr(spec, a)),
        np.asarray(ops.mont_sqr_unrolled(spec, a)))
