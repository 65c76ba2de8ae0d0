"""Vecops tests (parity with test_vec_ops.cu): algebra, edge cases
(single element, non-power-of-two, all-zero), batch inversion, bit-reverse
KATs — validated against the big-int oracle.
"""

import numpy as np
import pytest

from bls12_381_jax import vecops
from bls12_381_jax.fields import FQ, FR, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints


@pytest.mark.parametrize("spec", [FR, FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_vector_algebra(spec, n, rng):
    p = spec.modulus
    xs = [rng.randrange(p) for _ in range(n)]
    ys = [rng.randrange(p) for _ in range(n)]
    a = ops.to_mont(spec, ints_to_limbs(xs, spec.num_limbs))
    b = ops.to_mont(spec, ints_to_limbs(ys, spec.num_limbs))

    def dec(v):
        return limbs_to_ints(np.asarray(ops.from_mont(spec, v)))

    assert dec(vecops.vector_add(spec, a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert dec(vecops.vector_sub(spec, a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert dec(vecops.vector_mul(spec, a, b)) == [x * y % p for x, y in zip(xs, ys)]
    s = ops.to_mont(spec, ints_to_limbs([xs[0]], spec.num_limbs))[:, 0]
    assert dec(vecops.scalar_vec_mul(spec, s, b)) == [xs[0] * y % p for y in ys]
    assert dec(vecops.scalar_vec_add(spec, s, b)) == [(xs[0] + y) % p for y in ys]


@pytest.mark.parametrize("spec", [FR, FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("n", [1, 3, 100, 4096])
def test_batch_inverse(spec, n, rng):
    p = spec.modulus
    xs = [rng.randrange(p) for _ in range(n)]
    if n >= 3:
        xs[1] = 0  # inv(0) = 0 convention
    a = ops.to_mont(spec, ints_to_limbs(xs, spec.num_limbs))
    inv = vecops.batch_inverse(spec, a)
    got = limbs_to_ints(np.asarray(ops.from_mont(spec, inv)))
    want = [0 if x == 0 else pow(x, p - 2, p) for x in xs]
    assert got == want


def test_batch_inverse_all_zero():
    a = ops.zeros(FR, (7,))
    inv = vecops.batch_inverse(FR, a)
    assert limbs_to_ints(np.asarray(inv)) == [0] * 7


def test_bit_reverse_kat():
    # size 8: [0,4,2,6,1,5,3,7]
    idx = vecops.bit_reverse_indices(3)
    assert list(idx) == [0, 4, 2, 6, 1, 5, 3, 7]
    x = ints_to_limbs(list(range(8)), FR.num_limbs)
    y = vecops.bit_reverse(x)
    assert limbs_to_ints(np.asarray(y)) == [0, 4, 2, 6, 1, 5, 3, 7]
    # involution
    z = vecops.bit_reverse(y)
    assert limbs_to_ints(np.asarray(z)) == list(range(8))


def test_vector_sum_matches_oracle(rng):
    """Partial-sum reduction analog (vec_ops.cu:336-390)."""
    import numpy as np
    import jax.numpy as jnp

    from bls12_381_jax import vecops
    from bls12_381_jax.fields import FR, ops
    from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints

    for n in (1, 7, 64):
        vals = [rng.randrange(FR.modulus) for _ in range(n)]
        v = jnp.asarray(ints_to_limbs([FR.to_mont(x) for x in vals],
                                      FR.num_limbs))
        got = limbs_to_ints(np.asarray(
            ops.from_mont(FR, vecops.vector_sum(FR, v)[:, None])))[0]
        assert got == sum(vals) % FR.modulus


def test_adapter_wide_inv_matches_fermat(rng):
    """FqAdapter.inv routes wide batches through Montgomery's trick
    (one Fermat ladder per lane is wasted work at (24, 2^20)); both
    paths must agree bit-exactly."""
    import jax.numpy as jnp

    from bls12_381_jax import constants
    from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
    from bls12_381_jax.fields import FQ, ops
    from bls12_381_jax.fields.limbs import ints_to_limbs

    n = 4096  # exactly at the batch-inversion threshold
    vals = [rng.randrange(constants.FQ_MODULUS) for _ in range(24)]
    arr = jnp.asarray(ints_to_limbs([FQ.to_mont(v) for v in vals],
                                    FQ.num_limbs))
    wide = jnp.tile(arr, (1, n // 24 + 1))[:, :n]
    got = FQ_ADAPTER.inv(wide)
    want = ops.inv_mont(FQ, wide[:, :24])
    np.testing.assert_array_equal(np.asarray(got[:, :24]), np.asarray(want))
