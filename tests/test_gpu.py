"""Checks that need a GPU (marker ``gpu``): they skip elsewhere, and
``python chip_smoke.py`` runs them on the card after its phases."""

import random

import numpy as np
import pytest

from bls12_381_jax.fields import FQ, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints
from bls12_381_jax.msm import pippenger

pytestmark = pytest.mark.gpu


def test_msm_budget_follows_card_memory(gpu, monkeypatch):
    monkeypatch.delenv("MIDNIGHT_MSM_HBM_BUDGET_MB", raising=False)
    limit = gpu.memory_stats()["bytes_limit"]
    assert limit > 0
    assert pippenger._hbm_budget_bytes() == int(
        limit * pippenger.MSM_BUDGET_FRACTION)


def test_field_ops_exact_on_card(gpu):
    """The Fq ops as XLA compiles them for the GPU agree with big-int
    arithmetic, chains of 0xFFFF limbs included."""
    import jax
    import jax.numpy as jnp

    rng = random.Random(7)
    p = FQ.modulus
    chain = [0, 1, p - 1, (1 << (16 * 12)) - 1, 1 << (16 * 20), p // 2]
    xs = chain + [rng.randrange(p) for _ in range(1000)]
    ys = [1] * len(chain) + [rng.randrange(p) for _ in range(1000)]
    a = jnp.asarray(ints_to_limbs(xs, FQ.num_limbs))
    b = jnp.asarray(ints_to_limbs(ys, FQ.num_limbs))
    r_inv = pow(1 << (16 * FQ.num_limbs), -1, p)
    for op, want in (
            (ops.mont_mul, [x * y * r_inv % p for x, y in zip(xs, ys)]),
            (ops.add, [(x + y) % p for x, y in zip(xs, ys)]),
            (ops.sub, [(x - y) % p for x, y in zip(xs, ys)])):
        got = jax.jit(lambda u, v: op(FQ, u, v))(a, b)
        assert limbs_to_ints(np.asarray(got)) == want
