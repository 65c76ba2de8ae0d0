"""End-to-end prover-shaped pipeline: the library's pieces composed the way
a PLONK/KZG prover uses them (the analog of the reference's downstream
e2e proof benchmark, docs/gpu-integration/diffs-2df59557/
test_e2e_proof_benchmark.rs.diff).

Flow: SRS upload (+precompute) -> polynomial evaluation domain work
(coset NTT, pointwise vecops, inverse NTT) -> batched commitments
(batch MSM against cached bases, async) -> everything cross-checked
against the big-int oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants, oracle, vecops
from bls12_381_jax.curves import g1, points as pt
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
from bls12_381_jax.fields import FR, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints
from bls12_381_jax.ntt import coset_intt, coset_ntt
from bls12_381_jax.runtime import global_accelerator

R = constants.FR_MODULUS
N_BASES = 64   # shared with test_runtime/test_msm shapes (compile reuse)
N_POLY = 256   # shared with NTT test sizes


def _fr(vals):
    return jnp.asarray(ints_to_limbs([FR.to_mont(v % R) for v in vals],
                                     FR.num_limbs))


def _from_fr(arr):
    return limbs_to_ints(np.asarray(ops.from_mont(FR, arr)))


def test_prover_round_matches_oracle(rng):
    acc = global_accelerator()

    # --- SRS setup: powers-of-tau bases, uploaded + precomputed ----------
    tau = rng.randrange(1, R)
    G = oracle.g1_generator()
    srs_int = [oracle.jac_to_affine(
        oracle.scalar_mul(pow(tau, i, R), G, oracle.FQ_OPS), oracle.FQ_OPS)
        for i in range(N_BASES)]
    bases = acc.g1.upload_bases(g1.affine_from_ints(srs_int),
                                precompute_factor=2)

    # --- polynomial work on the evaluation domain -------------------------
    a = [rng.randrange(R) for _ in range(N_POLY)]
    b = [rng.randrange(R) for _ in range(N_POLY)]
    shift = 5  # coset generator (any non-root works for this domain size)
    ea = coset_ntt(_fr(a), shift)
    eb = coset_ntt(_fr(b), shift)
    prod_evals = vecops.vector_mul(FR, ea, eb)
    ab = _from_fr(coset_intt(prod_evals, shift))
    # oracle: coset-evaluate, multiply pointwise, interpolate
    oa = oracle.coset_ntt(a, shift)
    ob = oracle.coset_ntt(b, shift)
    want_ab = oracle.coset_ntt([x * y % R for x, y in zip(oa, ob)],
                               shift, inverse=True)
    assert ab == want_ab

    # --- batched commitments against the cached SRS (async) ---------------
    polys = [[v % R for v in ab[:N_BASES]],
             [rng.randrange(R) for _ in range(N_BASES)]]
    handle = acc.g1.msm_batch_async([_fr(p) for p in polys], bases)
    # ... host-side prover work would overlap here ...
    commits = handle.wait()
    for poly, C in zip(polys, commits):
        got = g1.jacobian_to_ints(
            jax.tree_util.tree_map(lambda c: c[..., None], C))[0]
        want = oracle.jac_to_affine(
            oracle.msm(poly, srs_int, oracle.FQ_OPS), oracle.FQ_OPS)
        assert got == want
        assert oracle.g1_is_on_curve(got)


def test_prover_round_under_memory_pressure(rng, monkeypatch):
    """K=20-shaped regression (scaled down): the cached-bases MSM must
    chunk itself when the consumer's own live buffers (SRS expansion, NTT
    domains, polys) eat most of the HBM budget — the composition that
    crashed the round-3 e2e K=20 leg.  The pressured run must be
    bit-identical to the unpressured one, and must actually have chunked.
    """
    from bls12_381_jax.msm import pippenger
    from bls12_381_jax.runtime.msm_context import g1_context

    ctx = g1_context()
    n = N_BASES
    tau = rng.randrange(1, R)
    G = oracle.g1_generator()
    srs_int = [oracle.jac_to_affine(
        oracle.scalar_mul(pow(tau, i, R), G, oracle.FQ_OPS), oracle.FQ_OPS)
        for i in range(n)]
    A = g1.affine_from_ints(srs_int)
    bases = ctx.upload_bases(A, precompute_factor=2, glv=True)
    poly = [rng.randrange(R) for _ in range(n)]
    want = ctx.msm_with_bases(_fr(poly), bases)
    want_ints = g1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], want))[0]

    # Consumer-held live buffer worth ~3/4 of the (mocked) budget: the
    # pipeline's own working set fits the nominal budget but NOT what is
    # left — exactly the round-3 failure shape.
    n_eff = bases.A[2].shape[-1]
    bpp = pippenger._msm_bytes_per_point(pippenger.FQ_ADAPTER)
    nominal = n_eff * bpp
    hog = jnp.zeros((3 * nominal // 4 // 4,), dtype=jnp.uint32)
    hog.block_until_ready()
    monkeypatch.setattr(pippenger, "_hbm_budget_bytes", lambda: nominal)

    calls = []
    core = pippenger._precomputed_window_sums
    monkeypatch.setattr(
        pippenger, "_precomputed_window_sums",
        lambda *a, **k: (calls.append(a[3]), core(*a, **k))[1])

    got = ctx.msm_with_bases(_fr(poly), bases)
    got_ints = g1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], got))[0]
    del hog
    assert len(calls) > 1, "budget pressure must have forced point chunks"
    assert got_ints == want_ints
    assert oracle.g1_is_on_curve(got_ints)
