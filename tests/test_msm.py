"""Single-chip MSM security/correctness suite.

Re-creation of the reference's `test_msm_security.cu` battery (SURVEY.md
§4.1): 1*G = G, 0*G = O, all-ones = sum(bases), mixed zero scalars,
single point, determinism, and equivalence against the independent
double-and-add oracle — for G1 and G2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants, oracle
from bls12_381_jax.curves import g1, g2, points as pt
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER, FQ2_ADAPTER
from bls12_381_jax.fields import FR
from bls12_381_jax.fields.limbs import ints_to_limbs
from bls12_381_jax.msm import msm_g1, msm_g2

N = 64  # shared with test_runtime so staged jits compile once per shape


def _fr_mont(vals):
    return jnp.asarray(
        ints_to_limbs([FR.to_mont(v % constants.FR_MODULUS) for v in vals],
                      FR.num_limbs))


def _g1_points(rng, n):
    ks = [rng.randrange(1, 1 << 48) for _ in range(n)]
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(k, G, oracle.FQ_OPS),
                                oracle.FQ_OPS) for k in ks]
    return g1.affine_from_ints(pts), pts


def _g1_result(P):
    return g1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], P))[0]


def _g2_result(P):
    return g2.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], P))[0]


class TestG1MsmVectors:
    def test_matches_oracle(self, rng):
        A, pts = _g1_points(rng, N)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
        got = _g1_result(msm_g1(_fr_mont(vals), A))
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        assert got == want

    def test_one_times_g_is_g(self, rng):
        A, pts = _g1_points(rng, N)
        vals = [1] + [0] * (N - 1)
        assert _g1_result(msm_g1(_fr_mont(vals), A)) == pts[0]

    def test_all_zero_scalars_is_identity(self, rng):
        A, _ = _g1_points(rng, N)
        assert _g1_result(msm_g1(_fr_mont([0] * N), A)) is None

    def test_all_ones_is_sum_of_bases(self, rng):
        A, pts = _g1_points(rng, N)
        got = _g1_result(msm_g1(_fr_mont([1] * N), A))
        acc = None
        for p in pts:
            acc = oracle.jac_add_affine(acc, p, oracle.FQ_OPS)
        assert got == oracle.jac_to_affine(acc, oracle.FQ_OPS)

    def test_mixed_zero_scalars(self, rng):
        A, pts = _g1_points(rng, N)
        vals = [0 if i % 3 else rng.randrange(constants.FR_MODULUS)
                for i in range(N)]
        got = _g1_result(msm_g1(_fr_mont(vals), A))
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        assert got == want

    def test_identity_points_in_input(self, rng):
        _, pts = _g1_points(rng, N)
        pts = [None if i % 5 == 0 else p for i, p in enumerate(pts)]
        A = g1.affine_from_ints(pts)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
        got = _g1_result(msm_g1(_fr_mont(vals), A))
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        assert got == want

    def test_determinism(self, rng):
        A, _ = _g1_points(rng, N)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
        sc = _fr_mont(vals)
        r1 = msm_g1(sc, A)
        r2 = msm_g1(sc, A)
        for a, b in zip(jax.tree_util.tree_leaves(r1),
                        jax.tree_util.tree_leaves(r2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_scalar_near_modulus(self, rng):
        """r-1 = -1: exercises the signed-digit top carry path."""
        A, pts = _g1_points(rng, N)
        vals = [constants.FR_MODULUS - 1] + [0] * (N - 1)
        got = _g1_result(msm_g1(_fr_mont(vals), A))
        want = oracle.jac_to_affine(
            oracle.jac_neg(oracle.affine_to_jac(pts[0], oracle.FQ_OPS),
                           oracle.FQ_OPS), oracle.FQ_OPS)
        assert got == want

    def test_window_override_agrees(self, rng):
        A, pts = _g1_points(rng, N)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
        base = _g1_result(msm_g1(_fr_mont(vals), A))
        for w in (6, 9):
            assert _g1_result(msm_g1(_fr_mont(vals), A, window_bits=w)) == base


class TestG1MsmGlv:
    """GLV-split MSM: [k1 || k2] against [A || phi(A)], 128-bit windows."""

    def test_matches_plain(self, rng):
        from bls12_381_jax.curves.glv import GLV_LAMBDA

        A, pts = _g1_points(rng, N)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N - 6)]
        # decomposition edge scalars: 0, 1, lambda +- 1, r-1, lambda
        vals += [0, 1, GLV_LAMBDA - 1, GLV_LAMBDA + 1,
                 constants.FR_MODULUS - 1, GLV_LAMBDA]
        sc = _fr_mont(vals)
        got = _g1_result(msm_g1(sc, A, glv=True))
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        assert got == want

    def test_identity_points_and_zeros(self, rng):
        _, pts = _g1_points(rng, N)
        pts = [None if i % 5 == 0 else p for i, p in enumerate(pts)]
        A = g1.affine_from_ints(pts)
        vals = [0 if i % 3 == 0 else rng.randrange(constants.FR_MODULUS)
                for i in range(N)]
        got = _g1_result(msm_g1(_fr_mont(vals), A, glv=True))
        live = [(v, p) for v, p in zip(vals, pts) if p is not None]
        want = oracle.jac_to_affine(
            oracle.msm([v for v, _ in live], [p for _, p in live],
                       oracle.FQ_OPS), oracle.FQ_OPS)
        assert got == want

    def test_precomputed_bases_glv(self, rng):
        """upload_bases(glv=True) stores [A || phi(A)]; factor composes."""
        from bls12_381_jax.runtime.msm_context import g1_context

        ctx = g1_context()
        A, pts = _g1_points(rng, N)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        for factor in (1, 2):
            bases = ctx.upload_bases(A, precompute_factor=factor, glv=True)
            assert bases.glv and bases.n == N
            got = _g1_result(ctx.msm_with_bases(_fr_mont(vals), bases))
            assert got == want, f"factor={factor}"

    def test_batch_shared_glv(self, rng):
        from bls12_381_jax.runtime.msm_context import g1_context

        ctx = g1_context()
        A, pts = _g1_points(rng, N)
        bases = ctx.upload_bases(A, precompute_factor=1, glv=True)
        sets = [[rng.randrange(constants.FR_MODULUS) for _ in range(N)]
                for _ in range(3)]
        outs = ctx.msm_batch([_fr_mont(v) for v in sets], bases)
        for vals, P in zip(sets, outs):
            want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                        oracle.FQ_OPS)
            assert _g1_result(P) == want

    def test_env_flag_routes(self, rng, monkeypatch):
        from bls12_381_jax.runtime import reset_config_cache

        A, pts = _g1_points(rng, 16)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(16)]
        monkeypatch.setenv("MIDNIGHT_MSM_GLV", "1")
        reset_config_cache()
        try:
            got = _g1_result(msm_g1(_fr_mont(vals), A))
        finally:
            monkeypatch.delenv("MIDNIGHT_MSM_GLV")
            reset_config_cache()
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        assert got == want


class TestMemoryChunking:
    """HBM-budget chunking (core/msm.rs:1136-1141 analog + the 2^24 path):
    a tiny MIDNIGHT_MSM_HBM_BUDGET_MB forces the sequential split, which
    must be bit-identical to the single-shot pipeline."""

    def test_single_msm_chunked_matches(self, rng, monkeypatch):
        from bls12_381_jax.msm import pippenger

        A, pts = _g1_points(rng, N)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
        want = _g1_result(msm_g1(_fr_mont(vals), A))
        bpp = pippenger._msm_bytes_per_point(pippenger.FQ_ADAPTER)
        # budget for ~N/4 points -> 4 sequential pieces
        monkeypatch.setattr(pippenger, "_hbm_budget_bytes",
                            lambda: (N // 4) * bpp)
        got = _g1_result(msm_g1(_fr_mont(vals), A))
        assert got == want

    def test_expand_bases_chunked_matches(self, rng, monkeypatch):
        from bls12_381_jax.msm import pippenger

        A, _ = _g1_points(rng, N)
        w = pippenger.window_bits_for(N, FQ_ADAPTER)
        want = pippenger.expand_bases(FQ_ADAPTER, A, w, 2)
        monkeypatch.setenv("MIDNIGHT_EXPAND_CHUNK_LOG", "4")  # 16-pt slices
        got = pippenger.expand_bases(FQ_ADAPTER, A, w, 2)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_batch_shared_chunked_matches(self, rng, monkeypatch):
        from bls12_381_jax.msm import pippenger
        from bls12_381_jax.runtime.msm_context import g1_context

        ctx = g1_context()
        A, pts = _g1_points(rng, N)
        bases = ctx.upload_bases(A, precompute_factor=1, glv=False)
        sets = [[rng.randrange(constants.FR_MODULUS) for _ in range(N)]
                for _ in range(4)]
        want = [_g1_result(P) for P in
                ctx.msm_batch([_fr_mont(v) for v in sets], bases)]
        C = pippenger._coord_planes(pippenger.FQ_ADAPTER)
        W = pippenger._row_width(2 * C)
        # room for ~2 batch members per shot -> 2 sequential groups
        budget = 4 * W * N + 2 * 4 * (W + 5 * C) * N
        monkeypatch.setattr(pippenger, "_hbm_budget_bytes", lambda: budget)
        got = [_g1_result(P) for P in
               ctx.msm_batch([_fr_mont(v) for v in sets], bases)]
        assert got == want


class TestG2Msm:
    def test_matches_oracle(self, rng):
        n = 16
        ks = [rng.randrange(1, 1 << 32) for _ in range(n)]
        G = oracle.g2_generator()
        pts = [oracle.jac_to_affine(oracle.scalar_mul(k, G, oracle.FQ2_OPS),
                                    oracle.FQ2_OPS) for k in ks]
        A = g2.affine_from_ints(pts)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
        got = _g2_result(msm_g2(_fr_mont(vals), A))
        want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ2_OPS),
                                    oracle.FQ2_OPS)
        assert got == want

    def test_zero_and_one(self, rng):
        n = 16
        G2g = oracle.g2_generator()
        pts = [oracle.jac_to_affine(
            oracle.scalar_mul(k + 1, G2g, oracle.FQ2_OPS), oracle.FQ2_OPS)
            for k in range(n)]
        A = g2.affine_from_ints(pts)
        assert _g2_result(msm_g2(_fr_mont([0] * n), A)) is None
        vals = [1] + [0] * (n - 1)
        assert _g2_result(msm_g2(_fr_mont(vals), A)) == pts[0]
