"""Sharded (multi-chip) MSM and NTT vs the single-device implementations.

Runs on the 8-virtual-device CPU mesh from conftest.py — the same code
path dryrun_multichip exercises and a multi-card host runs.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants
from bls12_381_jax.fields import FR, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints
from bls12_381_jax.curves import g1, points as pt
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
from bls12_381_jax.msm import msm_g1
from bls12_381_jax.ntt import ntt, intt
from bls12_381_jax.parallel import (
    default_mesh,
    msm_g1_sharded,
    ntt_sharded,
    intt_sharded,
)
from bls12_381_jax.parallel.msm import shard_msm_inputs


def _mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    return default_mesh()


def _rand_fr_mont(rng, n):
    vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
    return jnp.asarray(ints_to_limbs([FR.to_mont(v) for v in vals], FR.num_limbs))


def _gen_points(rng, n):
    """n distinct small multiples of the generator (host-side oracle)."""
    from bls12_381_jax import oracle

    ks = [rng.randrange(1, 1 << 20) for _ in range(n)]
    G = oracle.g1_generator()
    pts = [
        oracle.jac_to_affine(oracle.scalar_mul(k, G, oracle.FQ_OPS), oracle.FQ_OPS)
        for k in ks
    ]
    return g1.affine_from_ints(pts), ks


class TestShardedNtt:
    def test_forward_matches_single_device(self, rng):
        mesh = _mesh()
        n = 1 << 10
        x = _rand_fr_mont(rng, n)
        want = ntt(x)
        got = ntt_sharded(x, mesh)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_transposed_roundtrip_and_layout(self, rng):
        mesh = _mesh()
        n = 1 << 10
        x = _rand_fr_mont(rng, n)
        evals_t = ntt_sharded(x, mesh, transposed_out=True)
        back = intt_sharded(evals_t, mesh, transposed_in=True)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(x))
        # transposed layout is the documented permutation of the natural one
        from bls12_381_jax.parallel.ntt import split_sizes

        nA, nB = split_sizes(10, mesh.devices.size)
        nat = np.asarray(ntt(x)).reshape(FR.num_limbs, nA, nB)
        got = np.asarray(evals_t).reshape(FR.num_limbs, nB, nA)
        np.testing.assert_array_equal(got, nat.swapaxes(1, 2))

    def test_inverse_natural(self, rng):
        mesh = _mesh()
        n = 1 << 9
        x = _rand_fr_mont(rng, n)
        got = intt_sharded(ntt_sharded(x, mesh), mesh)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(x))

    def test_convolution_pipeline(self, rng):
        """polymul via sharded forward-T + pointwise + inverse-from-T."""
        mesh = _mesh()
        n = 1 << 9
        deg = n // 2 - 1
        a = [rng.randrange(constants.FR_MODULUS) for _ in range(deg + 1)]
        b = [rng.randrange(constants.FR_MODULUS) for _ in range(deg + 1)]
        av = jnp.asarray(ints_to_limbs(
            [FR.to_mont(v) for v in a] + [0] * (n - deg - 1), FR.num_limbs))
        bv = jnp.asarray(ints_to_limbs(
            [FR.to_mont(v) for v in b] + [0] * (n - deg - 1), FR.num_limbs))
        ea = ntt_sharded(av, mesh, transposed_out=True)
        eb = ntt_sharded(bv, mesh, transposed_out=True)
        prod = intt_sharded(ops.mont_mul(FR, ea, eb), mesh, transposed_in=True)
        got = limbs_to_ints(np.asarray(ops.from_mont(FR, prod)))
        want = [0] * n
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                want[(i + j) % n] = (want[(i + j) % n] + ai * bj) % constants.FR_MODULUS
        assert got == want


class TestShardedCosetNtt:
    def test_coset_matches_single_device(self, rng):
        from bls12_381_jax.ntt.ntt import coset_ntt
        from bls12_381_jax.parallel import coset_ntt_sharded

        mesh = _mesh()
        n = 1 << 9
        shift = constants.FR_MULTIPLICATIVE_GENERATOR
        x = _rand_fr_mont(rng, n)
        got = coset_ntt_sharded(x, mesh, shift)
        want = coset_ntt(x, shift)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_coset_roundtrip_transposed(self, rng):
        from bls12_381_jax.parallel import coset_intt_sharded, coset_ntt_sharded

        mesh = _mesh()
        n = 1 << 9
        shift = constants.FR_MULTIPLICATIVE_GENERATOR
        x = _rand_fr_mont(rng, n)
        ev = coset_ntt_sharded(x, mesh, shift, transposed_out=True)
        back = coset_intt_sharded(ev, mesh, shift, transposed_in=True)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


class TestInitDistributed:
    def test_single_process_noop(self):
        from bls12_381_jax.parallel import init_distributed

        assert init_distributed() is False  # no coordinator configured

    def test_two_process_dcn_path(self):
        """Spawn 2 CPU processes; init_distributed + cross-process sharded
        NTT roundtrip (gloo standing in for DCN).  See tests/dist_worker.py."""
        import socket
        import subprocess
        import sys

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2")
        env.pop("XLA_FLAGS", None)  # no virtual-device override in workers
        procs = [
            subprocess.Popen([sys.executable, worker],
                             env=dict(env, JAX_PROCESS_ID=str(i)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(2)
        ]
        outs = []
        try:
            for pr in procs:
                out, _ = pr.communicate(timeout=540)
                outs.append(out.decode())
        except subprocess.TimeoutExpired:
            for pr in procs:
                pr.kill()
            pytest.fail("distributed workers timed out")
        for pr, out in zip(procs, outs):
            assert pr.returncode == 0, f"worker failed:\n{out[-3000:]}"
            assert "sharded NTT roundtrip OK" in out


class TestBatchShardedNtt:
    def test_batch_matches_single_device(self, rng):
        from bls12_381_jax.parallel import ntt_batch_sharded

        mesh = _mesh()
        B, n = mesh.devices.size * 2, 256
        rows = [_rand_fr_mont(rng, n) for _ in range(B)]
        x = jnp.stack(rows, axis=1)  # (K, B, n)
        got = ntt_batch_sharded(x, mesh)
        want = ntt(x)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestShardedMsm:
    def test_g2_sharded_matches_oracle(self, rng):
        from bls12_381_jax import oracle
        from bls12_381_jax.curves import g2
        from bls12_381_jax.parallel import msm_g2_sharded

        mesh = _mesh()
        n = 8 * mesh.devices.size
        ks = [rng.randrange(1, 1 << 24) for _ in range(n)]
        G2g = oracle.g2_generator()
        pts = [oracle.jac_to_affine(
            oracle.scalar_mul(k, G2g, oracle.FQ2_OPS), oracle.FQ2_OPS)
            for k in ks]
        A = g2.affine_from_ints(pts)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
        scalars = jnp.asarray(
            ints_to_limbs([FR.to_mont(v) for v in vals], FR.num_limbs))
        sc_sh, A_sh = shard_msm_inputs(scalars, A, mesh)
        got = msm_g2_sharded(sc_sh, A_sh, mesh)
        want_k = sum(v * k for v, k in zip(vals, ks)) % constants.FR_MODULUS
        want = oracle.jac_to_affine(
            oracle.scalar_mul(want_k, G2g, oracle.FQ2_OPS), oracle.FQ2_OPS)
        got_pts = g2.jacobian_to_ints(
            jax.tree_util.tree_map(lambda c: c[..., None], got))
        assert got_pts[0] == want

    def test_matches_single_device(self, rng):
        mesh = _mesh()
        n = 256
        scalars = _rand_fr_mont(rng, n)
        A, _ = _gen_points(rng, n)
        sc_sh, A_sh = shard_msm_inputs(scalars, A, mesh)
        got = msm_g1_sharded(sc_sh, A_sh, mesh)
        want = msm_g1(scalars, A)
        assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_glv_sharded_matches_single_device(self, rng):
        """GLV in the chunked/sharded path (VERDICT r2 missing item 3)."""
        mesh = _mesh()
        n = 32 * mesh.devices.size
        scalars = _rand_fr_mont(rng, n)
        A, _ = _gen_points(rng, n)
        sc_sh, A_sh = shard_msm_inputs(scalars, A, mesh)
        got = msm_g1_sharded(sc_sh, A_sh, mesh, glv=True)
        want = msm_g1(scalars, A, glv=False)
        assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_precomputed_sharded_matches_single_device(self, rng):
        """factor>1 bases chunked segment-wise through the sharded path."""
        from bls12_381_jax.msm import pippenger

        mesh = _mesh()
        D = mesh.devices.size
        n, factor = 32 * D, 2
        scalars = _rand_fr_mont(rng, n)
        A, _ = _gen_points(rng, n)
        w = pippenger.window_bits_for(n, FQ_ADAPTER)
        A_exp = pippenger.expand_bases(FQ_ADAPTER, A, w, factor)
        sc_sh, A_sh = shard_msm_inputs(scalars, A_exp, mesh, segments=factor)
        got = msm_g1_sharded(sc_sh, A_sh, mesh, window_bits=w, factor=factor)
        want = msm_g1(scalars, A, glv=False)
        assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_glv_precomputed_sharded_matches_single_device(self, rng):
        """GLV + precompute compose on the sharded path."""
        from bls12_381_jax.msm import pippenger

        mesh = _mesh()
        D = mesh.devices.size
        n, factor = 32 * D, 2
        scalars = _rand_fr_mont(rng, n)
        A, _ = _gen_points(rng, n)
        w = pippenger.window_bits_for(2 * n, FQ_ADAPTER)
        A_glv = pippenger.glv_extend_bases(FQ_ADAPTER, A)
        A_exp = pippenger.expand_bases(
            FQ_ADAPTER, A_glv, w, factor, pippenger.GLV_HALF_BITS_STATIC)
        sc_sh, A_sh = shard_msm_inputs(
            scalars, A_exp, mesh, segments=2 * factor)
        got = msm_g1_sharded(sc_sh, A_sh, mesh, window_bits=w,
                             glv=True, factor=factor)
        want = msm_g1(scalars, A, glv=False)
        assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_matches_oracle(self, rng):
        from bls12_381_jax import oracle

        mesh = _mesh()
        n = 64
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
        scalars = jnp.asarray(
            ints_to_limbs([FR.to_mont(v) for v in vals], FR.num_limbs))
        A, ks = _gen_points(rng, n)
        sc_sh, A_sh = shard_msm_inputs(scalars, A, mesh)
        got = msm_g1_sharded(sc_sh, A_sh, mesh)
        want_k = sum(v * k for v, k in zip(vals, ks)) % constants.FR_MODULUS
        want = oracle.jac_to_affine(
            oracle.scalar_mul(want_k, oracle.g1_generator(), oracle.FQ_OPS),
            oracle.FQ_OPS,
        )
        got_pts = g1.jacobian_to_ints(
            jax.tree_util.tree_map(lambda c: c[..., None], got))
        assert got_pts[0] == want
