"""Runtime layer: config registry, dispatch routing, contexts, handles, types.

Mirrors the reference's Rust-side unit tests: config parsing/thresholds
(core/config.rs:548-607), dispatch type routing (core/dispatch.rs:446-489),
batch-vs-individual and precomputed-vs-standard MSM equivalence
(core/msm.rs:1777-1820, :1997-2028), async-vs-sync (core/msm.rs:2054-2074),
and zero-copy byte-image identity (core/types.rs:494-701).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants, oracle
from bls12_381_jax.curves import g1, points as pt
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
from bls12_381_jax.fields import FR, FQ
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints
from bls12_381_jax.runtime import (
    Config,
    DeviceType,
    config,
    reset_config_cache,
)
from bls12_381_jax.runtime import types as rt_types
from bls12_381_jax.runtime.dispatch import Route, dispatch_msm, dispatch_ntt
from bls12_381_jax.runtime.msm_context import g1_context
from bls12_381_jax.runtime.ntt_context import NttContext
from bls12_381_jax.runtime.accelerator import Accelerator, backend_info


N_PTS = 64  # shared across MSM tests so staged jits compile once


@pytest.fixture
def env(monkeypatch):
    """Mutate config env vars with automatic cache reset."""

    def set_(name, value):
        monkeypatch.setenv(name, value)
        reset_config_cache()

    yield set_
    reset_config_cache()


def _points(rng, n=N_PTS):
    ks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(k, G, oracle.FQ_OPS),
                                oracle.FQ_OPS) for k in ks]
    return g1.affine_from_ints(pts), pts, ks


def _scalars(rng, n=N_PTS):
    vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
    arr = jnp.asarray(ints_to_limbs([FR.to_mont(v) for v in vals], FR.num_limbs))
    return arr, vals


class TestConfig:
    def test_defaults(self, env):
        c = Config.from_env()
        assert c.device is DeviceType.AUTO
        assert c.msm_min_k == 15 and c.ntt_min_k == 12
        assert c.precompute_factor == 1 and c.msm_window is None
        assert c.ntt_max_log_n == 16

    def test_thresholds(self, env):
        env("MIDNIGHT_GPU_MIN_K", "10")
        env("MIDNIGHT_NTT_MIN_K", "8")
        c = config()
        assert c.use_accel_msm(1 << 10) and not c.use_accel_msm((1 << 10) - 1)
        assert c.use_accel_ntt(1 << 8) and not c.use_accel_ntt(255)

    def test_gpu_alias_and_clamping(self, env):
        env("MIDNIGHT_GPU_MIN_K", "7")
        assert config().msm_min_k == 7
        env("MIDNIGHT_GPU_PRECOMPUTE", "99")
        assert config().precompute_factor == 8  # clamped to [1, 8]

    def test_device_force(self, env):
        env("MIDNIGHT_DEVICE", "cpu")
        assert not config().use_accel_msm(1 << 20)
        env("MIDNIGHT_DEVICE", "gpu")
        assert config().use_accel_msm(1)

    def test_bad_values_fall_back(self, env):
        env("MIDNIGHT_DEVICE", "quantum")
        assert config().device is DeviceType.AUTO
        env("MIDNIGHT_GPU_MIN_K", "not_a_number")
        assert config().msm_min_k == 15


class TestDevicePolicy:
    @pytest.mark.parametrize("value, member", [
        ("gpu", DeviceType.GPU), ("cpu", DeviceType.CPU),
        ("auto", DeviceType.AUTO)])
    def test_values(self, env, value, member):
        env("MIDNIGHT_DEVICE", value)
        c = config()
        assert c.device is member
        # gpu forces the accelerator, cpu the host, auto the threshold
        assert c.use_accel_msm(1) is (member is DeviceType.GPU)
        assert c.use_accel_msm(1 << 20) is (member is not DeviceType.CPU)

    def test_tpu_is_not_a_value(self, env):
        env("MIDNIGHT_DEVICE", "tpu")  # warns, falls back to auto
        assert config().device is DeviceType.AUTO
        assert {d.value for d in DeviceType} == {"auto", "gpu", "cpu"}

    def test_gpu_names_are_primary(self, env):
        env("MIDNIGHT_GPU_MIN_K", "11")
        env("MIDNIGHT_GPU_PRECOMPUTE", "2")
        c = config()
        assert c.msm_min_k == 11 and c.precompute_factor == 2


class TestNttAlgorithm:
    @pytest.mark.parametrize("value", ["radix2", "auto", "RADIX2"])
    def test_accepted(self, env, value):
        env("MIDNIGHT_NTT_ALGORITHM", value)
        assert config().ntt_algorithm == value.lower()

    @pytest.mark.parametrize("value", ["fourstep", "mixedradix"])
    def test_rejected(self, env, value):
        env("MIDNIGHT_NTT_ALGORITHM", value)
        with pytest.raises(ValueError, match="MIDNIGHT_NTT_ALGORITHM"):
            config()


class TestHandles:
    def test_wait_blocks_and_converts(self):
        from bls12_381_jax.runtime import AsyncHandle

        x = jnp.arange(8, dtype=jnp.uint32) * 3
        h = AsyncHandle(x, convert=lambda v: np.asarray(v).tolist())
        assert h.wait() == [3 * i for i in range(8)]
        assert h.is_ready()
        assert h.wait() == [3 * i for i in range(8)]  # converts once

    def test_is_ready_after_block_until_ready(self):
        from bls12_381_jax.runtime.handles import AsyncHandle, ImmediateHandle

        x = jax.block_until_ready(jnp.ones((4,), jnp.uint32))
        assert AsyncHandle({"a": x, "b": [x]}).is_ready()
        h = ImmediateHandle(5)
        assert h.is_ready() and h.wait() == 5


class TestDispatch:
    def test_msm_small_routes_cpu(self, rng, env):
        A, pts, ks = _points(rng, 8)
        scalars = [rng.randrange(constants.FR_MODULUS) for _ in range(8)]
        res = dispatch_msm(scalars, pts)
        assert res.route is Route.CPU
        want_k = sum(s * k for s, k in zip(scalars, ks)) % constants.FR_MODULUS
        want = oracle.jac_to_affine(
            oracle.scalar_mul(want_k, oracle.g1_generator(), oracle.FQ_OPS),
            oracle.FQ_OPS)
        assert res.value == want

    def test_msm_forced_accel_matches_cpu(self, rng, env):
        env("MIDNIGHT_DEVICE", "gpu")
        _, pts, ks = _points(rng, N_PTS)
        scalars = [rng.randrange(constants.FR_MODULUS) for _ in range(N_PTS)]
        res = dispatch_msm(scalars, pts)
        assert res.route is Route.ACCEL
        want = oracle.jac_to_affine(oracle.msm(scalars, pts, oracle.FQ_OPS),
                                    oracle.FQ_OPS)
        assert res.value == want

    def test_ntt_both_routes_agree(self, rng, env):
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(256)]
        env("MIDNIGHT_DEVICE", "cpu")
        cpu = dispatch_ntt(vals)
        assert cpu.route is Route.CPU
        env("MIDNIGHT_DEVICE", "gpu")
        acc = dispatch_ntt(vals)
        assert acc.route is Route.ACCEL
        assert cpu.value == acc.value


class TestMsmContext:
    def test_precomputed_matches_standard(self, rng):
        ctx = g1_context()
        A, pts, ks = _points(rng)
        scalars, vals = _scalars(rng)
        want = ctx.msm(scalars, A)
        for factor in (2, 4):
            bases = ctx.upload_bases(A, precompute_factor=factor)
            # GLV-auto may extend bases with the endomorphism image (x2)
            assert bases.A[2].shape[-1] == (
                N_PTS * factor * (2 if bases.glv else 1))
            got = ctx.msm_with_bases(scalars, bases)
            assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_batch_matches_individual(self, rng):
        ctx = g1_context()
        A, _, _ = _points(rng)
        bases = ctx.upload_bases(A, precompute_factor=1)
        sets = [_scalars(rng)[0] for _ in range(3)]
        batch = ctx.msm_batch(sets, bases)
        for s, got in zip(sets, batch):
            want = ctx.msm(s, A)
            assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_batch_precomputed_matches_individual(self, rng):
        """Batched pipeline over expanded bases (factor 2) — exercises the
        msm_batch_shared regrouping path (core/msm.rs:1245-1249 analog)."""
        ctx = g1_context()
        A, _, _ = _points(rng)
        bases = ctx.upload_bases(A, precompute_factor=2)
        sets = [_scalars(rng)[0] for _ in range(2)]
        batch = ctx.msm_batch(sets, bases)
        for s, got in zip(sets, batch):
            want = ctx.msm(s, A)
            assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))

    def test_warmup_real_shapes(self, rng):
        """warmup(n, factor) pre-compiles the precomputed-bases path at the
        production shape (VERDICT warmup-ergonomics item)."""
        ctx = g1_context()
        ctx.warmup(N_PTS, factor=2)

    def test_async_matches_sync(self, rng):
        ctx = g1_context()
        A, _, _ = _points(rng)
        scalars, _ = _scalars(rng)
        h = ctx.msm_async(scalars, A)
        got = h.wait()
        want = ctx.msm(scalars, A)
        assert bool(np.asarray(pt.jac_eq(FQ_ADAPTER, got, want)))
        assert h.is_ready()


class TestNttContext:
    def test_roundtrip_and_coset(self, rng):
        ctx = NttContext(max_log_n=8)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(256)]
        x = jnp.asarray(ints_to_limbs([FR.to_mont(v) for v in vals],
                                      FR.num_limbs))
        back = ctx.inverse(ctx.forward(x))
        np.testing.assert_array_equal(np.asarray(back), np.asarray(x))
        shift = 7
        cos = ctx.coset_inverse(ctx.coset_forward(x, shift), shift)
        np.testing.assert_array_equal(np.asarray(cos), np.asarray(x))

    def test_async(self, rng):
        ctx = NttContext(max_log_n=8)
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(256)]
        x = jnp.asarray(ints_to_limbs([FR.to_mont(v) for v in vals],
                                      FR.num_limbs))
        h = ctx.forward_async(x)
        np.testing.assert_array_equal(
            np.asarray(h.wait()), np.asarray(ctx.forward(x)))


class TestTypes:
    def test_scalar_bytes_roundtrip(self, rng):
        vals = [rng.randrange(constants.FR_MODULUS) for _ in range(10)]
        data = b"".join(v.to_bytes(32, "little") for v in vals)
        limbs = rt_types.scalars_from_bytes(data)
        assert limbs_to_ints(limbs) == vals
        assert rt_types.scalars_to_bytes(limbs) == data

    def test_fq_bytes_roundtrip(self, rng):
        vals = [rng.randrange(constants.FQ_MODULUS) for _ in range(10)]
        data = b"".join(v.to_bytes(48, "little") for v in vals)
        limbs = rt_types.fq_from_bytes(data)
        assert limbs_to_ints(limbs) == vals
        assert rt_types.fq_to_bytes(limbs) == data

    def test_g1_points_roundtrip(self, rng):
        _, pts, _ = _points(rng, 5)
        pts = pts + [None]  # identity encodes as zeros
        data = b"".join(
            (p[0].to_bytes(48, "little") + p[1].to_bytes(48, "little"))
            if p else bytes(96)
            for p in pts
        )
        x, y, inf = rt_types.g1_affine_from_bytes(data)
        assert list(inf) == [False] * 5 + [True]
        assert limbs_to_ints(x)[:5] == [p[0] for p in pts[:5]]
        assert rt_types.g1_affine_to_bytes(x, y, inf) == data

    def test_mont_encode_decode(self, rng):
        vals = [rng.randrange(constants.FQ_MODULUS) for _ in range(4)]
        limbs = ints_to_limbs(vals, FQ.num_limbs)
        enc = rt_types.mont_encode_host(FQ, limbs)
        assert limbs_to_ints(rt_types.mont_decode_host(FQ, enc)) == vals


class TestVecopDispatch:
    def test_routes_and_matches(self, rng, env):
        from bls12_381_jax.runtime.dispatch import dispatch_vecop

        a = [rng.randrange(constants.FR_MODULUS) for _ in range(32)]
        b = [rng.randrange(constants.FR_MODULUS) for _ in range(32)]
        res = dispatch_vecop("mul", a, b)
        assert res.route is Route.CPU  # below the 4096 threshold
        assert res.value == [x * y % constants.FR_MODULUS for x, y in zip(a, b)]
        env("MIDNIGHT_DEVICE", "gpu")
        acc = dispatch_vecop("add", a, b)
        assert acc.route is Route.ACCEL
        assert acc.value == [(x + y) % constants.FR_MODULUS for x, y in zip(a, b)]


class TestMemoryReport:
    def test_report_counts_live_arrays(self):
        from bls12_381_jax.runtime import live_arrays_report, total_live_bytes

        keep = jnp.zeros((16, 100), jnp.uint32)
        rep = live_arrays_report()
        assert "live arrays" in rep and total_live_bytes() >= keep.size * 4


class TestAccelerator:
    def test_backend_info(self):
        info = backend_info()
        assert "platform" in info and "bls12_381_jax" in info
