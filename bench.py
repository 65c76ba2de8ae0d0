"""Headline benchmark: G1 Pippenger MSM throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}, with the
device as JAX reports it and the card's name and power limit as
nvidia-smi reports them.  Exits non-zero when JAX's default device is
not a GPU.

Config via env:
  BENCH_LOG_N   log2(#points), default 20
  BENCH_REPS    timed repetitions, default 3
  BENCH_METRIC  "msm" (default), "ntt" (NTT 2^22 companion), "g2"
                (G2 MSM), or "batch" (B MSMs over shared cached bases;
                BENCH_BATCH, default 8, sets B)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from bls12_381_jax import constants
from bls12_381_jax.fields import FR, FQ, ops
from bls12_381_jax.fields.limbs import ints_to_limbs
from bls12_381_jax.curves import g1
from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
from bls12_381_jax.msm import msm_g1


def _random_g1_batch(n: int, seed: int = 7):
    """n affine G1 points: a 4096-point batch of distinct small multiples
    of G, tiled to length n (device-cheap setup; MSM throughput does not
    depend on point values, and duplicate points exercise the same-point
    group-law path anyway)."""
    from bls12_381_jax.curves import points as pt

    m = min(n, 4096)
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 1 << 16, size=m, dtype=np.uint64)
    A = g1.generator_affine((m,))
    sc = np.zeros((FR.num_limbs, m), dtype=np.uint32)
    sc[0] = ks & 0xFFFF
    P = pt.scalar_mul(FQ_ADAPTER, jnp.asarray(sc), A, num_bits=16)
    Am = pt.jac_to_affine(FQ_ADAPTER, P)
    if m == n:
        return Am
    reps = -(-n // m)
    tile = lambda c: jnp.tile(c, (1, reps))[:, :n]
    return (tile(Am[0]), tile(Am[1]), jnp.tile(Am[2], (reps,))[:n])


def _random_fr_mont(n: int, seed: int = 3):
    """(16, n) Montgomery-form random scalars; native C++ batch encode when
    available (a 1M-element Python-int loop costs minutes)."""
    from bls12_381_jax import native

    rng = np.random.default_rng(seed)
    if native.available():
        words = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
        words[:, 3] &= (1 << 48) - 1  # < 2^240 < r: uniform enough for perf
        return jnp.asarray(native.wire_to_limbs16(
            native.mont_encode(words, native.FIELD_FR)))
    vals = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62))
            % constants.FR_MODULUS for _ in range(n)]
    return jnp.asarray(ints_to_limbs([FR.to_mont(s) for s in vals],
                                     FR.num_limbs))


from bls12_381_jax.runtime.tracing import timed_reps as _timed_reps

# Cold-start accounting: wall time of the first (compiling) call, reported
# next to the warmed number so consumers know what warmup()/the persistent
# cache buys (JAX_COMPILATION_CACHE_DIR=<empty dir> gives the true cold
# compile).
_COLD: dict = {}


def _timed_first(fn):
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    _COLD["first_call_s"] = time.perf_counter() - t0


def bench_msm(log_n: int, reps: int):
    n = 1 << log_n
    scalars = _random_fr_mont(n)
    A = _random_g1_batch(n)
    jax.block_until_ready(A)

    # warmup: compile all stages + build any cached tables
    _timed_first(lambda: msm_g1(scalars, A))

    best = _timed_reps(reps, lambda: msm_g1(scalars, A))
    return n / best, best


def _random_g2_batch(n: int, seed: int = 7):
    """n affine G2 points (same small-multiples-of-G construction as G1)."""
    from bls12_381_jax.curves import g2
    from bls12_381_jax.curves import points as pt
    from bls12_381_jax.curves.field_adapters import FQ2_ADAPTER

    tree_map = jax.tree_util.tree_map
    m = min(n, 1024)
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 1 << 16, size=m, dtype=np.uint64)
    A = g2.generator_affine((m,))
    sc = np.zeros((FR.num_limbs, m), dtype=np.uint32)
    sc[0] = ks & 0xFFFF
    P = pt.scalar_mul(FQ2_ADAPTER, jnp.asarray(sc), A, num_bits=16)
    Am = pt.jac_to_affine(FQ2_ADAPTER, P)
    if m == n:
        return Am
    reps = -(-n // m)
    tile = lambda c: jnp.tile(c, (1, reps))[:, :n]
    x, y, inf = Am
    return (tree_map(tile, x), tree_map(tile, y),
            jnp.tile(inf, (reps,))[:n])


def bench_msm_g2(log_n: int, reps: int):
    from bls12_381_jax.msm import msm_g2

    n = 1 << log_n
    scalars = _random_fr_mont(n)
    A = _random_g2_batch(n)
    jax.block_until_ready(A)
    _timed_first(lambda: msm_g2(scalars, A))
    best = _timed_reps(reps, lambda: msm_g2(scalars, A))
    return n / best, best


def bench_msm_batch(log_n: int, reps: int, batch: int):
    """B MSMs over shared cached bases through the single batched pipeline
    (runtime.msm_context.msm_batch / pippenger.msm_batch_shared), vs the
    loop of B independent precomputed MSMs it replaces.  Rate counts all
    B*n points."""
    from bls12_381_jax.runtime.msm_context import g1_context

    n = 1 << log_n
    ctx = g1_context()
    A = _random_g1_batch(n)
    jax.block_until_ready(A)
    bases = ctx.upload_bases(A, precompute_factor=1)
    scs = [_random_fr_mont(n, seed=11 + i) for i in range(batch)]

    _timed_first(lambda: ctx.msm_batch(scs, bases))
    best = _timed_reps(reps, lambda: ctx.msm_batch(scs, bases))

    # loop-of-B comparison leg (the pre-batched implementation)
    jax.block_until_ready(ctx.msm_with_bases(scs[0], bases))
    t0 = time.perf_counter()
    outs = [ctx.msm_with_bases_async(s, bases) for s in scs]
    for h in outs:
        h.wait()
    loop_secs = time.perf_counter() - t0
    print(f"# loop-of-{batch} leg: {loop_secs:.4f}s "
          f"(batched {best:.4f}s, {loop_secs / best:.2f}x)", file=sys.stderr)
    return batch * n / best, best


def bench_ntt(log_n: int, reps: int):
    from bls12_381_jax.ntt import ntt, get_domain

    n = 1 << log_n
    dom = get_domain(log_n)
    rng = np.random.default_rng(5)
    x = jnp.asarray(
        rng.integers(0, 1 << 16, size=(FR.num_limbs, n), dtype=np.uint64)
    ).astype(jnp.uint32)
    _timed_first(lambda: ntt(x, domain=dom))
    best = _timed_reps(reps, lambda: ntt(x, domain=dom))
    return n / best, best


def main():
    from bls12_381_jax.compile_cache import enable_compile_cache
    from bls12_381_jax.devinfo import card_info, require_gpu

    dev = require_gpu()
    card = card_info()
    enable_compile_cache()
    which = os.environ.get("BENCH_METRIC", "msm")
    reps = int(os.environ.get("BENCH_REPS", "3"))
    if which == "ntt":
        log_n = int(os.environ.get("BENCH_LOG_N", "22"))
        rate, secs = bench_ntt(log_n, reps)
        metric = f"ntt_fr_2e{log_n}_elems_per_s"
    elif which in ("batch", "msm_batch"):
        log_n = int(os.environ.get("BENCH_LOG_N", "16"))
        batch = int(os.environ.get("BENCH_BATCH", "8"))
        rate, secs = bench_msm_batch(log_n, reps, batch)
        metric = f"g1_msm_batch{batch}_2e{log_n}_points_per_s"
    elif which in ("g2", "g2_msm"):
        log_n = int(os.environ.get("BENCH_LOG_N", "16"))
        rate, secs = bench_msm_g2(log_n, reps)
        metric = f"g2_msm_2e{log_n}_points_per_s"
    else:
        log_n = int(os.environ.get("BENCH_LOG_N", "20"))
        rate, secs = bench_msm(log_n, reps)
        metric = f"g1_msm_2e{log_n}_points_per_s"
    print(json.dumps({
        "metric": metric,
        "value": rate,
        "unit": "elems/s" if which == "ntt" else "points/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))
    first = _COLD.get("first_call_s")
    cold = f" first_call={first:.2f}s" if first is not None else ""
    print(f"# wall={secs:.4f}s card={card}{cold}", file=sys.stderr)


if __name__ == "__main__":
    main()
