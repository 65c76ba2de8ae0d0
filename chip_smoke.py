#!/usr/bin/env python3
"""Prove the prover path runs on the GPU: one K=20 round, checked exactly.

Usage:
    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: sharded MSM and NTT only

One card, every phase through the public API and checked bit-exactly
against an independent reference:

  1. G1 commit at 2^20.  Bases are A_i = k_i*G with random 64-bit k_i, so
     every MSM's expectation is one oracle scalar multiple
     (sum s_i*k_i mod r)*G.  upload_bases(precompute_factor=2), one
     msm_with_bases_async().wait(), one msm_batch of 4 scalar sets and one
     ad-hoc msm_g1, all on full-width random Fr scalars.
  2. G2 MSM at 2^16, the same construction on the G2 generator.
  3. NTT/iNTT and coset NTT/iNTT at 2^22 (the K=20 extended domain): exact
     round trips; forward outputs spot-checked by Horner evaluation.
  4. vector_mul at 2^22 and batch_inverse at 2^20, spot-checked.
  5. dispatch_msm at 2^16 and dispatch_ntt at 2^12 with MIDNIGHT_DEVICE=gpu:
     the accelerated route, against native.msm_host and oracle.ntt.
  6. The tests marked ``gpu``.

Phases 1-5 first make every call once, from threads, so that their
compilations overlap (G1's three calls share one thread and its bases);
then every call runs again alone on the card, and that result is checked.

``--four`` runs only msm_g1_sharded (GLV) at 2^22 and ntt_sharded ->
intt_sharded at 2^22 on a 4-card mesh, each against the one-card result
in the same process (and the MSM against its discrete-log expectation).

It needs a GPU: it exits non-zero when JAX's default device is anything
else.  The times it prints are smoke timings on the named card, compile
included in the first call; they are not benchmark results.  The last
line of its output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20
K_CIRCUIT = 20
LOG_G2 = 16
LOG_DISPATCH_MSM, LOG_DISPATCH_NTT = 16, 12
# s_i < r needs the top 64-bit word below r's.
R_TOP_WORD = 0x73EDA753299D7D48
# Bases are k_i*G with 64-bit k_i built from 64 / PART_BITS digits.
PART_BITS = 16


# -----------------------------------------------------------------------------
# Host-side helpers (independent of the device code; tested on the CPU)
# -----------------------------------------------------------------------------


def random_scalar_words(rng, n: int) -> np.ndarray:
    """(n, 4) uint64 little-endian words of uniform-width scalars < r."""
    w = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    w[:, 3] %= np.uint64(R_TOP_WORD)
    return w


def words_to_limbs(words: np.ndarray) -> np.ndarray:
    """(n, k64) uint64 words -> (4*k64, n) uint32 16-bit limbs."""
    n, k64 = words.shape
    out = np.empty((4 * k64, n), dtype=np.uint32)
    for w in range(k64):
        for j in range(4):
            out[4 * w + j] = (words[:, w] >> np.uint64(16 * j)) & np.uint64(0xFFFF)
    return out


def limbs_to_int_list(limbs: np.ndarray) -> list:
    """(k, n) 16-bit limbs -> n Python ints."""
    from bls12_381_jax.fields.limbs import limbs_to_ints

    return limbs_to_ints(np.asarray(limbs))


def dot_mod_r(s_limbs: np.ndarray, k_parts: np.ndarray, part_bits: int) -> int:
    """sum_i s_i * k_i mod r, where s_i has 16-bit limbs ``s_limbs`` (16, n)
    and k_i has ``part_bits``-bit digits ``k_parts`` (P, n).  Exact in
    uint64: each column sum is below n * 2^(16 + part_bits)."""
    from bls12_381_jax.constants import FR_MODULUS

    n = s_limbs.shape[-1]
    if n * (1 << (16 + part_bits)) >= 1 << 64:
        raise ValueError("column sums would overflow uint64")
    sums = s_limbs.astype(np.uint64) @ k_parts.astype(np.uint64).T  # (16, P)
    total = 0
    for j in range(sums.shape[0]):
        for m in range(sums.shape[1]):
            total += int(sums[j, m]) << (16 * j + part_bits * m)
    return total % FR_MODULUS


def dlog_expectation(curve: str, total: int):
    """Affine ints of total*G on G1 or G2 (the big-int oracle)."""
    from bls12_381_jax import oracle

    F = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    G = oracle.g1_generator() if curve == "g1" else oracle.g2_generator()
    return oracle.jac_to_affine(oracle.scalar_mul(total, G, F), F)


def dlog_bases(curve: str, k_parts: np.ndarray, part_bits: int):
    """Device affine batch A_i = k_i * G, k_i = sum_m k_parts[m, i] 2^(m b).

    A fixed-base ladder without doublings: for every bit j of k, add the
    oracle's 2^j * G to the lanes whose k_i has that bit.  Every step runs
    the same compiled mixed add, so the set-up compiles two small programs
    (the step and the affine conversion)."""
    import jax
    import jax.numpy as jnp

    from bls12_381_jax import oracle
    from bls12_381_jax.curves import g1, g2, points as pt
    from bls12_381_jax.curves.field_adapters import FQ_ADAPTER, FQ2_ADAPTER

    F = FQ_ADAPTER if curve == "g1" else FQ2_ADAPTER
    mod = g1 if curve == "g1" else g2
    Fo = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    G = oracle.g1_generator() if curve == "g1" else oracle.g2_generator()
    n_pos, n = k_parts.shape

    @jax.jit
    def step(acc, bit, P):
        P = jax.tree_util.tree_map(
            lambda c: jnp.broadcast_to(c, c.shape[:-1] + (n,)), P)
        return pt.jac_cmov(F, bit, pt.jac_add_affine(F, acc, P), acc)

    acc = pt.jac_identity(F, (n,))
    for j in range(n_pos * part_bits):
        digit = k_parts[j // part_bits] >> np.uint64(j % part_bits)
        bit = jnp.asarray(digit & np.uint64(1) == 1)
        Pj = oracle.jac_to_affine(oracle.scalar_mul(1 << j, G, Fo), Fo)
        acc = step(acc, bit, mod.affine_from_ints([Pj]))
    return jax.jit(lambda P: pt.jac_to_affine(F, P))(acc)


def horner(coeffs: list, x: int) -> int:
    """sum_i coeffs[i] * x^i mod r."""
    from bls12_381_jax.constants import FR_MODULUS

    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR_MODULUS
    return acc


def from_mont_int(v: int) -> int:
    """Standard form of a Montgomery-form Fr integer (R = 2^256)."""
    from bls12_381_jax.constants import FR_MODULUS

    return v * pow(1 << 256, -1, FR_MODULUS) % FR_MODULUS


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------


class Smoke:
    """The smoke's timed calls, in two passes.  ``first`` runs a call once
    (compilation included), prints its time and keeps it; independent
    phases make their first calls from threads, so that their compilations
    overlap.  ``steady_and_check`` then runs every kept call again, alone
    on the card, prints that time and checks the result."""

    def __init__(self, dev, card: str):
        self.dev = dev
        self.card = card
        self.cases = []
        self._lock = threading.Lock()

    def first(self, label: str, shape, fn, check):
        """First call of ``fn``, ending in block_until_ready; ``check``
        later receives the steady call's output."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        print(f"smoke timing [{self.card}] {label} shape={shape} "
              f"first_call_s={time.perf_counter() - t0} "
              "(other phases compiling alongside)", flush=True)
        with self._lock:
            self.cases.append((label, shape, fn, check))
        return out

    def steady_and_check(self) -> None:
        import jax

        for label, shape, fn, check in self.cases:
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            steady = time.perf_counter() - t0
            peak = (self.dev.memory_stats() or {}).get("peak_bytes_in_use")
            print(f"smoke timing [{self.card}] {label} shape={shape} "
                  f"steady_s={steady} peak_bytes_in_use={peak}", flush=True)
            check(out)

    def once(self, label: str, shape, fn):
        """Run ``fn`` once, ending in block_until_ready; print its wall
        time (compilation included)."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        print(f"smoke timing [{self.card}] {label} (one run) shape={shape} "
              f"wall_s={time.perf_counter() - t0}", flush=True)
        return out


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"ok: {what}", flush=True)


def _random_k_parts(rng, n: int) -> np.ndarray:
    return rng.integers(0, 1 << PART_BITS, size=(64 // PART_BITS, n),
                        dtype=np.uint64)


def _scalar_set(rng, n: int):
    """Montgomery-form device scalars + their standard-form limbs."""
    import jax.numpy as jnp

    from bls12_381_jax import native

    words = random_scalar_words(rng, n)
    mont = native.wire_to_limbs16(native.mont_encode(words, native.FIELD_FR))
    return jnp.asarray(mont), words_to_limbs(words)


def _point_ints(curve: str, P):
    """One device Jacobian point (leaves (K,)) -> affine ints."""
    import jax

    from bls12_381_jax.curves import g1, g2

    mod = g1 if curve == "g1" else g2
    return mod.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], P))[0]


def _equals(curve: str, want, what: str):
    """A check that a device point is the affine ints ``want``."""
    return lambda P: _check(_point_ints(curve, P) == want, what)


def setup_g1(sm: Smoke, rng, n: int):
    """Discrete-log bases, uploaded with precompute factor 2, and five
    scalar sets with their expectations."""
    from bls12_381_jax.runtime import global_accelerator

    k_parts = _random_k_parts(rng, n)
    A = sm.once("g1 dlog bases (set-up)", n,
                lambda: dlog_bases("g1", k_parts, PART_BITS))
    bases = sm.once("g1 upload_bases(precompute_factor=2) (set-up)", n,
                    lambda: global_accelerator().g1.upload_bases(
                        A, precompute_factor=2))
    sets = [_scalar_set(rng, n) for _ in range(5)]
    want = [dlog_expectation("g1", dot_mod_r(std, k_parts, PART_BITS))
            for _, std in sets]
    return A, bases, sets, want


def phase_g1(sm: Smoke, n: int, A, bases, sets, want):
    from bls12_381_jax.msm import msm_g1
    from bls12_381_jax.runtime import global_accelerator

    g1 = global_accelerator().g1
    log_n = n.bit_length() - 1
    sm.first("g1 msm_with_bases_async(factor=2).wait", n,
             lambda: g1.msm_with_bases_async(sets[0][0], bases).wait(),
             _equals("g1", want[0],
                     f"G1 msm_with_bases_async at 2^{log_n} == oracle"))
    sm.first("g1 msm_batch(B=4)", (4, n),
             lambda: g1.msm_batch([s for s, _ in sets[1:]], bases),
             lambda got: _check([_point_ints("g1", P) for P in got] == want[1:],
                                f"G1 msm_batch of 4 at 2^{log_n} == oracle"))
    sm.first("g1 msm_g1 (glv auto)", n, lambda: msm_g1(sets[0][0], A),
             _equals("g1", want[0], f"G1 msm_g1 at 2^{log_n} == oracle"))
    # msm_g1's GLV pipeline runs on 2n points
    sm.once("memory_analysis of the per-window programs (set-up)", 2 * n,
            lambda: window_memory(2 * n))


def window_memory(n: int) -> None:
    """Print memory_analysis() of the two per-window programs of a G1
    pipeline over n points (served from the compilation caches)."""
    import jax
    import jax.numpy as jnp

    from bls12_381_jax.curves.field_adapters import FQ_ADAPTER as F
    from bls12_381_jax.msm import pippenger as pp

    w = pp.window_bits_for(n, F)
    L = pp.lane_tile_for(n, F)
    R = -(-n // L)
    nb = 1 << (w - 1)
    lb_bits = pp.triangle_lb(nb).bit_length() - 1
    u32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.uint32)
    key, inf = u32(n), jax.ShapeDtypeStruct((n,), jnp.bool_)
    em = u32(n, pp._row_width(2 * pp._coord_planes(F)))
    head = pp._stage_sort_scan.lower(F, key, R, L, em, inf).compile()
    ks, ct, pr = jax.eval_shape(
        lambda k, e, i: pp._stage_sort_scan(F, k, R, L, e, i), key, em, inf)
    tail = pp._stage_window_tail.lower(F, ks, ct, nb, lb_bits, pr).compile()
    for name, c in (("sort_scan", head), ("window_tail", tail)):
        print(f"memory_analysis {name} n={n} w={w} R={R} L={L}: "
              f"{c.memory_analysis()}", flush=True)


def phase_g2(sm: Smoke, rng, n: int):
    from bls12_381_jax.msm import msm_g2

    k_parts = _random_k_parts(rng, n)
    A = sm.once("g2 dlog bases (set-up)", n,
                lambda: dlog_bases("g2", k_parts, PART_BITS))
    sc, std = _scalar_set(rng, n)
    want = dlog_expectation("g2", dot_mod_r(std, k_parts, PART_BITS))
    sm.first("g2 msm_g2", n, lambda: msm_g2(sc, A),
             _equals("g2", want, f"G2 msm_g2 at 2^{n.bit_length() - 1} == oracle"))


def _spot(y, idx) -> list:
    """Standard-form ints of Montgomery device values y[:, idx]."""
    cols = np.asarray(y[:, np.asarray(idx)])
    return [from_mont_int(v) for v in limbs_to_int_list(cols)]


def phase_ntt(sm: Smoke, rng, log_n: int, n_spot: int = 4):
    import jax.numpy as jnp

    from bls12_381_jax import constants, oracle
    from bls12_381_jax.ntt.ntt import coset_intt, coset_ntt
    from bls12_381_jax.runtime import global_accelerator

    n = 1 << log_n
    ntt = global_accelerator().ntt
    x, std = _scalar_set(rng, n)
    coeffs = limbs_to_int_list(std)
    idx = sorted(int(i) for i in rng.choice(n, size=n_spot, replace=False))
    omega = oracle.root_of_unity(log_n)
    r = constants.FR_MODULUS
    shift = constants.FR_MULTIPLICATIVE_GENERATOR
    want = [horner(coeffs, pow(omega, j, r)) for j in idx]
    want_coset = [horner(coeffs, shift * pow(omega, j, r) % r) for j in idx]

    def round_trip(what):
        return lambda xr: _check(bool(jnp.array_equal(xr, x)), what)

    def spot(want, what):
        return lambda y: _check(_spot(y, idx) == want, what)

    y = sm.first("ntt forward", (16, n), lambda: ntt.forward(x),
                 spot(want, f"NTT at 2^{log_n}: {n_spot} outputs == "
                            "Horner evaluation"))
    sm.first("ntt inverse", (16, n), lambda: ntt.inverse(y),
             round_trip(f"NTT round trip at 2^{log_n} exact"))
    yc = sm.first("coset_ntt", (16, n), lambda: coset_ntt(x, shift),
                  spot(want_coset, f"coset NTT at 2^{log_n}: {n_spot} "
                                   "outputs == Horner evaluation"))
    sm.first("coset_intt", (16, n), lambda: coset_intt(yc, shift),
             round_trip(f"coset NTT round trip at 2^{log_n} exact"))


def phase_vecops(sm: Smoke, rng, log_n_mul: int, log_n_inv: int):
    from bls12_381_jax import constants, vecops
    from bls12_381_jax.fields import FR

    r = constants.FR_MODULUS
    n = 1 << log_n_mul
    (a, a_std), (b, b_std) = _scalar_set(rng, n), _scalar_set(rng, n)
    idx = sorted(int(i) for i in rng.choice(n, size=8, replace=False))
    av = limbs_to_int_list(a_std[:, idx])
    bv = limbs_to_int_list(b_std[:, idx])
    want = [x * y % r for x, y in zip(av, bv)]
    sm.first("vector_mul", (16, n), lambda: vecops.vector_mul(FR, a, b),
             lambda prod: _check(_spot(prod, idx) == want,
                                 f"vector_mul at 2^{log_n_mul}: 8 spot "
                                 "indices == oracle"))

    n = 1 << log_n_inv
    x, x_std = _scalar_set(rng, n)
    x = x.at[:, 7].set(0)  # inv(0) = 0 by convention
    idx_inv = [7] + sorted(int(i) for i in rng.choice(n, size=7, replace=False))
    xv = limbs_to_int_list(x_std[:, idx_inv])
    xv[0] = 0
    want_inv = [pow(v, -1, r) if v else 0 for v in xv]
    sm.first("batch_inverse", (16, n), lambda: vecops.batch_inverse(FR, x),
             lambda inv: _check(_spot(inv, idx_inv) == want_inv,
                                f"batch_inverse at 2^{log_n_inv}: 8 spot "
                                "indices == oracle"))


def phase_dispatch(sm: Smoke, rng, A, scalars_std, log_n_msm: int,
                   log_n_ntt: int):
    import jax

    from bls12_381_jax import native, oracle
    from bls12_381_jax.constants import FR_MODULUS
    from bls12_381_jax.curves import g1
    from bls12_381_jax.runtime.dispatch import (
        Route, dispatch_msm, dispatch_ntt)

    n = 1 << log_n_msm
    pts = g1.affine_to_ints(jax.tree_util.tree_map(
        lambda c: np.asarray(c[..., :n]), A))
    sc = limbs_to_int_list(scalars_std[:, :n])
    want = oracle.jac_to_affine(native.msm_host(sc, pts, "g1"), oracle.FQ_OPS)

    def accel_equals(want, what):
        def check(res):
            _check(res.route is Route.ACCEL, f"{what}: route {res.route}")
            _check(res.value == want, what)
        return check

    sm.first("dispatch_msm", n, lambda: dispatch_msm(sc, pts),
             accel_equals(want, f"dispatch_msm at 2^{log_n_msm} == "
                                "native.msm_host"))
    m = 1 << log_n_ntt
    vals = [int(v) % FR_MODULUS for v in
            limbs_to_int_list(words_to_limbs(random_scalar_words(rng, m)))]
    sm.first("dispatch_ntt", m, lambda: dispatch_ntt(vals),
             accel_equals(oracle.ntt(vals),
                          f"dispatch_ntt at 2^{log_n_ntt} == oracle.ntt"))


def one_card(sm: Smoke, seed: int) -> None:
    """Every one-card phase.  The phases make their first calls from
    threads (G1's three calls in one thread, as they share its bases), then
    every call runs again alone and is checked; the tests marked ``gpu``
    run last."""
    from bls12_381_jax.runtime import global_accelerator
    from bls12_381_jax.runtime.config import config

    _check(config().device.value == "gpu", "MIDNIGHT_DEVICE=gpu in effect")
    global_accelerator()  # built once, before the threads share it
    rngs = [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(5)]
    n = 1 << K_CIRCUIT
    with ThreadPoolExecutor(max_workers=5) as pool:
        jobs = [pool.submit(phase_g2, sm, rngs[1], 1 << LOG_G2),
                pool.submit(phase_ntt, sm, rngs[2], K_CIRCUIT + 2),
                pool.submit(phase_vecops, sm, rngs[3], K_CIRCUIT + 2,
                            K_CIRCUIT)]
        A, bases, sets, want = setup_g1(sm, rngs[0], n)
        jobs += [pool.submit(phase_g1, sm, n, A, bases, sets, want),
                 pool.submit(phase_dispatch, sm, rngs[4], A, sets[0][1],
                             LOG_DISPATCH_MSM, LOG_DISPATCH_NTT)]
        for job in jobs:
            job.result()
    peak = (sm.dev.memory_stats() or {}).get("peak_bytes_in_use")
    print(f"first calls done; peak_bytes_in_use={peak}", flush=True)
    sm.steady_and_check()
    phase_gpu_tests()


def phase_gpu_tests() -> None:
    import pytest

    os.environ["MIDNIGHT_TEST_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "-p", "no:randomly",
                      os.path.join(ROOT, "tests")])
    _check(rc == 0, f"tests marked gpu pass (pytest exit {rc})")


def phase_four(sm: Smoke, rng, log_n: int):
    """Sharded G1 MSM (GLV) and NTT round trip on a 4-card mesh, each
    compared with the one-card result in this process.  Every step runs
    once: its time includes compilation.  The independent computations run
    in threads so that their compilations overlap; each time printed is
    the wall time of one of them while the others also ran."""
    import jax
    import jax.numpy as jnp

    from bls12_381_jax.msm import msm_g1
    from bls12_381_jax.ntt import ntt
    from bls12_381_jax.parallel import (
        default_mesh, intt_sharded, msm_g1_sharded, ntt_sharded)
    from bls12_381_jax.parallel.msm import shard_msm_inputs

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 cards, found {len(jax.devices())}")
    mesh = default_mesh(4)
    n = 1 << log_n
    k_parts = _random_k_parts(rng, n)
    sc, std = _scalar_set(rng, n)
    x, _ = _scalar_set(rng, n)

    def ntt_round_trip():
        y4 = sm.once("ntt_sharded on 4 cards", (16, n),
                     lambda: ntt_sharded(x, mesh))
        return y4, sm.once("intt_sharded on 4 cards", (16, n),
                           lambda: intt_sharded(y4, mesh))

    with ThreadPoolExecutor(max_workers=4) as pool:
        ntt4 = pool.submit(ntt_round_trip)
        ntt1 = pool.submit(sm.once, "ntt on one card", (16, n),
                           lambda: ntt(x))
        A = sm.once("g1 dlog bases (set-up)", n,
                    lambda: dlog_bases("g1", k_parts, PART_BITS))
        sc_sh, A_sh = shard_msm_inputs(sc, A, mesh)
        msm4 = pool.submit(sm.once, "msm_g1_sharded(glv) on 4 cards", n,
                           lambda: msm_g1_sharded(sc_sh, A_sh, mesh, glv=True))
        msm1 = pool.submit(sm.once, "msm_g1 on one card", n,
                           lambda: msm_g1(sc, A))
        want = dlog_expectation("g1", dot_mod_r(std, k_parts, PART_BITS))
        got4, got1 = msm4.result(), msm1.result()
        (y4, x4), y1 = ntt4.result(), ntt1.result()
    _check(_point_ints("g1", got4) == want,
           f"4-card sharded G1 MSM at 2^{log_n} == oracle")
    _check(_point_ints("g1", got1) == _point_ints("g1", got4),
           f"4-card sharded G1 MSM at 2^{log_n} == one-card msm_g1")
    _check(bool(jnp.array_equal(x4, x)),
           f"4-card NTT round trip at 2^{log_n} exact")
    _check(bool(jnp.array_equal(y4, y1)),
           f"4-card NTT at 2^{log_n} == one-card ntt")


def main(argv: list) -> int:
    four = "--four" in argv
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and platforms.split(",")[0] != "cuda":
        print(f"JAX_PLATFORMS={platforms!r}: this smoke runs on the GPU "
              "only (leave it unset or list 'cuda' first)", file=sys.stderr)
        return 2
    # read by the dispatch phase; set before the config is first read
    os.environ["MIDNIGHT_DEVICE"] = "gpu"

    import jax

    from bls12_381_jax.devinfo import NoGpuError, card_info, require_gpu

    try:
        dev = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    card = card_info()
    print(f"card (name, power limit): {card}", flush=True)
    print(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}; "
          f"jax {jax.__version__}", flush=True)

    from bls12_381_jax import native
    from bls12_381_jax.compile_cache import enable_compile_cache

    subprocess.run(["make", "-B", "-C", os.path.join(ROOT, "native")],
                   check=True, capture_output=True)
    _check(native.available(), "native host library rebuilt and loaded")
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    sm = Smoke(dev, card.splitlines()[0])
    t0 = time.perf_counter()
    if four:
        phase_four(sm, np.random.default_rng(SEED), 22)
    else:
        one_card(sm, SEED)
    print(f"all phases passed in {time.perf_counter() - t0} s "
          f"[{sm.card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
