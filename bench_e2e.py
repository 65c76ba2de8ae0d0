"""End-to-end prover-phase benchmark: the PLONK/KZG pipeline per phase.

The analog of the reference's downstream e2e proof benchmark
(docs/gpu-integration/diffs-2df59557/test_e2e_proof_benchmark.rs.diff:130-177),
which times full proofs per phase and prints a GPU-vs-CPU speedup table
per circuit size K.  Here the prover-shaped pipeline is:

    commit : B=4 batched MSM (2^K points each) against cached SRS bases
    ntt    : coset NTT at the 2^(K+1) evaluation domain
    vecops : pointwise product on the domain
    intt   : coset iNTT back to coefficients
    open   : 1 MSM (2^K) — the opening-proof commitment

The CPU column is the library's own host fallback (the BLST-role native
Pippenger, native/msm_host.cpp, for MSMs; the XLA:CPU path of the same
NTT/vecops programs, run in a subprocess pinned to the CPU because a
process binds one default platform, and one process uses the card).

The accel leg needs a GPU and exits non-zero without one.  Every row
names the card and its power limit.

Usage:
    python bench_e2e.py                  # accel leg + CPU-leg subprocess
    BENCH_E2E_KS=14,16 python bench_e2e.py
    BENCH_E2E_SKIP_CPU=1 python bench_e2e.py   # accel only
    BENCH_E2E_OUT=e2e.json python bench_e2e.py # also write the rows there
    python bench_e2e.py --cpu-leg 14     # internal: one CPU-leg K, JSON out
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from bls12_381_jax import constants, vecops
from bls12_381_jax.fields import FR, ops
from bls12_381_jax.ntt import get_domain
from bls12_381_jax.ntt.ntt import coset_intt, coset_ntt
from bls12_381_jax.runtime.msm_context import g1_context

from bench import _random_fr_mont, _random_g1_batch

B_COMMIT = 4
SHIFT = constants.FR_MULTIPLICATIVE_GENERATOR
REPS = int(os.environ.get("BENCH_E2E_REPS", "2"))


def _timed(fn):
    from bls12_381_jax.runtime.tracing import timed_reps

    jax.block_until_ready(fn())  # compile
    return timed_reps(REPS, fn)


def accel_leg(K: int) -> dict:
    n, dom_n = 1 << K, 1 << (K + 1)
    ctx = g1_context()
    A = _random_g1_batch(n)
    bases = ctx.upload_bases(A, precompute_factor=2)
    polys = [_random_fr_mont(n, seed=10 + i) for i in range(B_COMMIT)]
    coeffs = _random_fr_mont(dom_n, seed=20)
    get_domain(K + 1)  # domain build outside the timing (cached, like the SRS)

    t = {}
    t["commit"] = _timed(lambda: ctx.msm_batch(polys, bases))
    ev = coset_ntt(coeffs, SHIFT)
    t["ntt"] = _timed(lambda: coset_ntt(coeffs, SHIFT))
    t["vecops"] = _timed(lambda: vecops.vector_mul(FR, ev, ev))
    prod = vecops.vector_mul(FR, ev, ev)
    t["intt"] = _timed(lambda: coset_intt(prod, SHIFT))
    t["open"] = _timed(lambda: ctx.msm_with_bases(polys[0], bases))
    t["total"] = sum(t.values())
    return t


def cpu_leg(K: int) -> dict:
    """Host-path times: native Pippenger MSM + XLA:CPU NTT/vecops."""
    from bls12_381_jax import native
    from bls12_381_jax.curves import g1

    n, dom_n = 1 << K, 1 << (K + 1)
    t = {}
    if native.available():
        rng = np.random.default_rng(1)
        A = _random_g1_batch(n)
        pts = g1.affine_to_ints(jax.tree_util.tree_map(np.asarray, A))
        # commit = B real sequential host MSMs with distinct scalar sets
        # (the host Pippenger has no batch mode), matching the reference's
        # table of real batched phases (test_e2e_proof_benchmark.rs.diff).
        # full-width Fr scalars, like-for-like with the accel leg's
        # 255-bit wire scalars (round-4 verdict: 62-bit here understated
        # the CPU cost direction but was not a fair comparison)
        r = constants.FR_MODULUS
        scs = [[int.from_bytes(rng.bytes(32), "little") % r
                for _ in range(n)]
               for _ in range(B_COMMIT)]
        t0 = time.perf_counter()
        for sc in scs:
            native.msm_host(sc, pts, "g1")
        t["commit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.msm_host(scs[0], pts, "g1")
        t["open"] = time.perf_counter() - t0
    coeffs = _random_fr_mont(dom_n, seed=20)
    get_domain(K + 1)
    ev = coset_ntt(coeffs, SHIFT)
    t["ntt"] = _timed(lambda: coset_ntt(coeffs, SHIFT))
    t["vecops"] = _timed(lambda: vecops.vector_mul(FR, ev, ev))
    prod = vecops.vector_mul(FR, ev, ev)
    t["intt"] = _timed(lambda: coset_intt(prod, SHIFT))
    t["total"] = sum(v for k, v in t.items() if k != "commit_estimated")
    return t


def _write(out_path, results):
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


def main():
    from bls12_381_jax.compile_cache import enable_compile_cache

    if "--cpu-leg" in sys.argv:
        # Pinned before any JAX use: this child must never open the card
        # the parent process holds.
        jax.config.update("jax_platforms", "cpu")
        enable_compile_cache()
        K = int(sys.argv[sys.argv.index("--cpu-leg") + 1])
        print(json.dumps(cpu_leg(K)))
        return

    from bls12_381_jax.devinfo import card_info, require_gpu

    dev = require_gpu()
    card = card_info()
    enable_compile_cache()
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f"; card: {card}", file=sys.stderr)
    ks = [int(k) for k in
          os.environ.get("BENCH_E2E_KS", "14,16,18").split(",")]
    skip_cpu = bool(os.environ.get("BENCH_E2E_SKIP_CPU"))
    out_path = os.environ.get("BENCH_E2E_OUT")
    results = {}
    for K in ks:
        try:
            acc = accel_leg(K)
        except Exception as e:  # one bad K must not lose the others
            print(f"# accel leg FAILED for K={K}: {e!r}", file=sys.stderr)
            results[str(K)] = {"accel_error": repr(e)}
            _write(out_path, results)
            continue
        row = {"accel": acc, "card": card}
        results[str(K)] = row
        _write(out_path, results)  # accel row FIRST: a dead CPU leg
        # must not lose it
        if not skip_cpu:
            try:
                out = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--cpu-leg", str(K)],
                    capture_output=True, text=True,
                    timeout=int(os.environ.get("BENCH_E2E_CPU_TMO", "7200")),
                    env=dict(os.environ, JAX_PLATFORMS="cpu",
                             BENCH_E2E_REPS="1"))
            except subprocess.TimeoutExpired:
                print(f"# cpu leg TIMED OUT for K={K}; accel row kept",
                      file=sys.stderr)
                out = None
            if out is not None and out.returncode == 0:
                row["cpu"] = json.loads(out.stdout.strip().splitlines()[-1])
            elif out is not None:
                print(f"# cpu leg failed for K={K}:\n{out.stderr[-2000:]}",
                      file=sys.stderr)
        results[str(K)] = row
        _write(out_path, results)  # incremental: survive later crashes
        print(f"# K={K} done: accel total {acc['total']*1e3:.1f} ms",
              file=sys.stderr)

    phases = ["commit", "ntt", "vecops", "intt", "open", "total"]
    print("| K | " + " | ".join(
        f"{p} (ms / speedup)" for p in phases) + " |")
    print("|" + "---|" * (len(phases) + 1))
    for K, row in results.items():
        if "accel" not in row:
            print(f"| {K} | FAILED: {row.get('accel_error', '?')} |")
            continue
        cells = []
        for p in phases:
            a = row["accel"][p] * 1e3
            c = row.get("cpu", {}).get(p)
            cells.append(f"{a:.1f} / {c / row['accel'][p]:.1f}x"
                         if c else f"{a:.1f} / —")
        print(f"| {K} | " + " | ".join(cells) + " |")
    print(f"(card: {card})")


if __name__ == "__main__":
    main()
