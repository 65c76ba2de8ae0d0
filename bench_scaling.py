"""Weak-scaling efficiency harness for sharded MSM and NTT.

Runs the sharded pipelines over mesh sizes 1, 2, 4, ..., P (all
addressable devices) with the problem size scaled proportionally, and
reports throughput and weak-scaling efficiency per size.

On a one-card host this degenerates to the 1-device row; run on a host
with several cards to get the real curve.  Prints one JSON line per mesh
size, naming the device and the cards' names and power limits.
BENCH_FORCE_CPU=1 runs the rows on the virtual CPU mesh to check the
sharded algorithm and the efficiency math (no device numbers); otherwise
a GPU is required.  BENCH_SCALING_OUT names a file that also receives
the rows.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from bls12_381_jax.fields import FR
from bls12_381_jax.parallel import default_mesh, msm_g1_sharded, ntt_sharded
from bls12_381_jax.parallel.msm import shard_msm_inputs

import bench as bench_mod


def run(points_per_device_log2: int = 18, ntt_log_n_base: int = 20,
        reps: int = 2) -> None:
    all_devices = jax.devices()
    # Production MSM config: GLV split per chunk (the auto default at
    # prover sizes).  BENCH_SCALING_GLV=0 disables.
    glv = os.environ.get("BENCH_SCALING_GLV", "1") == "1"
    out_path = os.environ.get("BENCH_SCALING_OUT")
    rows: list = []
    d = all_devices[0]
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(all_devices)}
    if d.platform == "gpu":
        from bls12_381_jax.devinfo import card_info

        device["card"] = card_info()

    def emit(row):
        row["device"] = device
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out_path:  # incremental: survive timeouts
            with open(out_path, "w") as f:
                json.dump(rows, f, indent=1)

    sizes = []
    p = 1
    while p <= len(all_devices):
        sizes.append(p)
        p *= 2
    base_rate_msm = base_rate_ntt = None
    for p in sizes:
        mesh = default_mesh(p)
        # --- MSM: n scales with p (weak scaling) -------------------------
        n = (1 << points_per_device_log2) * p
        scalars = bench_mod._random_fr_mont(n)
        A = bench_mod._random_g1_batch(n)
        sc_sh, A_sh = shard_msm_inputs(scalars, A, mesh)
        out = msm_g1_sharded(sc_sh, A_sh, mesh, glv=glv)
        jax.block_until_ready(out)
        best = min(_time(lambda: msm_g1_sharded(sc_sh, A_sh, mesh, glv=glv))
                   for _ in range(reps))
        rate = n / best
        base_rate_msm = base_rate_msm or rate
        emit({
            "metric": "g1_msm_weak_scaling", "devices": p, "n": n,
            "glv": glv, "value": round(rate, 1), "unit": "points/s",
            "efficiency": round(rate / (base_rate_msm * p), 4),
        })
        # --- NTT: n scales with p ----------------------------------------
        log_n = ntt_log_n_base + (p - 1).bit_length()
        x = jnp.asarray(np.random.default_rng(5).integers(
            0, 1 << 16, size=(FR.num_limbs, 1 << log_n), dtype=np.uint64)
        ).astype(jnp.uint32)
        ev = ntt_sharded(x, mesh, transposed_out=True)
        jax.block_until_ready(ev)
        best = min(_time(lambda: ntt_sharded(x, mesh, transposed_out=True))
                   for _ in range(reps))
        rate = (1 << log_n) / best
        base_rate_ntt = base_rate_ntt or rate
        emit({
            "metric": "ntt_weak_scaling", "devices": p, "log_n": log_n,
            "value": round(rate, 1), "unit": "elems/s",
            "efficiency": round(rate / (base_rate_ntt * p), 4),
        })


def _time(fn) -> float:
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


if __name__ == "__main__":
    from bls12_381_jax.compile_cache import enable_compile_cache

    # On the virtual CPU mesh every "device" shares the host cores, so use
    # small sizes: the rows validate the sharded ALGORITHM and the
    # efficiency math, not device scaling (BENCH_SCALING_LOG_N /
    # BENCH_SCALING_NTT_LOG_N override).
    cpu_mesh = os.environ.get("BENCH_FORCE_CPU") == "1"
    if cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
    else:
        from bls12_381_jax.devinfo import require_gpu

        require_gpu()
    enable_compile_cache()
    run(
        points_per_device_log2=int(
            os.environ.get("BENCH_SCALING_LOG_N", "10" if cpu_mesh else "18")),
        ntt_log_n_base=int(
            os.environ.get("BENCH_SCALING_NTT_LOG_N",
                           "14" if cpu_mesh else "20")),
    )
