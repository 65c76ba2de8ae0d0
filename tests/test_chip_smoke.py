"""chip_smoke.py's host-side references at tiny sizes, and its refusal to
run anywhere but on a GPU."""

import os
import random
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from bls12_381_jax import constants, oracle
from bls12_381_jax.curves import g1, g2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PART_BITS = 4  # 16-bit k_i from four 4-bit digits: tiny tables on the CPU


def test_scalar_words_and_dot_product():
    rng = np.random.default_rng(3)
    words = cs.random_scalar_words(rng, 40)
    vals = cs.limbs_to_int_list(cs.words_to_limbs(words))
    assert vals == [sum(int(w) << (64 * j) for j, w in enumerate(row))
                    for row in words]
    assert all(0 <= v < constants.FR_MODULUS for v in vals)
    kp = rng.integers(0, 1 << PART_BITS, size=(4, 40), dtype=np.uint64)
    ks = [sum(int(kp[m, i]) << (PART_BITS * m) for m in range(4))
          for i in range(40)]
    want = sum(s * k for s, k in zip(vals, ks)) % constants.FR_MODULUS
    assert cs.dot_mod_r(cs.words_to_limbs(words), kp, PART_BITS) == want


@pytest.mark.parametrize("curve, n", [("g1", 6), ("g2", 3)])
def test_dlog_expectation_matches_oracle_msm(curve, n):
    """The discrete-log bases are k_i*G, and the expectation the smoke
    compares with equals the oracle's own MSM over them."""
    rng = np.random.default_rng(5)
    kp = rng.integers(0, 1 << PART_BITS, size=(4, n), dtype=np.uint64)
    kp[:, 0] = 0  # k = 0: the identity among the bases
    words = cs.random_scalar_words(rng, n)
    scalars = cs.limbs_to_int_list(cs.words_to_limbs(words))
    ks = [sum(int(kp[m, i]) << (PART_BITS * m) for m in range(4))
          for i in range(n)]
    F = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    G = oracle.g1_generator() if curve == "g1" else oracle.g2_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(k, G, F), F) for k in ks]

    A = cs.dlog_bases(curve, kp, PART_BITS)
    mod = g1 if curve == "g1" else g2
    assert mod.affine_to_ints(jax.tree_util.tree_map(np.asarray, A)) == pts
    want = oracle.jac_to_affine(oracle.msm(scalars, pts, F), F)
    got = cs.dlog_expectation(
        curve, cs.dot_mod_r(cs.words_to_limbs(words), kp, PART_BITS))
    assert got == want


def test_horner_spot_check_matches_oracle_ntt():
    rng = random.Random(11)
    log_n = 4
    vals = [rng.randrange(constants.FR_MODULUS) for _ in range(1 << log_n)]
    omega = oracle.root_of_unity(log_n)
    r = constants.FR_MODULUS
    assert oracle.ntt(vals) == [cs.horner(vals, pow(omega, j, r))
                                for j in range(1 << log_n)]
    v = rng.randrange(r)
    assert cs.from_mont_int(v * (1 << 256) % r) == v


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("platforms", ["cpu", None])
def test_fails_without_gpu(platforms):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    if platforms is not None:
        env["JAX_PLATFORMS"] = platforms
    out = _run_smoke(REPO, env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_smoke(tmp_path, env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
