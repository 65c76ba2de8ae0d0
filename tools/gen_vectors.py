#!/usr/bin/env python3
"""Golden-vector generator for the bls12_381_jax library.

INDEPENDENT of the library and of its Python oracle: everything here is
computed with plain Python big-ints, *affine* chord-tangent group-law
formulas (the oracle uses Jacobian EFD formulas; the device path uses RCB16
homogeneous projective), and a recursive radix-2 FFT (the library uses an
iterative DIT ladder / sharded Bailey four-step).  Agreement between three
structurally different implementations pins the math; the explicit limb
images in ``field_vectors.json`` pin the wire format.

Vector sources mirrored from the reference's KAT policy
(/root/reference/bls12-381/tests/security_audit_tests.cuh:30-46 — BLST /
Arkworks / EIP-2537 / Zcash constants; /root/reference/tests/
ntt_fft_comparison.rs:8-113 — roots derived by squaring down from
ROOT_OF_UNITY): curve constants here are the same public spec values, and
the NTT omega derivation matches core/ntt.rs:1488-1494.

Run: python tools/gen_vectors.py   (writes tests/vectors/*.json)
"""

from __future__ import annotations

import hashlib
import json
import os
import random

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "vectors")

# --- public curve facts (the BLS12-381 spec; same values as the reference's
# bls12_381_constants.h and this library's constants.py) ---------------------
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G1X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)
TWO_ADICITY = 32
MULT_GEN = 7
OMEGA = pow(MULT_GEN, (R - 1) >> TWO_ADICITY, R)  # primitive 2^32-th root


def h(x: int) -> str:
    return hex(x)


# =============================================================================
# Field helpers (plain ints)
# =============================================================================

def limbs16(x: int, k: int) -> list[int]:
    """Little-endian 16-bit limb image, k limbs."""
    return [(x >> (16 * i)) & 0xFFFF for i in range(k)]


def field_vectors() -> dict:
    rng = random.Random(0x5EED_F1E1D)
    out: dict = {"fields": {}}
    for name, p, k in (("fr", R, 16), ("fq", Q, 24)):
        Rmont = 1 << (16 * k)
        kats = []
        for _ in range(8):
            a = rng.randrange(1, p)
            b = rng.randrange(1, p)
            kats.append({
                "a": h(a), "b": h(b),
                "add": h((a + b) % p), "sub": h((a - b) % p),
                "mul": h(a * b % p), "sqr": h(a * a % p),
                "neg": h((-a) % p), "inv": h(pow(a, p - 2, p)),
                "a_mont": h(a * Rmont % p),
            })
        wire = []
        for v in (1, p - 1, rng.randrange(1, p)):
            wire.append({"value": h(v), "limbs_le16": limbs16(v, k),
                         "mont_limbs_le16": limbs16(v * Rmont % p, k)})
        out["fields"][name] = {
            "modulus": h(p), "num_limbs": k,
            "mont_r": h(Rmont % p), "mont_r2": h(Rmont * Rmont % p),
            "n0_16": h((-pow(p, -1, 1 << 16)) % (1 << 16)),
            "kats": kats, "wire": wire,
        }
    return out


# =============================================================================
# Affine group law (chord-tangent; None = identity)
# =============================================================================

class FqArith:
    p = Q
    @staticmethod
    def add(a, b): return (a + b) % Q
    @staticmethod
    def sub(a, b): return (a - b) % Q
    @staticmethod
    def mul(a, b): return a * b % Q
    @staticmethod
    def inv(a): return pow(a, Q - 2, Q)
    @staticmethod
    def eq(a, b): return a == b
    @staticmethod
    def neg(a): return (-a) % Q
    @staticmethod
    def small(n): return n % Q


class Fq2Arith:
    @staticmethod
    def add(a, b): return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)
    @staticmethod
    def sub(a, b): return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)
    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q,
                (a[0] * b[1] + a[1] * b[0]) % Q)
    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % Q, Q - 2, Q)
        return (a[0] * n % Q, (-a[1]) * n % Q)
    @staticmethod
    def eq(a, b): return a == b
    @staticmethod
    def neg(a): return ((-a[0]) % Q, (-a[1]) % Q)
    @staticmethod
    def small(n): return (n % Q, 0)


def aff_add(F, P, S):
    if P is None:
        return S
    if S is None:
        return P
    (x1, y1), (x2, y2) = P, S
    if F.eq(x1, x2):
        if F.eq(F.add(y1, y2), F.small(0)):
            return None
        # tangent: s = 3x^2 / 2y
        s = F.mul(F.mul(F.small(3), F.mul(x1, x1)), F.inv(F.add(y1, y1)))
    else:
        s = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(s, s), x1), x2)
    y3 = F.sub(F.mul(s, F.sub(x1, x3)), y1)
    return (x3, y3)


def aff_mul(F, k: int, P):
    acc = None
    add = P
    while k:
        if k & 1:
            acc = aff_add(F, acc, add)
        add = aff_add(F, add, add)
        k >>= 1
    return acc


def point_table(F, G, maxk: int):
    """[None, G, 2G, ..., maxk*G] by sequential affine additions."""
    tab = [None, G]
    for _ in range(maxk - 1):
        tab.append(aff_add(F, tab[-1], G))
    return tab


def msm_vectors(F, G, name: str, sizes, seed: int) -> dict:
    rng = random.Random(seed)
    cases = []
    for n in sizes:
        ks = [rng.randrange(1, 1 << 14) for _ in range(n)]
        tab = point_table(F, G, max(ks))
        scalars = [rng.randrange(0, R) for _ in range(n)]
        # a couple of zero scalars exercise the trash-bucket path
        scalars[0] = 0
        if n > 2:
            scalars[n // 2] = 0
        k_total = sum(s * k for s, k in zip(scalars, ks)) % R
        exp = aff_mul(F, k_total, G)
        pts = [tab[k] for k in ks]
        if name == "g1":
            pack = lambda P: {"x": h(P[0]), "y": h(P[1])}
        else:
            pack = lambda P: {"x": [h(P[0][0]), h(P[0][1])],
                              "y": [h(P[1][0]), h(P[1][1])]}
        cases.append({
            "n": n,
            "scalars": [h(s) for s in scalars],
            "points": [pack(P) for P in pts],
            "expected": pack(exp),
        })
    return {"curve": name, "cases": cases}


# =============================================================================
# NTT (recursive radix-2, natural order in/out)
# =============================================================================

def fft(a: list[int], w: int) -> list[int]:
    n = len(a)
    if n == 1:
        return a
    w2 = w * w % R
    even = fft(a[0::2], w2)
    odd = fft(a[1::2], w2)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % R
        out[k] = (even[k] + t) % R
        out[k + n // 2] = (even[k] - t) % R
        wk = wk * w % R
    return out


def omega_for(log_n: int) -> int:
    w = OMEGA
    for _ in range(TWO_ADICITY - log_n):
        w = w * w % R
    return w


def digest(vals: list[int], k: int = 16) -> str:
    hsh = hashlib.sha256()
    for v in vals:
        hsh.update(v.to_bytes(2 * k, "little"))
    return hsh.hexdigest()


def ntt_vectors() -> dict:
    rng = random.Random(0x5EED_0177)
    cases = []
    for log_n in (10, 12):
        n = 1 << log_n
        x = [rng.randrange(0, R) for _ in range(n)]
        y = fft(x, omega_for(log_n))
        cases.append({"log_n": log_n, "kind": "forward",
                      "input": [h(v) for v in x],
                      "output": [h(v) for v in y]})
    # coset NTT at 2^10: evaluate on g*<omega>, i.e. scale x_i by g^i first
    log_n, g = 10, MULT_GEN
    n = 1 << log_n
    x = [rng.randrange(0, R) for _ in range(n)]
    xs = [x[i] * pow(g, i, R) % R for i in range(n)]
    y = fft(xs, omega_for(log_n))
    cases.append({"log_n": log_n, "kind": "coset", "shift": g,
                  "input": [h(v) for v in x],
                  "output": [h(v) for v in y]})
    # 2^14: formula input (x_i = (i^2 + 3) mod r), digest-only output
    log_n = 14
    n = 1 << log_n
    x = [(i * i + 3) % R for i in range(n)]
    y = fft(x, omega_for(log_n))
    cases.append({"log_n": log_n, "kind": "forward_digest",
                  "input_formula": "(i*i + 3) % r",
                  "output_sha256_le32": digest(y)})
    return {"omega_2e32": h(OMEGA), "cases": cases}


def main():
    os.makedirs(OUT_DIR, exist_ok=True)

    def write(fname, obj):
        path = os.path.join(OUT_DIR, fname)
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")

    write("field_vectors.json", field_vectors())
    write("ntt_vectors.json", ntt_vectors())
    write("msm_g1_vectors.json",
          msm_vectors(FqArith, (G1X, G1Y), "g1", (1024, 4096), 0x5EED_61))
    write("msm_g2_vectors.json",
          msm_vectors(Fq2Arith, (G2X, G2Y), "g2", (1024,), 0x5EED_62))


if __name__ == "__main__":
    main()
