"""ctypes loader for the native host-conversion library (native/convert.cpp).

Builds the .so on first use (g++, cached next to the source) and exposes
numpy-array entry points; every function has a pure-numpy/Python fallback
in runtime/types.py so the library degrades gracefully without a
toolchain.  This is the native runtime component that plays the role of
the reference's host-side conversion layer (core/types.rs) — the
device-side compute is all JAX/XLA.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("bls12_381_jax.native")

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native")
_SO = os.path.join(_DIR, "libbls12_381_native.so")

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

FIELD_FQ = 0
FIELD_FR = 1


def _build() -> bool:
    src = os.path.join(_DIR, "convert.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(["make", "-C", _DIR], check=True, capture_output=True)
        return os.path.exists(_SO)
    except (OSError, subprocess.CalledProcessError) as e:
        logger.info("native build failed (%s); using numpy fallbacks", e)
        return False


def lib() -> ctypes.CDLL | None:
    """The loaded native library, building it on first use; None if absent."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SO) and not _build():
            return None
        try:
            L = ctypes.CDLL(_SO)
        except OSError as e:
            logger.info("native load failed (%s); using numpy fallbacks", e)
            return None
        u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
        L.wire_to_limbs16.argtypes = [u64p, u32p, ctypes.c_size_t, ctypes.c_int]
        L.limbs16_to_wire.argtypes = [u32p, u64p, ctypes.c_size_t, ctypes.c_int]
        L.mont_encode_batch.argtypes = [u64p, u64p, ctypes.c_size_t, ctypes.c_int]
        L.mont_decode_batch.argtypes = [u64p, u64p, ctypes.c_size_t, ctypes.c_int]
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        for fn in (L.g1_msm_host, L.g2_msm_host):
            fn.argtypes = [u64p, u64p, u8p, ctypes.c_size_t, u64p]
        L.native_abi_version.restype = ctypes.c_int
        if L.native_abi_version() != 1:
            logger.warning("native ABI mismatch; using numpy fallbacks")
            return None
        _LIB = L
        return _LIB


def available() -> bool:
    return lib() is not None


def wire_to_limbs16(words: np.ndarray) -> np.ndarray:
    """(n, k64) uint64 -> (4*k64, n) uint32 limbs-first."""
    L = lib()
    w = np.ascontiguousarray(words, dtype=np.uint64)
    n, k64 = w.shape
    out = np.empty((4 * k64, n), dtype=np.uint32)
    L.wire_to_limbs16(w, out, n, k64)
    return out


def limbs16_to_wire(limbs: np.ndarray) -> np.ndarray:
    """(4*k64, n) uint32 -> (n, k64) uint64."""
    L = lib()
    a = np.ascontiguousarray(limbs, dtype=np.uint32)
    k16, n = a.shape
    out = np.empty((n, k16 // 4), dtype=np.uint64)
    L.limbs16_to_wire(a, out, n, k16 // 4)
    return out


def mont_encode(words: np.ndarray, field: int) -> np.ndarray:
    """(n, k64) standard-form words -> Montgomery-form words."""
    L = lib()
    w = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty_like(w)
    L.mont_encode_batch(w, out, w.shape[0], field)
    return out


def mont_decode(words: np.ndarray, field: int) -> np.ndarray:
    L = lib()
    w = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty_like(w)
    L.mont_decode_batch(w, out, w.shape[0], field)
    return out


# ---- host Pippenger MSM (native/msm_host.cpp — the BLST multi_exp analog) --


def _ints_to_words(vals, k64: int) -> np.ndarray:
    out = np.zeros((len(vals), k64), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, v in enumerate(vals):
        for w in range(k64):
            out[i, w] = (v >> (64 * w)) & mask
    return out


def _words_to_int(words: np.ndarray) -> int:
    return sum(int(w) << (64 * j) for j, w in enumerate(words))


def msm_host(scalars, bases, curve: str = "g1"):
    """Host Pippenger MSM on int scalars / affine int bases (None = identity).

    G1 bases are (x, y) int pairs; G2 bases ((x0, x1), (y0, y1)) pairs.
    Returns the Jacobian int triple (matching oracle.msm's contract).
    Requires the native library; callers check :func:`available` first.
    """
    from .constants import FR_MODULUS

    L = lib()
    n = len(scalars)
    sc = _ints_to_words([s % FR_MODULUS for s in scalars], 4)
    inf = np.zeros(n, dtype=np.uint8)
    if curve == "g1":
        xy = np.zeros((n, 12), dtype=np.uint64)
        for i, b in enumerate(bases):
            if b is None:
                inf[i] = 1
            else:
                xy[i, :6] = _ints_to_words([b[0]], 6)[0]
                xy[i, 6:] = _ints_to_words([b[1]], 6)[0]
        out = np.zeros(18, dtype=np.uint64)
        L.g1_msm_host(np.ascontiguousarray(sc), xy.reshape(-1), inf, n, out)
        X, Y, Z = (_words_to_int(out[j * 6:(j + 1) * 6]) for j in range(3))
        return (X, Y, Z)
    xy = np.zeros((n, 24), dtype=np.uint64)
    for i, b in enumerate(bases):
        if b is None:
            inf[i] = 1
        else:
            (x0, x1), (y0, y1) = b
            for j, v in enumerate((x0, x1, y0, y1)):
                xy[i, j * 6:(j + 1) * 6] = _ints_to_words([v], 6)[0]
    out = np.zeros(36, dtype=np.uint64)
    L.g2_msm_host(np.ascontiguousarray(sc), xy.reshape(-1), inf, n, out)
    c = [_words_to_int(out[j * 6:(j + 1) * 6]) for j in range(6)]
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
