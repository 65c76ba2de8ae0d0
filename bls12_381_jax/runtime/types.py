"""Bulk type conversion between wire formats and device limb arrays.

Analog of ``core/types.rs``'s ``TypeConverter``: the reference's types
are 4x/6x 64-bit little-endian limbs, ours are 16x/24x 16-bit limbs in
uint32 lanes — the same byte image, so slice-level conversion is a numpy
dtype *view* + widen (vectorized reinterpretation, no per-element Python),
the practical equivalent of the transmute-based O(1) casts
(core/types.rs:148-270).  Montgomery form is preserved byte-for-byte
because both libraries use R = 2^256 (Fr) / 2^384 (Fq) (limbs.py note).

Wire layout: element-major, each element k 64-bit LE words
(Fr: 4 words/32 bytes; Fq: 6 words/48 bytes; Fq2 = c0 || c1; affine
points = x || y with an external infinity mask, matching how the
reference stores `Affine { x, y }` + zero checks).
"""

from __future__ import annotations

import numpy as np

from ..fields import FQ, FR
from ..fields.field import FieldSpec


def u64_words_to_limbs(words: np.ndarray) -> np.ndarray:
    """(n, k64) uint64 LE words -> (k16, n) uint32 16-bit limbs (view+widen)."""
    w = np.ascontiguousarray(words, dtype="<u8")
    n = w.shape[0] if w.ndim == 2 else 1
    u16 = w.reshape(n, -1).view("<u2")  # (n, k64*4)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def limbs_to_u64_words(limbs: np.ndarray) -> np.ndarray:
    """(k16, n) uint32 limbs -> (n, k64) uint64 LE words."""
    a = np.asarray(limbs, dtype=np.uint32)
    if a.ndim == 1:
        a = a[:, None]
    le16 = np.ascontiguousarray(a.T.astype("<u2"))  # (n, k16)
    return le16.view("<u8").copy()


def scalars_from_bytes(data: bytes | np.ndarray) -> np.ndarray:
    """Fr wire bytes (n*32, LE) -> (16, n) uint32 limbs."""
    w = np.frombuffer(data, dtype="<u8").reshape(-1, 4) \
        if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data)
    return u64_words_to_limbs(w)


def scalars_to_bytes(limbs) -> bytes:
    return limbs_to_u64_words(np.asarray(limbs)).tobytes()


def fq_from_bytes(data: bytes | np.ndarray) -> np.ndarray:
    """Fq wire bytes (n*48, LE) -> (24, n) uint32 limbs."""
    w = np.frombuffer(data, dtype="<u8").reshape(-1, 6) \
        if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data)
    return u64_words_to_limbs(w)


def fq_to_bytes(limbs) -> bytes:
    return limbs_to_u64_words(np.asarray(limbs)).tobytes()


def g1_affine_from_bytes(data: bytes) -> tuple:
    """n G1 affine points (x||y, 96 bytes each, LE, standard or Montgomery
    form preserved) -> (x_limbs, y_limbs, inf_mask) host arrays.

    A point encoded as all-zero x and y is treated as the identity, the
    convention the reference's converters use for `is_zero` points.
    """
    w = np.frombuffer(data, dtype="<u8").reshape(-1, 12)
    x = u64_words_to_limbs(np.ascontiguousarray(w[:, :6]))
    y = u64_words_to_limbs(np.ascontiguousarray(w[:, 6:]))
    inf = (x == 0).all(axis=0) & (y == 0).all(axis=0)
    return x, y, inf


def g1_affine_to_bytes(x, y, inf) -> bytes:
    xw = limbs_to_u64_words(np.asarray(x))
    yw = limbs_to_u64_words(np.asarray(y))
    mask = np.asarray(inf).reshape(-1, 1)
    xw = np.where(mask, 0, xw)
    yw = np.where(mask, 0, yw)
    return np.concatenate([xw, yw], axis=1).astype("<u8").tobytes()


def g2_affine_from_bytes(data: bytes) -> tuple:
    """n G2 points (x.c0||x.c1||y.c0||y.c1, 192 bytes each, LE)."""
    w = np.frombuffer(data, dtype="<u8").reshape(-1, 24)
    xc0 = u64_words_to_limbs(np.ascontiguousarray(w[:, 0:6]))
    xc1 = u64_words_to_limbs(np.ascontiguousarray(w[:, 6:12]))
    yc0 = u64_words_to_limbs(np.ascontiguousarray(w[:, 12:18]))
    yc1 = u64_words_to_limbs(np.ascontiguousarray(w[:, 18:24]))
    inf = ((xc0 == 0).all(axis=0) & (xc1 == 0).all(axis=0)
           & (yc0 == 0).all(axis=0) & (yc1 == 0).all(axis=0))
    return (xc0, xc1), (yc0, yc1), inf


def g2_affine_to_bytes(x, y, inf) -> bytes:
    words = [limbs_to_u64_words(np.asarray(c)) for c in (*x, *y)]
    mask = np.asarray(inf).reshape(-1, 1)
    words = [np.where(mask, 0, wv) for wv in words]
    return np.concatenate(words, axis=1).astype("<u8").tobytes()


def _native_field_id(spec: FieldSpec) -> int:
    from .. import native

    return native.FIELD_FR if spec.num_limbs == FR.num_limbs else native.FIELD_FQ


def mont_encode_host(spec: FieldSpec, limbs: np.ndarray) -> np.ndarray:
    """Host-side standard -> Montgomery (for wire data in standard form).

    Uses the native C++ batch CIOS (native/convert.cpp) when available —
    the SRS-upload hot path — with a Python bigint fallback.
    """
    from .. import native

    if native.available():
        words = limbs_to_u64_words(np.asarray(limbs))
        return u64_words_to_limbs(native.mont_encode(words, _native_field_id(spec)))
    from ..fields.limbs import ints_to_limbs, limbs_to_ints

    vals = [spec.to_mont(v) for v in limbs_to_ints(limbs)]
    return ints_to_limbs(vals, spec.num_limbs)


def mont_decode_host(spec: FieldSpec, limbs: np.ndarray) -> np.ndarray:
    from .. import native

    if native.available():
        words = limbs_to_u64_words(np.asarray(limbs))
        return u64_words_to_limbs(native.mont_decode(words, _native_field_id(spec)))
    from ..fields.limbs import ints_to_limbs, limbs_to_ints

    vals = [spec.from_mont(v) for v in limbs_to_ints(limbs)]
    return ints_to_limbs(vals, spec.num_limbs)
