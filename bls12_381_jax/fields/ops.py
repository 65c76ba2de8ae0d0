"""Batched Montgomery field arithmetic over 16-bit limbs (pure jnp).

A re-derivation of the reference's 64-bit-limb CIOS core
(``field.cuh:509-576``) in plain 32-bit integer jnp: limbs are 16 bits
stored in uint32 lanes, so every limb product fits exactly in a lane
(16x16 -> 32) and column sums of up to 2K products (< 2^22 for Fq's K=24)
accumulate in uint32 with deferred carries.  The batch axis is wide and
every op is independent across it.

Array convention: a field-element batch is a uint32 array of shape
``(K, *batch)`` — limbs-first ("SoA"), little-endian limb order, canonical
(every limb < 2^16, value < p).  All ops broadcast over the batch axes.

Like the reference, all arithmetic is branch-free / constant-time by
construction: XLA `where` selects play the role of ``field_cmov``
(``field.cuh:358-499``) — every lane computes both sides, which
preserves the reference's constant-time discipline for free.

Two independent forms of each op live here: the whole-array forms every
caller uses (carry lookahead, a `lax.scan` CIOS multiply) and the unrolled
list-based chains, kept as the independent reference the tests compare
the whole-array forms against.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .field import FieldSpec
from .limbs import LIMB_BITS, LIMB_MASK

# numpy scalar, not jnp: a module-level jnp constant would initialize the
# XLA backend at import time, which breaks jax.distributed.initialize()
# (parallel/mesh.py:init_distributed must run before any backend touch).
MASK = np.uint32(LIMB_MASK)


def _const_limbs(arr: np.ndarray, batch_ndim: int):
    """(K,) numpy constant -> (K, 1, 1, ...) jnp uint32 for broadcasting."""
    return jnp.asarray(arr.reshape(arr.shape + (1,) * batch_ndim), dtype=jnp.uint32)


def zeros(spec: FieldSpec, batch_shape=()) -> jnp.ndarray:
    return jnp.zeros((spec.num_limbs,) + tuple(batch_shape), dtype=jnp.uint32)


def broadcast_constant(spec: FieldSpec, limbs: np.ndarray, batch_shape=()):
    """Constant (K,) -> (K, *batch) array."""
    out = jnp.asarray(limbs, dtype=jnp.uint32)
    out = out.reshape((spec.num_limbs,) + (1,) * len(batch_shape))
    return jnp.broadcast_to(out, (spec.num_limbs,) + tuple(batch_shape))


def one_mont(spec: FieldSpec, batch_shape=()):
    return broadcast_constant(spec, spec.one_mont_limbs, batch_shape)


# -----------------------------------------------------------------------------
# Limb-level helpers
# -----------------------------------------------------------------------------

def _carry_normalize(cols):
    """List of uint32 column sums -> normalized limbs (<2^16) + final carry."""
    out = []
    carry = jnp.zeros_like(cols[0])
    for c in cols:
        v = c + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return out, carry


def _sub_limbs(a_rows, b_rows):
    """Limbwise a - b with borrow chain. Returns (diff rows, borrow_out).

    Inputs are normalized (<2^16) rows; output rows normalized.
    """
    out = []
    borrow = jnp.zeros_like(a_rows[0])
    for ai, bi in zip(a_rows, b_rows):
        v = ai - bi - borrow  # uint32 wraps; true value in low 17 bits' view
        out.append(v & MASK)
        borrow = (v >> LIMB_BITS) & jnp.uint32(1)  # 1 iff ai - bi - borrow < 0
    return out, borrow


def _cond_sub_modulus(spec: FieldSpec, rows, top_carry):
    """Given value = top_carry*2^(16K) + rows (< 2p), reduce to [0, p)."""
    n_rows = [jnp.asarray(jnp.uint32(int(x))) for x in spec.modulus_limbs]
    d, borrow = _sub_limbs(rows, [jnp.broadcast_to(x, rows[0].shape) for x in n_rows])
    # value >= p  iff  top_carry == 1 or no borrow
    take_d = (top_carry | (jnp.uint32(1) - borrow)).astype(jnp.bool_)
    return [jnp.where(take_d, di, ri) for di, ri in zip(d, rows)]


def _stack(rows):
    return jnp.stack(rows, axis=0)


def _rows(x):
    return [x[i] for i in range(x.shape[0])]


# --- whole-array carry machinery --------------------------------------------
#
# Carry and borrow chains over the limb axis are resolved without a loop:
# two rounds of split-and-shift bring every column to at most 2^16, which
# leaves one bit of carry per limb, generated (column = 2^16) or passed
# through (column = 2^16 - 1).  Packing those per-limb flags into the bits
# of one uint32 per lane turns the whole chain into one integer addition
# (see _carry_in).  No op loops over limbs, so XLA emits no device-side
# loop (on a GPU each iteration of one is a kernel launch) and the traced
# graph stays small.  The unrolled list-based helpers above are kept as
# independent implementations for tests.


def _shift_up(x, d: int = 1):
    """Row k takes row k-d of ``x`` (limb axis 0); the low d rows are 0.

    Zeros come from the input (zeros_like) rather than from constants so
    they inherit its varying-manual-axes type and stay legal inside
    `shard_map` bodies."""
    return jnp.concatenate([jnp.zeros_like(x[:d]), x[:-d]])


def _carry_in(g, p):
    """Carry into every limb (and out of the top one) from per-limb
    generate ``g`` and propagate ``p`` flags (uint32 0/1, limb axis 0):
    carry_out[k] = g[k] | (p[k] & carry_in[k]).  Returns (carry_in rows,
    carry out of the top limb)."""
    L = g.shape[0]
    if L > 31:
        raise ValueError(f"carry chains of {L} limbs do not fit a uint32")
    bit = jnp.arange(L, dtype=jnp.uint32).reshape((L,) + (1,) * (g.ndim - 1))
    G = jnp.sum(g << bit, axis=0, dtype=jnp.uint32)
    A = G | jnp.sum(p << bit, axis=0, dtype=jnp.uint32)
    # A + G generates where g, passes a carry on where p: its carry into
    # each bit is the carry into that limb.
    cin = (A + G) ^ A ^ G
    return (cin[None] >> bit) & jnp.uint32(1), cin >> L


def _normalize_arr(s):
    """(L, *b) uint32 column sums (each < 2^32 - 2^16) -> (normalized
    limbs, carry out of the top limb)."""
    hi = s >> LIMB_BITS
    c = (s & MASK) + _shift_up(hi)              # < 2^17
    hi2 = c >> LIMB_BITS                        # 0 or 1
    c = (c & MASK) + _shift_up(hi2)             # <= 2^16
    g = c >> LIMB_BITS                          # c == 2^16: carry out
    p = (c == MASK).astype(jnp.uint32)          # c == 2^16-1: carry through
    cin, top = _carry_in(g, p)
    return (c + cin) & MASK, hi[-1] + hi2[-1] + top


def _sub_arr(a, b):
    """Limbwise a - b on (K, *b) arrays of normalized limbs -> (diff,
    borrow out of the top limb)."""
    b = jnp.broadcast_to(b, a.shape)
    g = (a < b).astype(jnp.uint32)              # borrow out regardless
    p = (a == b).astype(jnp.uint32)             # borrow out iff borrow in
    bin_, top = _carry_in(g, p)
    return (a - b - bin_) & MASK, top


def _modulus_arr(spec: FieldSpec, batch_ndim: int):
    return _const_limbs(spec.modulus_limbs, batch_ndim)


def _cond_sub_modulus_arr(spec: FieldSpec, rows, top_carry):
    """Given value = top_carry*2^(16K) + rows (< 2p), reduce to [0, p)."""
    n = _modulus_arr(spec, rows.ndim - 1)
    d, borrow = _sub_arr(rows, n)
    take_d = (top_carry | (jnp.uint32(1) - borrow)).astype(jnp.bool_)
    return jnp.where(take_d[None], d, rows)


# -----------------------------------------------------------------------------
# Public ops
# -----------------------------------------------------------------------------

def add_unrolled_impl(spec: FieldSpec, a, b):
    """(a + b) mod p, unrolled carry chain (independent form for tests)."""
    cols = [a[i] + b[i] for i in range(spec.num_limbs)]
    rows, carry = _carry_normalize(cols)
    return _stack(_cond_sub_modulus(spec, rows, carry))


def add_impl(spec: FieldSpec, a, b):
    """(a + b) mod p, canonical in/out."""
    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    s = jnp.broadcast_to(a, a.shape[:1] + bshape) + jnp.broadcast_to(
        b, b.shape[:1] + bshape)
    rows, carry = _normalize_arr(s)
    return _cond_sub_modulus_arr(spec, rows, carry)


add = partial(jax.jit, static_argnums=0)(add_impl)


def sub_unrolled_impl(spec: FieldSpec, a, b):
    """(a - b) mod p, unrolled borrow chain (independent form for tests)."""
    d, borrow = _sub_limbs(_rows(a), _rows(b))
    # if borrow: add p back
    n = spec.modulus_limbs
    cols = [di + jnp.where(borrow.astype(jnp.bool_), jnp.uint32(int(n[i])), jnp.uint32(0)) for i, di in enumerate(d)]
    rows, _ = _carry_normalize(cols)
    return _stack(rows)


def sub_impl(spec: FieldSpec, a, b):
    """(a - b) mod p, canonical in/out."""
    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a_b = jnp.broadcast_to(a, a.shape[:1] + bshape)
    d, borrow = _sub_arr(a_b, b)
    # if borrow: add p back (one more normalize pass)
    n = _modulus_arr(spec, len(bshape))
    mask = borrow.astype(jnp.bool_)
    rows, _ = _normalize_arr(d + jnp.where(mask[None], n, jnp.uint32(0)))
    return rows


sub = partial(jax.jit, static_argnums=0)(sub_impl)


@partial(jax.jit, static_argnums=0)
def neg(spec: FieldSpec, a):
    """(-a) mod p, canonical in/out (constant-time: p - a, then 0 if a==0)."""
    n = jnp.broadcast_to(_modulus_arr(spec, a.ndim - 1), a.shape)
    d, _ = _sub_arr(n, a)
    z = is_zero(spec, a)
    return jnp.where(z[None], jnp.uint32(0), d)


@partial(jax.jit, static_argnums=0)
def is_zero(spec: FieldSpec, a):
    """bool array over batch: a == 0."""
    acc = a[0] == 0
    for i in range(1, spec.num_limbs):
        acc = acc & (a[i] == 0)
    return acc


@partial(jax.jit, static_argnums=0)
def eq(spec: FieldSpec, a, b):
    acc = a[0] == b[0]
    for i in range(1, spec.num_limbs):
        acc = acc & (a[i] == b[i])
    return acc


def cmov(mask, a, b):
    """Select a where mask else b; mask has batch shape."""
    return jnp.where(mask[None], a, b)


@partial(jax.jit, static_argnums=0)
def double(spec: FieldSpec, a):
    return add(spec, a, a)


def _modulus_col(spec: FieldSpec, batch_ndim: int):
    """Modulus limbs shaped (K, 1, ..) for broadcasting against (K, *batch)."""
    return _const_limbs(spec.modulus_limbs, batch_ndim)


def _redc(spec: FieldSpec, t):
    """Word-serial Montgomery reduction of a normalized 2K-limb value.

    ``t`` is a (2K, *batch) uint32 array with limbs < 2^16 representing
    T < R*p; returns the canonical K-limb value T * R^{-1} mod p.
    Column sums stay < 2^22 (deferred carries), retired limb carries are
    folded forward each step.
    """
    K = spec.num_limbs
    n_col = _modulus_col(spec, t.ndim - 1)  # (K, 1, ..)
    n0 = jnp.uint32(spec.n0_inv)
    for i in range(K):
        m = (t[i] * n0) & MASK  # low 16 bits exact under uint32 wraparound
        p = m[None] * n_col  # (K, *batch), exact products < 2^32
        t = t.at[i : i + K].add(p & MASK)
        t = t.at[i + 1 : i + K + 1].add(p >> LIMB_BITS)
        # retire limb i: its carry flows into limb i+1
        t = t.at[i + 1].add(t[i] >> LIMB_BITS)
    rows, carry = _carry_normalize([t[K + j] for j in range(K)])
    rows = _cond_sub_modulus(spec, rows, carry)
    return _stack(rows)


def mont_mul_impl(spec: FieldSpec, a, b):
    """Unrolled Montgomery product (schoolbook convolution + word-serial REDC).

    The default multiply is the scan-based CIOS below, whose traced graph
    is ~20x smaller; this unrolled form is kept as an independent
    implementation for equivalence tests.
    """
    K = spec.num_limbs
    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = jnp.zeros((2 * K,) + bshape, dtype=jnp.uint32)
    for i in range(K):
        p = a[i][None] * b  # (K, *batch), exact: < 2^32
        t = t.at[i : i + K].add(p & MASK)
        t = t.at[i + 1 : i + K + 1].add(p >> LIMB_BITS)
    # normalize to 16-bit limbs (product < R^2 so no carry out of 2K limbs)
    rows, _ = _carry_normalize([t[j] for j in range(2 * K)])
    return _redc(spec, _stack(rows))


mont_mul_unrolled = partial(jax.jit, static_argnums=0)(mont_mul_impl)


def mont_sqr_impl(spec: FieldSpec, a):
    """Montgomery square; exploits product symmetry (~40% fewer limb muls,
    the same trick as the reference's optimized squaring, field.cuh:586-685).
    """
    K = spec.num_limbs
    t = jnp.zeros((2 * K,) + a.shape[1:], dtype=jnp.uint32)
    for i in range(K):
        # cross terms a[i]*a[j] for j > i, counted twice
        if i + 1 < K:
            p = a[i][None] * a[i + 1 :]  # (K-i-1, *batch)
            lo2 = (p & MASK) << 1  # < 2^17, fine in deferred columns
            hi2 = (p >> LIMB_BITS) << 1
            t = t.at[2 * i + 1 : i + K].add(lo2)
            t = t.at[2 * i + 2 : i + K + 1].add(hi2)
        # diagonal a[i]^2
        p = a[i] * a[i]
        t = t.at[2 * i].add(p & MASK)
        t = t.at[2 * i + 1].add(p >> LIMB_BITS)
    rows, _ = _carry_normalize([t[j] for j in range(2 * K)])
    return _redc(spec, _stack(rows))


mont_sqr_unrolled = partial(jax.jit, static_argnums=0)(mont_sqr_impl)


def mont_mul_cios_impl(spec: FieldSpec, a, b):
    """Montgomery product via word-serial CIOS under `lax.scan` — a ~20x
    smaller traced graph than the unrolled schoolbook+REDC (mont_mul_impl).

    Bit-identical result; used inside large fully-traced programs (the
    sharded MSM monolith) where the unrolled form blows up XLA compile
    time.  Classic CIOS: per scan step, add a_i*b and m_i*p into a
    (K+2)-limb deferred-carry accumulator, then shift one limb down
    (exact: limb 0 is ≡ 0 mod 2^16 by choice of m_i).

    Overflow: each step adds ≤ 4*(2^16-1) to a limb; over K ≤ 24 steps the
    deferred sums stay < 2^22, far under uint32.  `m = (acc0 * n0) & MASK`
    is exact because uint32 wraparound preserves values mod 2^16.
    """
    K = spec.num_limbs
    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    b_b = jnp.broadcast_to(b, (K,) + bshape)
    a_b = jnp.broadcast_to(a, (K,) + bshape)
    n_col = _modulus_col(spec, len(bshape))
    n0 = jnp.uint32(spec.n0_inv)
    # init derived from the inputs so it carries their vma type (shard_map)
    zero_row = jnp.zeros_like(a_b[0] + b_b[0])
    acc0 = jnp.broadcast_to(zero_row[None], (K + 2,) + bshape)

    def step(acc, a_i):
        p = a_i[None] * b_b
        acc = acc.at[0:K].add(p & MASK)
        acc = acc.at[1 : K + 1].add(p >> LIMB_BITS)
        m = (acc[0] * n0) & MASK
        q = m[None] * n_col
        acc = acc.at[0:K].add(q & MASK)
        acc = acc.at[1 : K + 1].add(q >> LIMB_BITS)
        carry = acc[0] >> LIMB_BITS
        acc = jnp.concatenate([acc[1:], jnp.zeros_like(acc[:1])])
        acc = acc.at[0].add(carry)
        return acc, None

    acc, _ = jax.lax.scan(step, acc0, a_b)
    rows, _ = _normalize_arr(acc)
    # result < 2p: rows[K] is the single overflow bit, rows[K+1] == 0
    return _cond_sub_modulus_arr(spec, rows[:K], rows[K])


mont_mul_cios = partial(jax.jit, static_argnums=0)(mont_mul_cios_impl)

# Default multiply/square: the scan-based CIOS (compact traced graph).
mont_mul = mont_mul_cios


@partial(jax.jit, static_argnums=0)
def mont_sqr(spec: FieldSpec, a):
    """Montgomery square (CIOS a*a; the unrolled symmetric-product variant
    is mont_sqr_unrolled — fewer limb muls but far worse XLA compile)."""
    return mont_mul_cios_impl(spec, a, a)


@partial(jax.jit, static_argnums=0)
def to_mont(spec: FieldSpec, a):
    """Standard -> Montgomery form: a * R^2 * R^{-1} = a*R."""
    r2 = broadcast_constant(spec, spec.r2_limbs, ())
    r2 = r2.reshape((spec.num_limbs,) + (1,) * (a.ndim - 1))
    return mont_mul(spec, a, jnp.broadcast_to(r2, a.shape))


@partial(jax.jit, static_argnums=0)
def from_mont(spec: FieldSpec, a):
    """Montgomery -> standard form: a * 1 * R^{-1}."""
    one = jnp.zeros_like(a).at[0].set(jnp.uint32(1))
    return mont_mul(spec, a, one)


@partial(jax.jit, static_argnums=(0, 2))
def pow_const(spec: FieldSpec, a, exponent: int):
    """Montgomery-form a^exponent for a static python-int exponent.

    Compiled as a single square-and-multiply `fori_loop` over the exponent's
    bit array (MSB first) with a constant-time select per bit — keeps the
    traced graph small (one mont_sqr + one mont_mul body) regardless of
    exponent size.
    """
    import jax

    if exponent == 0:
        return jnp.broadcast_to(
            one_mont(spec, ()).reshape((spec.num_limbs,) + (1,) * (a.ndim - 1)),
            a.shape,
        )
    bits = np.array([int(c) for c in bin(exponent)[2:]], dtype=np.uint32)
    bits_arr = jnp.asarray(bits)
    a_b = jnp.broadcast_to(a, a.shape)
    one = jnp.broadcast_to(
        jnp.asarray(
            spec.one_mont_limbs.reshape((spec.num_limbs,) + (1,) * (a.ndim - 1)),
            dtype=jnp.uint32,
        ),
        a.shape,
    )

    def body(i, acc):
        acc = mont_sqr(spec, acc)
        mul = mont_mul(spec, acc, a_b)
        take = bits_arr[i] == 1
        return jnp.where(take, mul, acc)

    import jax.lax as lax

    return lax.fori_loop(0, bits.shape[0], body, one)


@partial(jax.jit, static_argnums=0)
def inv_mont(spec: FieldSpec, a):
    """Montgomery-form inverse via Fermat: a^(p-2), constant-time.

    inv(0) = 0, matching the reference's documented edge-case behavior
    (test_security_edge_cases.cu "inv(0) -> 0 handling").
    """
    return pow_const(spec, a, spec.modulus - 2)
