"""Pippenger multi-scalar multiplication for G1 and G2 in plain JAX.

The reference GPU pipeline (msm_kernels.cu:602-903) is built around
hand-written atomics: signed-digit decomposition -> warp-aggregated
histogram -> radix sort -> per-bucket serial/cooperative accumulation ->
triangle reduction.  Whole-array XLA ops offer no atomics and no
data-dependent shapes, so bucket accumulation is re-derived around three
things they do well — `lax.sort`, wide sequential `lax.scan`, and the
group structure of the curve:

1. **Signed-digit windows** (same math as msm_kernels.cu:68-213): w-bit
   digits in [-(2^(w-1)-1), 2^(w-1)], bucket id |d| in 1..2^(w-1), zero
   digits routed to a sentinel key — the constant-shape analog of the
   reference's trash bucket.
2. **Sort by bucket** (`lax.sort_key_val` on (key, index) pairs, then a
   single coordinate gather) — playing CUB DeviceRadixSort's role.
3. **Prefix-sum bucket extraction**: arrange the sorted points
   column-major into an (R, L) tile; one `lax.scan` down the R rows
   (a full-width mixed add per step — the hot loop, total work = N mixed
   adds, same as the GPU) yields per-column inclusive prefix sums; a
   log2(L) Hillis-Steele pass stitches column carries.  Because the curve
   is a *group*, each bucket sum is then just S[end_b] - S[start_b - 1]
   (prefix difference with a negated point) — no segmented reduction, no
   multiplicity bounds, no data-dependent shapes, constant-time for any
   scalar distribution.
4. **Weighted triangle reduction** sum_b b * bucket_b via suffix scans
   over a (Rb, Lb) bucket tile (log-depth), replacing the reference's
   Blelloch suffix-scan kernel (msm_kernels.cu:375-513).
5. **Horner window combine** with w doublings per window
   (msm_kernels.cu:528-596 analog) under `lax.scan`.

Accumulation runs in **homogeneous projective coordinates with the RCB16
complete formulas** (curves/projective.py): one branch-free straight-line
formula per add — no doubling fallback, no identity cmov chains — which
is both ~40% fewer field muls than the reference's complete-Jacobian
approach (point.cuh:803-915) and constant-time by construction.  Results
convert to Jacobian at the public boundary.

Everything is static-shape, branch-free, and batched over lanes; the same
code instantiates G1 (Fq) and G2 (Fq2) via the field adapters.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants
from ..curves import projective as pj
from ..curves.field_adapters import FQ_ADAPTER, FQ2_ADAPTER
from ..fields import FQ, FR, ops

tree_map = jax.tree_util.tree_map

# Accumulation group ops: homogeneous projective with the RCB16 complete
# formulas (curves/projective.py) — no doubling fallback, no edge-case
# chains, ~40%% fewer field muls per add than the Jacobian cmov path.
# Results convert back to Jacobian at the MSM boundary (public contract).
g_identity = pj.proj_identity
g_add = pj.proj_add
g_madd_signed = pj.proj_add_mixed_signed
g_cmov = pj.proj_cmov
g_neg = pj.proj_neg
g_double = pj.proj_double

FR_BITS = 255
# curves/glv.GLV_HALF_BITS mirrored statically (glv imports lazily here to
# keep module load light; the value is a lattice fact, not tunable).
GLV_HALF_BITS_STATIC = 128

# Window and lane-tile caps.  Untuned starting values for the GPU, carried
# over from the earlier whole-array cost model: the per-window cost is the
# N-mixed-add row scan while the bucket-tile work is lane-parallel, so w
# is pushed as high as the bucket tile allows.  Re-tune from a trace.
MSM_WINDOW_CAP_SMALL = 15
MSM_WINDOW_CAP_LARGE = 16
MSM_LARGE_LOG_N = 22
MSM_LANE_TILE_LOG_CAP = 15


def window_bits_for(n: int, F=None) -> int:
    """Window size heuristic (analog of the table in msm.cuh:115-133).

    w = log2(n) - 1, clipped to [4, cap]; the cap is one bit higher from
    2^MSM_LARGE_LOG_N points, where the per-window sort/gather outweighs
    the doubled bucket-tile work.

    ``F``: the curve's field adapter.  For G2 (Fq2) every bucket op is
    3 Fq muls on 2x the limb planes, so the cap drops by one
    (gpu_config.cuh's per-kernel strategy tables keep the analogous
    G1/G2 distinction via the templated launch configs).
    """
    if n <= 0:
        return 4
    ln = max(1, n).bit_length() - 1
    cap = (MSM_WINDOW_CAP_LARGE if ln >= MSM_LARGE_LOG_N
           else MSM_WINDOW_CAP_SMALL)
    if F is not None and getattr(F, "fq_muls_per_mul", 1) > 1:
        cap -= 1
    return int(np.clip(ln - 1, 4, cap))


def triangle_lb(nb: int) -> int:
    """Lane width Lb of the (Rb, Lb) triangle-reduction bucket tile.

    Rb must not exceed Lb (rows are padded up to Lb lanes for the batched
    weighted-sum pass), so grow Lb past 128 once nb > 2^14."""
    return max(min(128, nb), 1 << (nb.bit_length() // 2))


def lane_tile_for(n: int, F=None) -> int:
    """Lane width L for the bucket-accumulation tile (R = ceil(n/L) rows).

    Cost model: the row scan is R sequential mixed adds, the column
    stitch is log2(L) sequential lane adds — balance R against log2(L)
    with wide lanes to keep the device full.

    For G2 (``F.limb_planes == 2``) the tile holds twice the bytes per
    lane, so the cap is one step narrower.
    """
    ln = max(4, n).bit_length() - 1
    cap = MSM_LANE_TILE_LOG_CAP
    if F is not None and getattr(F, "limb_planes", 1) > 1:
        cap -= 1
    return 1 << int(np.clip((ln + 8) // 2, 3, cap))


@partial(jax.jit, static_argnums=(1, 2))
def decompose_signed_digits(scalars_std, w: int, num_bits: int = FR_BITS):
    """Standard-form Fr scalars (16, N) -> (T, N) |digit| and sign arrays.

    T = ceil(255 / w) + 1 (the +1 absorbs the final carry).  Digits are in
    [-(2^(w-1)-1), 2^(w-1)]; returns (abs_digit uint32, sign bool).
    Mirrors the signed-digit-with-carry scheme of msm_kernels.cu:68-213.
    Jitted: unfused, the ~20 elementwise passes per window cost more memory
    round trips than every other stage combined at 2^20.

    ``num_bits < FR_BITS`` (the GLV halves) uses the tight window count
    ceil((num_bits+1)/w): the top window's raw value plus carry is then
    <= 2^(w-1), so it can neither flip sign nor carry out.
    """
    n_win = num_windows(w, num_bits)
    K = scalars_std.shape[0]
    n_shape = scalars_std.shape[1:]
    # pad two zero limb rows for cross-boundary extraction
    z = jnp.zeros((2,) + n_shape, dtype=jnp.uint32)
    s = jnp.concatenate([scalars_std.astype(jnp.uint32), z], axis=0)
    wmask = jnp.uint32((1 << w) - 1)
    half = jnp.uint32(1 << (w - 1))
    full = jnp.uint32(1 << w)

    abs_digits = []
    signs = []
    carry = jnp.zeros(n_shape, dtype=jnp.uint32)
    for t in range(n_win):
        o = w * t
        i0, sh = o >> 4, o & 15
        raw = s[i0] >> jnp.uint32(sh)
        if sh:
            raw = raw | (s[i0 + 1] << jnp.uint32(16 - sh))
        raw = raw & wmask
        v = raw + carry  # <= 2^w
        is_neg = v > half
        digit = jnp.where(is_neg, full - v, v)  # |d|
        carry = jnp.where(is_neg, jnp.uint32(1), jnp.uint32(0))
        abs_digits.append(digit)
        signs.append(is_neg)
    return jnp.stack(abs_digits), jnp.stack(signs)


# Sort keys: bucket id in bits 31..1, digit sign in bit 0 (sorting by the
# combined key still groups buckets contiguously; the sign rides along and
# is recovered from the sorted tile — no separate sign gather).  SENT2 marks
# zero digits and points at infinity; PAD2 marks tile padding.  Both decode
# to bucket ids far above any real bucket (w <= 16 -> bucket <= 2^15).
_SENT2 = 0xFFFFFFFE
_PAD2 = 0xFFFFFFFF


@jax.jit
def _keys_from_digits(abs_d, signs):
    key2 = (abs_d << 1) | signs.astype(jnp.uint32)
    return jnp.where(abs_d == 0, jnp.uint32(_SENT2), key2)


@partial(jax.jit, static_argnums=(1, 2))
def decompose_window_keys(scalars_std, w: int, num_bits: int = FR_BITS):
    """Standard-form Fr scalars (16, N) -> (T, N) uint32 sort keys
    (bucket << 1 | sign; zero digits -> sentinel)."""
    return _keys_from_digits(
        *decompose_signed_digits(scalars_std, w, num_bits))


def _row_width(nplanes: int) -> int:
    """Element-major row width for the gather (pad columns).

    Rows are padded to a multiple of 32 u32 columns, at least 64 (256
    bytes), so each gathered row is whole aligned sectors: G1's 48 limb
    planes pad to 64 columns; G2's 96 need no padding.
    """
    return max(64, ((nplanes + 31) // 32) * 32)


@partial(jax.jit, static_argnums=0)
def _stage_pack_rows(F, x, y):
    """Affine coordinates (limbs-first trees) -> (n, W) element-major rows.

    Runs ONCE per MSM (amortized over all T windows); the per-window gather
    then moves whole point rows instead of 2K separate limb planes.
    """
    leaves = jax.tree_util.tree_leaves(x) + jax.tree_util.tree_leaves(y)
    planes = jnp.concatenate(leaves, axis=0)  # (C, n)
    W = _row_width(planes.shape[0])
    if W > planes.shape[0]:
        planes = jnp.pad(planes, ((0, W - planes.shape[0]), (0, 0)))
    return planes.T  # (n, W)


def _coord_planes(F) -> int:
    """Limb planes per affine coordinate (Fq: 24; Fq2: 48)."""
    return FQ.num_limbs * (2 if F is FQ2_ADAPTER else 1)


def _coord_tree(F, t, off: int):
    """Slice coordinate planes [off, off+C) of a (R, W, L) tile back into
    the field adapter's element tree ((c0, c1) tuple for Fq2)."""
    K = FQ.num_limbs
    if F is FQ2_ADAPTER:
        return (t[:, off:off + K], t[:, off + K:off + 2 * K])
    return t[:, off:off + K]


def _shift_dyn(F, P, d, direction: str):
    """Shift a lane-batched Jacobian by a (possibly traced) distance d along
    the last axis, filling vacated slots with the identity.  Uses roll +
    mask so the op shape is independent of d (fori-loop friendly)."""
    L = jax.tree_util.tree_leaves(P[0])[0].shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    ident = g_identity(F, F.batch_shape(P[0]))
    if direction == "right":  # element l takes value from l-d
        rolled = tree_map(lambda c: jnp.roll(c, d, axis=-1), P)
        mask = idx >= d
    else:  # element l takes value from l+d
        rolled = tree_map(lambda c: jnp.roll(c, -d, axis=-1), P)
        mask = idx < (L - d)
    return g_cmov(F, mask, rolled, ident)


def _scan_steps(L: int) -> int:
    return max(L - 1, 1).bit_length() if L > 1 else 0


def _lane_prefix_exclusive(F, P):
    """Exclusive prefix point-sums along the last axis.

    Hillis-Steele rolled into a fori_loop (one traced jac_add body)."""
    L = jax.tree_util.tree_leaves(P[0])[0].shape[-1]

    def body(i, acc):
        d = jnp.int32(1) << i
        return g_add(F, acc, _shift_dyn(F, acc, d, "right"))

    incl = jax.lax.fori_loop(0, _scan_steps(L), body, P)
    return _shift_dyn(F, incl, jnp.int32(1), "right")


def _lane_suffix_inclusive(F, P):
    L = jax.tree_util.tree_leaves(P[0])[0].shape[-1]

    def body(i, acc):
        d = jnp.int32(1) << i
        return g_add(F, acc, _shift_dyn(F, acc, d, "left"))

    return jax.lax.fori_loop(0, _scan_steps(L), body, P)


def _sum_last_axis(F, P):
    """Point sum along the last axis (suffix scan, take slot 0)."""
    S = _lane_suffix_inclusive(F, P)
    return tree_map(lambda c: c[..., 0], S)


def _gather_points(A, idx):
    """Gather an affine batch along its batch axis (limbs-first leaves)."""
    x, y, inf = A
    gx = tree_map(lambda c: c[:, idx], x)
    gy = tree_map(lambda c: c[:, idx], y)
    return gx, gy, inf[idx]


def _gather_jac_rows(P_rows, r_idx, l_idx):
    """Gather from scan-stacked Jacobian rows: leaves (R, K, L) -> (K, B)."""
    return tree_map(lambda c: c[r_idx, :, l_idx].T, P_rows)


def _weighted_index_sum(F, P):
    """sum_j j * P[j] over the last axis via suffix sums (log depth).

    sum_j j*P_j = sum_{k>=1} S_k where S_k = sum_{j>=k} P_j.
    Returns (weighted_sum, plain_sum) — the plain sum (= S_0) falls out free.
    """
    S = _lane_suffix_inclusive(F, P)
    total_tail = _sum_last_axis(F, S)  # sum_k S_k  (k >= 0)
    S0 = tree_map(lambda c: c[..., 0], S)
    return g_add(F, total_tail, g_neg(F, S0)), S0


def _double_n(F, P, times: int):
    def body(_, acc):
        return g_double(F, acc)

    return jax.lax.fori_loop(0, times, body, P)


# -----------------------------------------------------------------------------
# Stage-jitted pipeline.
#
# The MSM is orchestrated as a Python loop over windows calling a handful of
# moderately-sized jitted stages (identical shapes every window, so each
# stage compiles exactly once per MSM configuration).  A single monolithic
# jit would contain dozens of group-op bodies and blow up XLA compile time;
# stage granularity keeps every compile unit at roughly one-to-two Jacobian
# adds' worth of HLO — the same scale as the NTT butterfly graphs.
# -----------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 2, 3))
def _stage_sort_tile(F, key2, R: int, L: int, em_rows, inf):
    """Sort by bucket key, row-gather the element-major point table, and
    tile column-major into scan rows.  No field arithmetic — compiles fast.

    Plays the role of CUB DeviceRadixSort + index packing
    (msm_kernels.cu:763-781).  Layout choices:
    * points are gathered as element-major ROWS from the (n, W) table
      built once per MSM by _stage_pack_rows, instead of gathering 2K
      separate limb planes;
    * the column-major tiling permutation is COMPOSED into the gather
      index so the rows move through device memory once; the
      (R, L, W) -> (R, W, L) limb-plane transpose afterwards is a
      streaming pass;
    * digit signs ride in bit 0 of the sort key and infinity/zero-digit
      slots in the sentinel range, so no separate sign/inf gathers exist;
      the row scan folds the negation into its add (g_madd_signed).

    Returns (bucket_sorted, x_rows, y_rows, sign_rows, inf_rows); the
    sorted bucket ids feed _stage_boundary's searchsorted.
    """
    n = inf.shape[-1]
    key2 = jnp.where(inf, jnp.uint32(_SENT2), key2)
    pad = R * L - n
    if pad:
        key2 = jnp.concatenate(
            [key2, jnp.full((pad,), jnp.uint32(_PAD2))])
    key_sorted, perm = jax.lax.sort_key_val(
        key2, (jnp.arange(R * L, dtype=jnp.uint32) % jnp.uint32(n))
    )
    # tile[r, l] = sorted[l*R + r]; compose into the gather (tiny u32 ops)
    tile_u32 = lambda a: a.reshape(L, R).swapaxes(-1, -2)
    gidx = tile_u32(perm).reshape(-1)  # (R*L,)
    ks_rows = tile_u32(key_sorted)     # (R, L)

    rows = em_rows[gidx]               # (R*L, W) vectorized row gather
    t = jnp.moveaxis(rows.reshape(R, L, -1), -1, 1)  # (R, W, L)
    C = _coord_planes(F)
    x_rows = _coord_tree(F, t, 0)
    y_rows = _coord_tree(F, t, C)
    sign_rows = (ks_rows & 1) != 0
    inf_rows = ks_rows >= jnp.uint32(_SENT2)
    return key_sorted >> 1, x_rows, y_rows, sign_rows, inf_rows


@partial(jax.jit, static_argnums=0)
def _stage_scan(F, x_rows, y_rows, sign_rows, inf_rows):
    """Row scan of signed mixed adds — the hot loop (total work = N mixed
    adds, the analog of the bucket-accumulation kernels,
    msm_kernels.cu:268-366).

    Returns per-column inclusive prefix sums (R, .., L) and column totals.
    """
    ident = g_identity(F, inf_rows.shape[1:])  # (L,) or (B, L) batched

    def step(acc, row):
        rx, ry, rsign, rinf = row
        acc = g_madd_signed(F, acc, (rx, ry, rinf), rsign)
        return acc, acc

    col_total, prefix_rows = jax.lax.scan(
        step, ident, (x_rows, y_rows, sign_rows, inf_rows))
    return col_total, prefix_rows


@partial(jax.jit, static_argnums=0)
def _stage_stitch(F, col_total):
    """Exclusive prefix point-sums of column totals (log-depth lane scan)."""
    return _lane_prefix_exclusive(F, col_total)


def _boundary_core(F, key_sorted, col_carry, nb: int, prefix_rows):
    """Dense bucket sums by prefix difference at sorted bucket boundaries.

    bucket_b = S[end_b] - S[start_b - 1]; S[e] = col_carry[l] + prefix[r, l].
    Replaces the reference's per-bucket accumulation + trash-bucket logic
    with a pure gather/group-subtract (constant shape for any input).
    """
    leaf = jax.tree_util.tree_leaves(prefix_rows[0])[0]
    R, L = leaf.shape[0], leaf.shape[-1]
    b_vals = jnp.arange(1, nb + 1, dtype=jnp.uint32)
    starts = jnp.searchsorted(key_sorted, b_vals, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(key_sorted, b_vals, side="right").astype(jnp.int32)
    cnt = ends - starts

    pos = jnp.concatenate([ends - 1, starts - 1])  # (2*nb,)
    valid = jnp.concatenate([cnt > 0, (cnt > 0) & (starts > 0)])
    p = jnp.clip(pos, 0, R * L - 1)
    r_idx, l_idx = p % R, p // R
    part = _gather_jac_rows(prefix_rows, r_idx, l_idx)  # (K, 2*nb)
    carry = tree_map(lambda c: c[..., l_idx], col_carry)
    S = g_add(F, part, carry)
    S = g_cmov(F, valid, S, g_identity(F, (2 * nb,)))
    S_hi = tree_map(lambda c: c[..., :nb], S)
    S_lo = tree_map(lambda c: c[..., nb:], S)
    sums = g_add(F, S_hi, g_neg(F, S_lo))
    return g_cmov(F, cnt > 0, sums, g_identity(F, (nb,)))


_stage_boundary = partial(jax.jit, static_argnums=(0, 3))(_boundary_core)


@partial(jax.jit, static_argnums=(0, 2))
def _stage_triangle_scans(F, buckets, nb: int):
    """Suffix-scan phase of sum_b b*P_b over a (Rb, Lb) bucket tile.

    Row- and column-sum scans are batched into one (2, Lb)-lane pass so the
    stage contains a single pair of scan bodies.
    Returns (w_rows, w_cols, total).
    """
    Lb = triangle_lb(nb)
    Rb = nb // Lb
    tiled = tree_map(lambda c: c.reshape(c.shape[:-1] + (Rb, Lb)), buckets)

    # Col_l = sum_r P[r,l]; Row_r = sum_l P[r,l]
    ct = tree_map(lambda c: c.swapaxes(-1, -2), tiled)  # (K, Lb, Rb)
    col_l = _sum_last_axis(F, ct)   # (K, Lb)
    row_sum = _sum_last_axis(F, tiled)  # (K, Rb)
    # pad rows to Lb lanes and batch both weighted sums in one pass
    batch = jax.tree_util.tree_leaves(buckets)[0].shape[1:-1]  # () or (B,)
    idR = g_identity(F, batch + (Lb - Rb,)) if Lb > Rb else None
    if Lb > Rb:
        row_sum = tree_map(
            lambda c, i: jnp.concatenate([c, i], axis=-1), row_sum, idR
        )
    both = tree_map(lambda a, b: jnp.stack([a, b], axis=-2), row_sum, col_l)
    w_both, s_both = _weighted_index_sum(F, both)  # (K, 2)
    w_rows = tree_map(lambda c: c[..., 0], w_both)
    w_cols = tree_map(lambda c: c[..., 1], w_both)
    total = tree_map(lambda c: c[..., 1], s_both)  # sum of Col_l = sum_j P_j
    return w_rows, w_cols, total


@partial(jax.jit, static_argnums=(0, 4))
def _stage_triangle_combine(F, w_rows, w_cols, total, lb_bits: int):
    """W = 2^lb_bits * w_rows + w_cols + total (window triangle total)."""
    part = _double_n(F, w_rows, lb_bits)
    out = g_add(F, part, w_cols)
    return g_add(F, out, total)


@partial(jax.jit, static_argnums=(0, 2))
def _stage_horner(F, Ws, w: int):
    """Combine window sums top-down: acc = 2^w acc + W_t
    (msm_kernels.cu:528-596 analog)."""
    Ws_rev = tree_map(lambda c: c[::-1], Ws)

    def combine(acc, Wt):
        acc = _double_n(F, acc, w)
        return g_add(F, acc, Wt), 0

    top = tree_map(lambda c: c[0], Ws_rev)
    rest = tree_map(lambda c: c[1:], Ws_rev)
    out, _ = jax.lax.scan(combine, top, rest)
    return out


@partial(jax.jit, static_argnums=(0, 2, 3))
def _stage_sort_scan(F, key2, R: int, L: int, em_rows, inf):
    """Fused sort+gather+scan: one dispatch for the per-window linear
    work.  The window body is issued as TWO programs (this +
    :func:`_stage_window_tail`) instead of six, to cut per-dispatch
    overhead."""
    key_sorted, x_rows, y_rows, sign_rows, inf_rows = _stage_sort_tile(
        F, key2, R, L, em_rows, inf)
    col_total, prefix_rows = _stage_scan(
        F, x_rows, y_rows, sign_rows, inf_rows)
    return key_sorted, col_total, prefix_rows


@partial(jax.jit, static_argnums=(0, 3, 4))
def _stage_window_tail(F, key_sorted, col_total, nb: int, lb_bits: int,
                       prefix_rows):
    """Fused stitch+boundary+triangle+combine (the window's bucket math
    after the scan) — the second of the two per-window programs."""
    col_carry = _stage_stitch(F, col_total)
    buckets = _boundary_core(F, key_sorted, col_carry, nb, prefix_rows)
    w_rows, w_cols, total = _stage_triangle_scans(F, buckets, nb)
    return _stage_triangle_combine(F, w_rows, w_cols, total, lb_bits)


@partial(jax.jit, static_argnums=(0, 2, 3))
def _stage_sort_scan_batch(F, keys, R: int, L: int, em_rows, inf):
    """Batched :func:`_stage_sort_scan` (keys (B, n), shared table)."""
    key_sorted, x_rows, y_rows, sign_rows, inf_rows = \
        _stage_sort_tile_batch(F, keys, R, L, em_rows, inf)
    col_total, prefix_rows = _stage_scan(
        F, x_rows, y_rows, sign_rows, inf_rows)
    return key_sorted, col_total, prefix_rows


@partial(jax.jit, static_argnums=(0, 3, 4))
def _stage_window_tail_batch(F, key_sorted, col_total, nb: int,
                             lb_bits: int, prefix_rows):
    col_carry = _stage_stitch(F, col_total)
    buckets = _stage_boundary_batch(F, key_sorted, col_carry, nb,
                                    prefix_rows)
    w_rows, w_cols, total = _stage_triangle_scans(F, buckets, nb)
    return _stage_triangle_combine(F, w_rows, w_cols, total, lb_bits)


@partial(jax.jit, static_argnums=0)
def _stage_neg_y(F, y):
    return F.neg(y)


@partial(jax.jit, static_argnums=0)
def _stage_to_jac(F, P):
    """Homogeneous projective accumulator -> Jacobian (public contract)."""
    return pj.proj_to_jac(F, P)


@partial(jax.jit, static_argnums=(0, 2))
def _stage_horner_to_jac(F, Ws, w: int):
    return _stage_to_jac(F, _stage_horner(F, Ws, w))


@partial(jax.jit, static_argnums=0)
def _stage_ws_add(F, Wa, Wb):
    """Group-add two stacked window-sum trees (projective, leaves (T, K)).

    Used by the sequential point-chunk paths to fold each chunk's
    per-window bucket sums into a running total — sums over points
    distribute per window — so the w*T-doubling Horner ladder runs once
    per MSM instead of once per chunk.  The T axis is moved behind the
    limb axis for the add (the library's trailing-batch convention),
    then restored so the combined tree keeps the Horner stage's layout."""
    sw = lambda P: tree_map(lambda c: c.swapaxes(0, 1), P)
    return sw(g_add(F, sw(Wa), sw(Wb)))


def glv_split_scalars(scalars_std):
    """Standard-form Fr scalars (16, ..., N) -> ([k1 || k2], 128) along the
    point axis: the GLV halves of k = k1 + k2*lambda, zero-padded back to
    16 limbs.  Pairs with :func:`glv_extend_bases` / GLV-uploaded bases."""
    from ..curves import glv as glv_mod

    k1, k2 = glv_mod.decompose(scalars_std)
    pad = ((0, FR.num_limbs - k2.shape[0]),) + ((0, 0),) * (k2.ndim - 1)
    k2 = jnp.pad(k2, pad)  # decompose keeps only the live k2 limbs
    return jnp.concatenate([k1, k2], axis=-1), glv_mod.GLV_HALF_BITS


def glv_extend_bases(F, A):
    """Affine batch A -> [A || phi(A)] (one batched Fq mul by beta)."""
    from ..curves import glv as glv_mod

    x, y, inf = A
    px, py, pinf = glv_mod.endomorphism(F, A)
    return (jnp.concatenate([x, px], axis=-1),
            jnp.concatenate([y, py], axis=-1),
            jnp.concatenate([inf, pinf], axis=-1))


# -----------------------------------------------------------------------------
# Device-memory budget accounting (msm.cuh:42-45's "GPU memory ~= 3-4x
# input" analog).
#
# The pipeline's working set per point: the element-major table, the sorted
# tile (both W u32 columns), the gathered x/y coordinate rows, and the
# projective prefix rows (3 coordinates).  When an MSM (or a shared-bases
# batch) would exceed the budget, the point (or batch) axis is split into
# sequential pieces that reuse the same compiled stages — the memory-aware
# chunking the reference documents for batch MSM (core/msm.rs:1136-1141),
# extended here to single MSMs so the 2^24 cap (constants.MAX_MSM_LOG_SIZE)
# is reachable on a card whose memory holds only part of the working set.
# -----------------------------------------------------------------------------


def _msm_bytes_per_point(F) -> int:
    """Approximate pipeline working-set bytes per point (u32 planes).

    em+tile rows, gathered x/y rows, 3-coordinate prefix rows, the input
    affine batch itself, and a 25% margin for XLA transients (an
    estimate; compare with ``memory_stats()["peak_bytes_in_use"]`` of a
    run at the size in question)."""
    C = _coord_planes(F)          # planes per affine coordinate
    W = _row_width(2 * C)
    return 4 * (2 * W + 7 * C) * 5 // 4


# Share of the device's memory limit the pipeline plans for; the rest is
# headroom for XLA scratch and the caller's own buffers.
MSM_BUDGET_FRACTION = 0.5
# Budget where the device reports no memory limit (the CPU backend).
_DEFAULT_BUDGET_MB = 8192


def _hbm_budget_bytes() -> int:
    """Pipeline device-memory budget: MIDNIGHT_MSM_HBM_BUDGET_MB when set,
    else MSM_BUDGET_FRACTION of the device's ``bytes_limit`` (what the
    JAX process reserved on the card), else 8 GiB."""
    import os

    env = os.environ.get("MIDNIGHT_MSM_HBM_BUDGET_MB")
    if env is not None:
        return int(env) << 20
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"] * MSM_BUDGET_FRACTION)
    return _DEFAULT_BUDGET_MB << 20


def _live_accel_bytes(*exclude_trees) -> int:
    """Bytes of live device arrays on the accelerator, excluding the given
    input trees (their footprint is already in _msm_bytes_per_point).

    This is what the caller is holding against the device: cached
    expanded SRS bases, NTT domains, polynomial buffers.  A PLONK prover
    at K=20 keeps ~2 GB of those live while committing.  It counts live
    arrays, not what the process reserved or XLA's scratch."""
    try:
        platform = jax.default_backend()
        skip = set()
        for t in exclude_trees:
            for leaf in jax.tree_util.tree_leaves(t):
                skip.add(id(leaf))
        total = 0
        for a in jax.live_arrays():
            if id(a) in skip:
                continue
            try:
                if next(iter(a.devices())).platform != platform:
                    continue
            except Exception:
                continue
            total += a.size * a.dtype.itemsize
        return total
    except Exception:  # census is advisory; never fail an MSM over it
        return 0


def _available_budget(*exclude_trees) -> int:
    """Budget available to the pipeline right now: the configured
    budget minus what the caller already holds live on the device, floored
    at 1/8 of the budget so chunk counts stay sane even under extreme
    memory pressure."""
    budget = _hbm_budget_bytes()
    return max(budget - _live_accel_bytes(*exclude_trees), budget // 8)


def _split_points(n: int, budget: int, bpp: int) -> int:
    """Number of sequential point-chunks needed to fit the budget."""
    need = -(-n * bpp // budget)
    return max(1, need)


def msm(F, scalars, A, *, window_bits: int | None = None,
        scalars_montgomery: bool = True, glv: bool | None = None):
    """MSM: sum_i scalars[i] * A[i] over the curve with field adapter F.

    scalars: (16, N) uint32 Fr limbs (Montgomery form by default, matching
    the device convention; the standard-form conversion mirrors
    scalars_from_montgomery_kernel, icicle_curve_api.cu:46-58).
    A: affine batch (x, y, inf).  Returns a single Jacobian point.

    ``glv`` (G1 only; default from MIDNIGHT_MSM_GLV) splits every scalar
    k = k1 + k2*lambda and runs the pipeline over [k1 || k2] against
    [A || phi(A)]: half the 255-bit window count on 2n points — the
    n-linear sort/scan work is unchanged, but the per-window bucket
    triangle, the Horner combine, and the fixed per-stage dispatch all
    halve.  (The reference's GLV block, point_ops.cu:103-480, is gated
    off as "reserved for future optimization"; this is the working form.)
    """
    x, y, inf = A
    n = inf.shape[-1]
    if n > (1 << constants.MAX_MSM_LOG_SIZE):
        raise ValueError(f"MSM size {n} exceeds 2^{constants.MAX_MSM_LOG_SIZE}")
    if scalars_montgomery:
        scalars = ops.from_mont(FR, scalars)
    budget = _available_budget(scalars, x, y, inf)
    if glv is None:
        from ..runtime.config import config

        mode = config().msm_glv
        if mode == "auto":
            # GLV halves the window count but doubles the point set; it
            # can win only while the doubled pipeline still fits the
            # budget in ONE shot — once chunking kicks in, 2 pieces x T/2
            # windows is the same work as 1 x T and the split overhead
            # loses.
            glv = (F is FQ_ADAPTER and
                   2 * n * _msm_bytes_per_point(F) <= budget)
        else:
            glv = mode == "on"
    glv = bool(glv) and F is FQ_ADAPTER
    n_budget = n * (2 if glv else 1)
    n_pieces = _split_points(n_budget, budget, _msm_bytes_per_point(F))
    if n_pieces > 1:
        # Sequential point-chunks; equal sizes so the staged jits compile
        # once and every later piece reuses them.  Prefer a piece count
        # dividing n exactly — for power-of-two sizes this lands on
        # power-of-two pieces whose stage shapes are already compiled
        # (2^24 -> 4 x 2^22).  Equal chunks share one window geometry
        # (same w, T), so each chunk's PER-WINDOW bucket sums fold into a
        # running total (sums over points distribute per window) and the
        # w*T-doubling Horner ladder + Jacobian conversion run ONCE per
        # MSM instead of once per chunk.
        while n % n_pieces and n_pieces < 64:
            n_pieces += 1
        per = -(-n // n_pieces)
        w = window_bits or window_bits_for(per * (2 if glv else 1), F)
        Ws_acc = None
        for s in range(0, n, per):
            e = min(s + per, n)
            Ai = (tree_map(lambda c: c[..., s:e], x),
                  tree_map(lambda c: c[..., s:e], y), inf[..., s:e])
            Wi = _msm_window_sums(F, scalars[..., s:e], Ai, w, glv)
            Ws_acc = Wi if Ws_acc is None else _stage_ws_add(F, Ws_acc, Wi)
        return _stage_horner_to_jac(F, Ws_acc, w)
    w = window_bits or window_bits_for(n_budget, F)
    Ws = _msm_window_sums(F, scalars, (x, y, inf), w, glv)
    return _stage_horner_to_jac(F, Ws, w)


def _msm_window_sums(F, scalars_std, A, w: int, glv: bool):
    """Per-window signed-bucket sums for one point set: the full staged
    pipeline short of the Horner ladder (projective window sums stacked
    over the T windows, leaves (T, K)).

    Split out of :func:`msm` so the sequential point-chunk path can
    group-add window sums across chunks (:func:`_stage_ws_add`) and pay the
    ladder once."""
    x, y, inf = A
    num_bits = FR_BITS
    if glv:
        scalars_std, num_bits = glv_split_scalars(scalars_std)
        x, y, inf = glv_extend_bases(F, (x, y, inf))
    n = inf.shape[-1]
    nb = 1 << (w - 1)
    # lane width: ~sqrt(n), power of two, within [8, 2048]
    L = lane_tile_for(n, F)
    R = -(-n // L)
    lb_bits = triangle_lb(nb).bit_length() - 1

    keys = decompose_window_keys(scalars_std, w, num_bits)  # (T, N)
    T = int(keys.shape[0])
    em_rows = _stage_pack_rows(F, x, y)       # (N, W), shared by all windows

    window_sums = []
    for t in range(T):
        key_sorted, col_total, prefix_rows = _stage_sort_scan(
            F, keys[t], R, L, em_rows, inf)
        window_sums.append(_stage_window_tail(
            F, key_sorted, col_total, nb, lb_bits, prefix_rows))
    return tree_map(lambda *cs: jnp.stack(cs), *window_sums)


def msm_g1(scalars, A, **kw):
    return msm(FQ_ADAPTER, scalars, A, **kw)


def msm_g2(scalars, A, **kw):
    return msm(FQ2_ADAPTER, scalars, A, **kw)


# -----------------------------------------------------------------------------
# Batched MSM with shared bases — ONE pipeline for all B scalar sets
# (core/msm.rs:1179-1407 analog).  The batch axis is folded between the limb
# and lane axes of every tile, so each per-window stage runs once over
# B-times-wider lanes instead of B times: one batched sort, one row gather
# from the SHARED point table, one scan of B*L-wide mixed adds.  At small N
# this both amortizes dispatch overhead and fills the lanes the single-MSM
# tiles leave idle.
# -----------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 2, 3))
def _stage_sort_tile_batch(F, keys, R: int, L: int, em_rows, inf):
    """Batched :func:`_stage_sort_tile`: keys (B, n) against one shared
    (n, W) element-major table.  Returns tiles with the batch axis between
    limbs and lanes — x_rows leaves (R, K, B, L)."""
    B, n = keys.shape
    keys = jnp.where(inf[None, :], jnp.uint32(_SENT2), keys)
    pad = R * L - n
    if pad:
        keys = jnp.concatenate(
            [keys, jnp.full((B, pad), jnp.uint32(_PAD2))], axis=1)
    iota = jnp.broadcast_to(
        jnp.arange(R * L, dtype=jnp.uint32) % jnp.uint32(n), (B, R * L))
    key_sorted, perm = jax.lax.sort_key_val(keys, iota)
    tile = lambda a: a.reshape(B, L, R).swapaxes(-1, -2)  # (B, R, L)
    gidx = tile(perm).reshape(-1)          # (B*R*L,)
    rows = em_rows[gidx]                   # (B*R*L, W) shared-table gather
    t = jnp.transpose(rows.reshape(B, R, L, -1), (1, 3, 0, 2))  # (R, W, B, L)
    C = _coord_planes(F)
    x_rows = _coord_tree(F, t, 0)
    y_rows = _coord_tree(F, t, C)
    ks_rows = jnp.moveaxis(tile(key_sorted), 0, 1)  # (R, B, L)
    sign_rows = (ks_rows & 1) != 0
    inf_rows = ks_rows >= jnp.uint32(_SENT2)
    return key_sorted >> 1, x_rows, y_rows, sign_rows, inf_rows


@partial(jax.jit, static_argnums=(0, 3))
def _stage_boundary_batch(F, key_sorted, col_carry, nb: int, prefix_rows):
    """Batched :func:`_stage_boundary`: key_sorted (B, R*L); col_carry
    leaves (K, B, L); prefix leaves (R, K, B, L) -> buckets (K, B, nb)."""
    core = lambda ks, cc, pr: _boundary_core(F, ks, cc, nb, pr)
    return jax.vmap(core, in_axes=(0, 1, 2), out_axes=1)(
        key_sorted, col_carry, prefix_rows)


def msm_batch_shared(F, scalars_b, A, *, window_bits: int | None = None,
                     factor: int = 1, scalars_montgomery: bool = True,
                     glv: bool = False):
    """B MSMs over shared affine bases in one batched pipeline.

    scalars_b: (16, B, N) uint32 Fr limbs (limbs-first, batch in the
    middle).  A: the affine bases — already expanded by
    :func:`expand_bases` when factor > 1, and GLV-extended beforehand
    when ``glv`` (scalars are then split to the 128-bit halves here).
    Returns a Jacobian point batch with leaves (K, B) — one result per
    scalar set.
    """
    x, y, inf = A
    n_eff = inf.shape[-1]
    if scalars_montgomery:
        scalars_b = ops.from_mont(FR, scalars_b)
    num_bits = FR_BITS
    if glv:
        scalars_b, num_bits = glv_split_scalars(scalars_b)
    w = window_bits or window_bits_for(n_eff // max(factor, 1), F)
    return _msm_batch_core(F, scalars_b, A, w, max(factor, 1), num_bits)


def _msm_batch_core(F, scalars_b, A, w: int, factor: int, num_bits: int):
    """Batched window loop over standard-form (GLV-split) scalars, with
    memory-aware chunking on both axes (core/msm.rs:1136-1141 analog) —
    all splitting happens at the window-sum level so the Horner ladder
    runs once regardless of how the inputs were partitioned."""
    return _stage_horner_to_jac(
        F, _batch_window_sums(F, scalars_b, A, w, factor, num_bits), w)


def _batch_window_sums(F, scalars_b, A, w: int, factor: int, num_bits: int):
    """Per-window bucket sums for the shared-bases batch pipeline (leaves
    (T', K, B)), with memory-aware chunking on both axes:

    * the batched tiles scale with B while the element-major table is
      shared, so the per-shot group size is capped by the budget and
      groups run sequentially (equal sizes -> the staged jits compile
      once); group window sums concatenate along the batch axis;
    * when even ONE batch member overflows the budget left after the
      caller's live buffers, the point axis chunks first (every factor
      block sliced consistently) and the chunks' window sums fold with
      :func:`_stage_ws_add` — the same rule as :func:`msm_precomputed`.
    """
    x, y, inf = A
    n_eff = inf.shape[-1]
    B = scalars_b.shape[1]
    m = scalars_b.shape[-1]
    C = _coord_planes(F)
    W = _row_width(2 * C)
    budget = _available_budget(scalars_b, x, y, inf)
    shared = 4 * W * n_eff
    per_b = 4 * (W + 5 * C) * n_eff
    if shared + per_b > budget and m > 1:
        n_pieces = -(-(shared + per_b) // budget) + 1
        while m % n_pieces and n_pieces < 64:
            n_pieces += 1
        per = -(-m // n_pieces)
        if per >= m:
            per = max(1, m // 2)  # always shrink: a no-progress split recurses forever
        Ws_acc = None
        for s in range(0, m, per):
            e = min(s + per, m)
            Ai = (_slice_factor_blocks(x, m, s, e, factor),
                  _slice_factor_blocks(y, m, s, e, factor),
                  _slice_factor_blocks(inf, m, s, e, factor))
            Wi = _batch_window_sums(
                F, scalars_b[..., s:e], Ai, w, factor, num_bits)
            Ws_acc = Wi if Ws_acc is None else _stage_ws_add(F, Ws_acc, Wi)
        return Ws_acc
    room = max(budget - shared, per_b)
    bg = max(1, min(B, room // per_b))
    if bg < B:
        ngroups = -(-B // bg)
        per = -(-B // ngroups)
        parts = []
        for s in range(0, B, per):
            parts.append(_batch_window_sums(
                F, scalars_b[:, s:s + per], A, w, factor, num_bits))
        return tree_map(lambda *cs: jnp.concatenate(cs, axis=-1), *parts)
    nb = 1 << (w - 1)
    L = lane_tile_for(n_eff, F)
    R = -(-n_eff // L)
    lb_bits = triangle_lb(nb).bit_length() - 1

    abs_d, signs = decompose_signed_digits(scalars_b, w, num_bits)  # (T, B, N)
    if factor > 1:
        Tp = precompute_window_span(w, factor, num_bits)
        T0, n0 = abs_d.shape[0], abs_d.shape[-1]
        padw = Tp * factor - T0
        if padw:
            z = jnp.zeros((padw, B, n0), abs_d.dtype)
            abs_d = jnp.concatenate([abs_d, z])
            signs = jnp.concatenate([signs, z.astype(signs.dtype)])
        regroup = lambda a: (a.reshape(factor, Tp, B, n0)
                             .transpose(1, 2, 0, 3)
                             .reshape(Tp, B, factor * n0))
        abs_d, signs = regroup(abs_d), regroup(signs)
    keys = _keys_from_digits(abs_d, signs)  # (T', B, n_eff)
    em_rows = _stage_pack_rows(F, x, y)

    window_sums = []
    for t in range(keys.shape[0]):
        key_sorted, col_total, prefix_rows = _stage_sort_scan_batch(
            F, keys[t], R, L, em_rows, inf)
        window_sums.append(_stage_window_tail_batch(
            F, key_sorted, col_total, nb, lb_bits, prefix_rows))
    return tree_map(lambda *cs: jnp.stack(cs), *window_sums)


# -----------------------------------------------------------------------------
# Chunked MSM: the same staged pipeline vmapped over a leading chunk axis.
#
# This is the GSPMD scale-out form: inputs carry a leading (D, ...) axis,
# every stage is vmapped over it, and sharding that axis over a device mesh
# makes each chunk's sort/scan/reduction device-local (all ops are batched,
# so the partitioner never needs cross-chunk communication until the final
# combine).  Compile cost stays per-stage — the monolithic alternative
# (msm_traceable below) produces a ~270k-eqn graph that XLA chews on for
# tens of minutes.
# -----------------------------------------------------------------------------


def msm_chunked(F, scalars_c, A_c, *, window_bits: int | None = None,
                scalars_montgomery: bool = True, mapper: str = "pmap",
                glv: bool = False, factor: int = 1):
    """MSM over chunked inputs; returns per-chunk Jacobian points (D leading).

    scalars_c: (D, 16, mloc) uint32; A_c leaves (D, K, nloc) / inf (D, nloc).
    Result: Jacobian point with leaves (D, K) — one partial MSM per chunk;
    group-add them for the total (parallel/msm.py::_combine_chunks).

    ``glv`` (G1 only): each chunk's scalars are split to the GLV halves and
    its bases extended with the endomorphism image in-chunk — the sharded
    path gets the same window-halving the single-chip path has (the
    reference composes precompute with every MSM variant,
    core/msm.rs:594-651; GLV composes the same way here).

    ``factor`` > 1: ``A_c`` holds per-chunk bases already expanded by
    :func:`expand_bases` (with this ``window_bits``/``factor`` and, when
    ``glv``, GLV-extended *before* expansion) — chunk the expanded array so
    every chunk carries its own factor blocks (chunk each block, then
    concatenate per chunk: :func:`parallel.msm.chunk_msm_inputs` handles
    the layout).

    mapper:
      "pmap" — one chunk per local device, stages compiled once as plain
               single-device programs and replicated (no GSPMD partitioner
               involvement; the multi-chip production path).
      "vmap" — chunk axis as an ordinary batch on one device (testing, or
               sharded via jit-with-shardings where GSPMD cost is fine).
    """
    x, y, inf = A_c
    D, nloc = inf.shape[0], inf.shape[-1]
    glv = glv and F is FQ_ADAPTER
    num_bits = GLV_HALF_BITS_STATIC if glv else FR_BITS
    factor = max(factor, 1)
    # base count per chunk after in-chunk GLV extension (factor>1 bases
    # arrive pre-extended, so only factor==1 doubles here)
    n_eff = nloc * (2 if glv and factor == 1 else 1)
    w = window_bits or window_bits_for(n_eff // factor, F)
    nb = 1 << (w - 1)
    L = lane_tile_for(n_eff, F)
    R = -(-n_eff // L)
    lb_bits = triangle_lb(nb).bit_length() - 1
    T = (precompute_window_span(w, factor, num_bits) if factor > 1
         else num_windows(w, num_bits))

    if mapper == "pmap":
        mapf = jax.pmap
    else:
        mapf = partial(jax.vmap, in_axes=0)

    def prelude(sc_c):
        """Per-chunk: scalar form conversion, GLV split, digit split into
        sort keys (factor-regrouped to match expanded bases)."""
        sc = sc_c  # (16, mloc) limbs-first within the chunk
        if scalars_montgomery:
            sc = ops.from_mont(FR, sc)
        if glv:
            sc, _ = glv_split_scalars(sc)
        if factor > 1:
            abs_d, signs = _digits_for_precompute(sc, w, factor, num_bits)
            return _keys_from_digits(abs_d, signs)
        return decompose_window_keys(sc, w, num_bits)  # (T, n_eff)

    prelude_m = mapf(prelude)
    extend = mapf(lambda xx, yy, ii: glv_extend_bases(F, (xx, yy, ii)))
    pack_rows = mapf(lambda xx, yy: _stage_pack_rows(F, xx, yy))
    sort_tile = mapf(lambda k, em, ii: _stage_sort_tile(F, k, R, L, em, ii))
    scan_s = mapf(lambda xr, yr, sr, ir: _stage_scan(F, xr, yr, sr, ir))
    stitch = mapf(lambda ct: _stage_stitch(F, ct))
    boundary = mapf(lambda ks, cc, pr: _stage_boundary(F, ks, cc, nb, pr))
    tri = mapf(lambda b: _stage_triangle_scans(F, b, nb))
    comb = mapf(lambda wr, wc, tt: _stage_triangle_combine(F, wr, wc, tt, lb_bits))
    horner = mapf(lambda ws: _stage_horner(F, ws, w))
    to_jac = mapf(lambda p: pj.proj_to_jac(F, p))

    keys = prelude_m(scalars_c)   # (D, T, n_eff) sort keys
    if glv and factor == 1:
        x, y, inf = extend(x, y, inf)  # (D, K, 2*nloc)
    em_rows = pack_rows(x, y)     # (D, n_eff, W)
    window_sums = []
    for t in range(T):
        key_sorted, x_rows, y_rows, sign_rows, inf_rows = sort_tile(
            keys[:, t], em_rows, inf)
        col_total, prefix_rows = scan_s(x_rows, y_rows, sign_rows, inf_rows)
        col_carry = stitch(col_total)
        buckets = boundary(key_sorted, col_carry, prefix_rows)
        w_rows, w_cols, total = tri(buckets)
        window_sums.append(comb(w_rows, w_cols, total))
    # (D, T, K..) so the mapped axis stays leading for pmap
    Ws = tree_map(lambda *cs: jnp.stack(cs, axis=1), *window_sums)
    return to_jac(horner(Ws))  # Jacobian leaves (D, K..)


# -----------------------------------------------------------------------------
# Fully-traceable single-call MSM (experimental).
#
# The whole MSM inside one traced function: the window loop becomes a
# `lax.scan` over the stacked digit arrays (one traced window body).  Even
# with the compact CIOS multiplies this is a ~270k-eqn graph that today's
# XLA takes pathologically long to compile on CPU; the production sharded
# path uses msm_chunked instead.
# -----------------------------------------------------------------------------


def msm_traceable(F, scalars, A, *, window_bits: int | None = None,
                  scalars_montgomery: bool = True):
    """Same contract as :func:`msm`, but one traced graph (jit/shard_map safe).

    All shape-determining quantities (window size, tile dims) derive from
    static array shapes, so this is safe to close over inside `jit`,
    `shard_map`, or `vmap`.
    """
    x, y, inf = A
    n = inf.shape[-1]
    if scalars_montgomery:
        scalars = ops.from_mont(FR, scalars)
    w = window_bits or window_bits_for(n, F)
    nb = 1 << (w - 1)
    L = lane_tile_for(n, F)
    R = -(-n // L)
    lb_bits = triangle_lb(nb).bit_length() - 1

    keys = decompose_window_keys(scalars, w)  # (T, N)
    em_rows = _stage_pack_rows(F, x, y)

    def window(_, key2):
        key_sorted, x_rows, y_rows, sign_rows, inf_rows = _stage_sort_tile(
            F, key2, R, L, em_rows, inf
        )
        col_total, prefix_rows = _stage_scan(
            F, x_rows, y_rows, sign_rows, inf_rows)
        col_carry = _stage_stitch(F, col_total)
        buckets = _stage_boundary(F, key_sorted, col_carry, nb, prefix_rows)
        w_rows, w_cols, total = _stage_triangle_scans(F, buckets, nb)
        Wt = _stage_triangle_combine(F, w_rows, w_cols, total, lb_bits)
        return 0, Wt

    _, Ws = jax.lax.scan(window, 0, keys)
    return pj.proj_to_jac(F, _stage_horner(F, Ws, w))


# -----------------------------------------------------------------------------
# Precomputed-multiples MSM (reference: precompute_bases, core/msm.rs:401-469 /
# msm_precompute_bases_cuda_impl).  With factor f, the base array is expanded
# to [P, 2^(w*T')P, ..., 2^(w*T'(f-1))P] so the window loop shrinks from T to
# T' = ceil(T/f) windows over f*N points — this converts sequential
# window iterations into lane parallelism, the same memory-for-time trade the
# reference documents (~10-30% on GPU, core/msm.rs:370-373).
# -----------------------------------------------------------------------------


def num_windows(w: int, num_bits: int = FR_BITS) -> int:
    """Window count for scalars of ``num_bits``.  Full Fr keeps the
    historical ceil(255/w)+1 (precomputed-base layouts depend on it);
    shorter scalars (the GLV halves) use the tight ceil((num_bits+1)/w)
    — the +1 bit is the signed-digit carry."""
    if num_bits >= FR_BITS:
        return -(-FR_BITS // w) + 1
    return -(-(num_bits + 1) // w)


def precompute_window_span(w: int, factor: int,
                           num_bits: int = FR_BITS) -> int:
    """T' — windows per precomputed multiple (shift = w*T' bits)."""
    return -(-num_windows(w, num_bits) // factor)


def expand_bases(F, A, w: int, factor: int, num_bits: int = FR_BITS):
    """Affine bases (x, y, inf) of n points -> expanded (factor*n) points.

    Block j holds 2^(w*T'*j) * P_i (computed by batched doublings on
    device).  Returns the expanded affine batch; run once at setup time.
    ``num_bits``: scalar bit-length the expansion will serve (128 for
    GLV-split halves — shrinks the per-block shift).

    Large inputs expand in sequential point-slices (the doubling chain is
    pointwise, so any partition is exact): one shot keeps a projective
    doubling pipeline + batch inversion live for the whole array, on top
    of the consumer's own buffers.  MIDNIGHT_EXPAND_CHUNK_LOG
    overrides the 2^20-lane default.
    """
    import os

    if factor <= 1:
        return A
    n = A[2].shape[-1]
    cap = 1 << int(os.environ.get("MIDNIGHT_EXPAND_CHUNK_LOG", "20"))
    if n > cap:
        m = cap
        pieces = []
        for s in range(0, n, m):
            Ai = (tree_map(lambda c: c[..., s:s + m], A[0]),
                  tree_map(lambda c: c[..., s:s + m], A[1]),
                  A[2][..., s:s + m])
            pieces.append(expand_bases(F, Ai, w, factor, num_bits))
        # stitch back block-major: piece leaves are (K, factor*m) ->
        # (K, factor, m); concat pieces along the point axis per block
        def stitch(leaves):
            parts = [l.reshape(l.shape[:-1] + (factor, -1)) for l in leaves]
            return jnp.concatenate(parts, axis=-1).reshape(
                leaves[0].shape[:-1] + (-1,))
        xs = tree_map(lambda *cs: stitch(cs), *[p[0] for p in pieces])
        ys = tree_map(lambda *cs: stitch(cs), *[p[1] for p in pieces])
        infs = stitch([p[2] for p in pieces])
        return (xs, ys, infs)
    span = precompute_window_span(w, factor, num_bits) * w
    blocks = [A]
    cur = pj.affine_to_proj(F, A)
    for _ in range(factor - 1):
        cur = _double_n(F, cur, span)
        blocks.append(pj.proj_to_affine(F, cur))
    xs = tree_map(lambda *cs: jnp.concatenate(cs, axis=-1), *[b[0] for b in blocks])
    ys = tree_map(lambda *cs: jnp.concatenate(cs, axis=-1), *[b[1] for b in blocks])
    infs = jnp.concatenate([b[2] for b in blocks], axis=-1)
    return (xs, ys, infs)


def _digits_for_precompute(scalars_std, w: int, factor: int,
                           num_bits: int = FR_BITS):
    """(T, N) digit arrays regrouped to (T', factor*N) matching expand_bases."""
    abs_d, signs = decompose_signed_digits(scalars_std, w, num_bits)
    T, n = abs_d.shape[0], abs_d.shape[-1]
    Tp = precompute_window_span(w, factor, num_bits)
    pad = Tp * factor - T
    if pad:
        abs_d = jnp.concatenate([abs_d, jnp.zeros((pad, n), abs_d.dtype)])
        signs = jnp.concatenate([signs, jnp.zeros((pad, n), signs.dtype)])
    # window t = j*T' + t'  ->  digit block j feeds base block j
    abs_d = abs_d.reshape(factor, Tp, n).swapaxes(0, 1).reshape(Tp, factor * n)
    signs = signs.reshape(factor, Tp, n).swapaxes(0, 1).reshape(Tp, factor * n)
    return abs_d, signs


def _slice_factor_blocks(tree, m: int, s: int, e: int, factor: int):
    """Slice points [s, e) out of every factor block of a block-major
    expanded array: leaves (..., factor*m) -> (..., factor*(e-s))."""
    def do(c):
        b = c.reshape(c.shape[:-1] + (factor, m))
        return b[..., s:e].reshape(c.shape[:-1] + (factor * (e - s),))

    return tree_map(do, tree)


def msm_precomputed(F, scalars, A_expanded, *, window_bits: int, factor: int,
                    scalars_montgomery: bool = True, glv: bool = False):
    """MSM against bases expanded by :func:`expand_bases` (same w/factor).

    ``glv``: the bases were uploaded GLV-extended ([A || phi(A)] before
    expansion); split the scalars to match and use 128-bit window counts.

    Like :func:`msm`, the point axis chunks sequentially when the pipeline
    working set would overflow the budget *left after the caller's
    live buffers* — the cached-bases path is exactly the one a prover
    calls while holding the expanded SRS + NTT domains on the device
    (every component can fit alone while the composition does not).
    Chunks slice every factor block consistently,
    so each piece is itself a valid precomputed MSM over the sliced bases.
    """
    if factor <= 1 and not glv:
        return msm(F, scalars, A_expanded,
                   window_bits=window_bits,
                   scalars_montgomery=scalars_montgomery, glv=False)
    x, y, inf = A_expanded
    n_eff = inf.shape[-1]
    if scalars_montgomery:
        scalars = ops.from_mont(FR, scalars)
    num_bits = FR_BITS
    if glv:
        scalars, num_bits = glv_split_scalars(scalars)
    m = scalars.shape[-1]          # points per factor block (n, or 2n GLV)
    factor = max(factor, 1)
    n_pieces = _split_points(n_eff, _available_budget(scalars, x, y, inf),
                             _msm_bytes_per_point(F))
    if n_pieces > 1:
        while m % n_pieces and n_pieces < 64:
            n_pieces += 1
        per = -(-m // n_pieces)
        # As in :func:`msm`'s chunk path: the window span T' depends only
        # on (w, factor, num_bits), never the chunk size, so per-window
        # sums fold across chunks and the Horner ladder runs once.
        Ws_acc = None
        for s in range(0, m, per):
            e = min(s + per, m)
            Ai = (_slice_factor_blocks(x, m, s, e, factor),
                  _slice_factor_blocks(y, m, s, e, factor),
                  _slice_factor_blocks(inf, m, s, e, factor))
            Wi = _precomputed_window_sums(
                F, scalars[..., s:e], Ai, window_bits, factor, num_bits)
            Ws_acc = Wi if Ws_acc is None else _stage_ws_add(F, Ws_acc, Wi)
        return _stage_horner_to_jac(F, Ws_acc, window_bits)
    return _msm_precomputed_core(F, scalars, A_expanded, window_bits, factor,
                                 num_bits)


def _msm_precomputed_core(F, scalars_std, A_expanded, w: int, factor: int,
                          num_bits: int):
    """One-shot precomputed-bases window loop (standard-form, GLV-split
    scalars; bases block-major over ``factor`` blocks)."""
    Ws = _precomputed_window_sums(F, scalars_std, A_expanded, w, factor,
                                  num_bits)
    return _stage_horner_to_jac(F, Ws, w)


def _precomputed_window_sums(F, scalars_std, A_expanded, w: int, factor: int,
                             num_bits: int):
    """Per-window bucket sums for the precomputed-bases pipeline (leaves
    (T', K)); the Horner ladder is the caller's (so chunked runs share it)."""
    x, y, inf = A_expanded
    n_eff = inf.shape[-1]
    nb = 1 << (w - 1)
    L = lane_tile_for(n_eff, F)
    R = -(-n_eff // L)
    lb_bits = triangle_lb(nb).bit_length() - 1

    abs_d, signs = _digits_for_precompute(scalars_std, w, factor, num_bits)
    keys = _keys_from_digits(abs_d, signs)
    em_rows = _stage_pack_rows(F, x, y)

    window_sums = []
    for t in range(keys.shape[0]):
        key_sorted, col_total, prefix_rows = _stage_sort_scan(
            F, keys[t], R, L, em_rows, inf)
        window_sums.append(_stage_window_tail(
            F, key_sorted, col_total, nb, lb_bits, prefix_rows))
    return tree_map(lambda *cs: jnp.stack(cs), *window_sums)
