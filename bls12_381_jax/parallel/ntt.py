"""Sharded NTT: Bailey four-step over a 1-D device mesh.

A size-n NTT is factored as n = nA * nB and computed as two batches of
local NTTs with a twiddle multiply and global transposes (`all_to_all`
between devices) in between:

    X[k2 + nB*k1] = sum_{a} w_n^{a*k2} * w_nA^{a*k1}
                    * ( sum_{b} w_nB^{b*k2} * x[a + nA*b] )

Matrix convention: "M-form" of an array v is the row-sharded matrix
``M[a, b] = v[a + nA*b]`` (shape (K, nA/p, nB) per device).  The natural
contiguous sharding of v is exactly the row-sharded M-form *transposed*,
so layout changes are a single global transpose = `all_to_all` + local
swap.  Pipeline (forward, natural in):

    T0: natural -> M-form            (all_to_all)
    1.  local NTT length nB along rows
    2.  multiply by W[a, k2] = w_n^(+-a*k2)   (sharded precomputed table)
    T1: global transpose             (all_to_all)
    3.  local NTT length nA along rows
    ->  result rows hold OUT[k2 + nB*k1]: the "transposed layout"
    T2 (optional): transpose back to natural order (all_to_all)

Forward-to-transposed costs 2 all_to_alls; a full convolution pipeline
(forward-T, pointwise, inverse-from-T) costs 4 and ends in natural order.
This is the multi-device complement to the reference's single-device
kernel-strategy tiers (ntt_kernels.cu:752-811) at sizes beyond one card,
and the all_to_all volume (one full array per transpose) is the
distributed-FFT lower bound.

The inverse from transposed layout is the same bracket with roles
(nA, nB) swapped and inverse twiddles: transposed layout of the forward
IS M-form for the swapped factorization.  1/n scaling falls out of the
two local iNTTs (1/nA * 1/nB = 1/n).
"""

from __future__ import annotations

import threading
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..fields import FR, ops
from ..ntt.domain import get_domain, _powers_on_device
from ..ntt.ntt import _ntt_core, Ordering
from ..oracle import root_of_unity
from .mesh import SHARD_AXIS

tree_map = jax.tree_util.tree_map


def split_sizes(log_n: int, p: int) -> tuple[int, int]:
    """Pick nA * nB = n, both multiples of p, as square as possible."""
    n = 1 << log_n
    la = log_n // 2
    lp = max(p.bit_length() - 1, 0)
    la = min(max(la, lp), log_n - lp)
    return 1 << la, n >> la


_STEP_TW_CACHE: dict = {}
_STEP_TW_LOCK = threading.Lock()


def build_step_twiddles(log_n: int, nA: int, nB: int, inverse: bool, mesh):
    """W[a, b] = w_n^(+-a*b), Montgomery, shape (K, nA, nB), row-sharded.

    Built on device in log2(nB) doubling steps (nA*nB total Montgomery
    muls), cached per (log_n, nA, inverse, mesh devices).
    """
    key = (log_n, nA, inverse, tuple(d.id for d in mesh.devices.flat))
    with _STEP_TW_LOCK:
        got = _STEP_TW_CACHE.get(key)
    if got is not None:
        return got
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, FR.modulus - 2, FR.modulus)
    row_base = _powers_on_device(w, nA)  # (K, nA): w^a
    sharding = NamedSharding(mesh, P(None, SHARD_AXIS, None))

    @partial(jax.jit, out_shardings=sharding)
    def build(rb):
        cur = rb  # (K, nA) = (w^a)^m at step m
        Pm = ops.one_mont(FR, (nA, 1))
        total = 1
        while total < nB:
            grow = ops.mont_mul(FR, Pm, cur[:, :, None])
            Pm = jnp.concatenate([Pm, grow], axis=-1)
            cur = ops.mont_sqr(FR, cur)
            total *= 2
        return Pm[:, :, :nB]

    W = build(row_base)
    with _STEP_TW_LOCK:
        _STEP_TW_CACHE[key] = W
    return W


def _global_transpose(x):
    """Row-sharded (K, r/p, c) of global (r, c) -> row-sharded (K, c/p, r)
    of the transpose.  One tiled all_to_all + local swap."""
    y = jax.lax.all_to_all(x, SHARD_AXIS, split_axis=2, concat_axis=1, tiled=True)
    return y.swapaxes(1, 2)


def _four_step_local(x_loc, W_loc, twA, itwA, twB, itwB, n_invA, n_invB,
                     *, nA: int, nB: int, inverse: bool,
                     transposed_in: bool, transposed_out: bool):
    """Per-device body (runs under shard_map).  x_loc: (K, n/p)."""
    K = x_loc.shape[0]
    p_ = nA * nB * K // x_loc.size  # mesh size (static)
    if transposed_in:
        M = x_loc.reshape(K, nA // p_, nB)  # already M-form rows
    else:
        # natural-contiguous = transposed M-form rows: (K, nB/p, nA)
        G = x_loc.reshape(K, nB // p_, nA)
        M = _global_transpose(G)  # (K, nA/p, nB)
    # _ntt_core's `inverse` only applies the 1/n scale; the direction lives
    # in the twiddle table choice (ntt.py: ntt() uses tw, intt() uses itw).
    tB = itwB if inverse else twB
    tA = itwA if inverse else twA
    M = _ntt_core(M, nB.bit_length() - 1, inverse, Ordering.NN, tB, n_invB)
    M = ops.mont_mul(FR, M, W_loc)
    M2 = _global_transpose(M)  # (K, nB/p, nA)
    M2 = _ntt_core(M2, nA.bit_length() - 1, inverse, Ordering.NN, tA, n_invA)
    # M2 rows hold OUT[b + nB*a]: transposed layout
    if not transposed_out:
        M2 = _global_transpose(M2)  # (K, nA/p, nB): natural layout rows
    return M2.reshape(K, -1)


def _ntt_sharded_impl(x, mesh, inverse: bool, transposed_in: bool,
                      transposed_out: bool):
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("sharded NTT size must be a power of two")
    p = mesh.devices.size
    nA, nB = split_sizes(log_n, p)
    if transposed_in:
        # roles swap: input transposed layout is M-form for (nB, nA)
        nA, nB = nB, nA
    if nA % p or nB % p:
        raise ValueError(f"n=2^{log_n} too small to split over {p} devices")
    domA, domB = get_domain(nA.bit_length() - 1), get_domain(nB.bit_length() - 1)
    W = build_step_twiddles(log_n, nA, nB, inverse, mesh)

    body = partial(
        _four_step_local, nA=nA, nB=nB, inverse=inverse,
        transposed_in=transposed_in, transposed_out=transposed_out,
    )
    rep = P(None, None)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS, None),
                  rep, rep, rep, rep, P(None), P(None)),
        out_specs=P(None, SHARD_AXIS),
    )
    return jax.jit(fn)(x, W, domA.tw, domA.itw, domB.tw, domB.itw,
                       domA.n_inv, domB.n_inv)


def ntt_sharded(x, mesh, *, transposed_out: bool = False):
    """Forward NTT of a (K, n) Montgomery-Fr array sharded over ``mesh``.

    ``transposed_out=True`` leaves the result in four-step transposed
    layout (element k2 + nB*k1 at flat position k2*nA + k1), saving one
    all_to_all; pair with ``intt_sharded(..., transposed_in=True)``.
    """
    return _ntt_sharded_impl(x, mesh, False, False, transposed_out)


def intt_sharded(x, mesh, *, transposed_in: bool = False):
    """Inverse NTT (with 1/n scale); accepts natural or transposed input."""
    return _ntt_sharded_impl(x, mesh, True, transposed_in, False)


_COSET_SHARD_CACHE: dict = {}


def coset_powers_sharded(shift: int, n: int, mesh, inverse: bool = False):
    """[s^0, .., s^(n-1)] Montgomery, (K, n) sharded along the element axis.

    Same doubling construction as the single-chip table
    (ntt/domain.py:_powers_on_device), jitted with sharded output and
    cached per (shift, n, direction, mesh).
    """
    key = (shift, n, inverse, tuple(d.id for d in mesh.devices.flat))
    with _STEP_TW_LOCK:
        got = _COSET_SHARD_CACHE.get(key)
    if got is not None:
        return got
    base = pow(shift, FR.modulus - 2, FR.modulus) if inverse else shift
    seed = _powers_on_device(base, 1)  # (K, 1) = [1]... actually s^0
    cur0 = _powers_on_device(base, 2)[:, 1:]  # (K, 1) = [s]
    sharding = NamedSharding(mesh, P(None, SHARD_AXIS))

    @partial(jax.jit, out_shardings=sharding)
    def build(p, cur):
        total = 1
        while total < n:
            step = jnp.broadcast_to(cur, p.shape)
            p = jnp.concatenate([p, ops.mont_mul(FR, p, step)], axis=-1)
            cur = ops.mont_sqr(FR, cur)
            total *= 2
        return p[:, :n]

    cp = build(seed, cur0)
    with _STEP_TW_LOCK:
        _COSET_SHARD_CACHE[key] = cp
    return cp


def coset_ntt_sharded(x, mesh, shift: int, *, transposed_out: bool = False):
    """Sharded coset NTT: evaluate on {shift * omega^i} over the mesh.

    Elementwise multiply by sharded shift powers, then the four-step
    sharded NTT — the same decomposition as the single-chip path
    (ntt/ntt.py:coset_ntt; reference ntt.cuh:128-220) with the
    coset-power table built shard-local.
    """
    n = x.shape[-1]
    cp = coset_powers_sharded(shift, n, mesh)
    sharding = NamedSharding(mesh, P(None, SHARD_AXIS))
    mul = jax.jit(partial(ops.mont_mul, FR), out_shardings=sharding)
    return ntt_sharded(mul(x, cp), mesh, transposed_out=transposed_out)


def coset_intt_sharded(x, mesh, shift: int, *, transposed_in: bool = False):
    """Inverse of coset_ntt_sharded: sharded iNTT then divide by powers."""
    y = intt_sharded(x, mesh, transposed_in=transposed_in)
    cp = coset_powers_sharded(shift, y.shape[-1], mesh, inverse=True)
    sharding = NamedSharding(mesh, P(None, SHARD_AXIS))
    return jax.jit(partial(ops.mont_mul, FR), out_shardings=sharding)(y, cp)


def ntt_batch_sharded(x, mesh, *, inverse: bool = False):
    """Batch of independent NTTs with the batch axis sharded over the mesh.

    x: (K, B, n) — each device transforms B/p rows locally; zero
    communication (the embarrassingly-parallel axis of the reference's
    batched NTT, ntt_kernels.cu:968-1133, scaled out over chips).
    """
    from ..ntt.domain import get_domain
    from ..ntt.ntt import intt as intt_fn
    from ..ntt.ntt import ntt as ntt_fn

    n = x.shape[-1]
    dom = get_domain(n.bit_length() - 1)
    sharding = NamedSharding(mesh, P(None, SHARD_AXIS, None))
    x = jax.device_put(x, sharding)
    fn = intt_fn if inverse else ntt_fn
    return jax.jit(lambda v: fn(v, domain=dom), out_shardings=sharding)(x)
