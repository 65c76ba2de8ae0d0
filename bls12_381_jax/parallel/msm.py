"""Sharded Pippenger MSM: points partitioned across chips (GSPMD form).

Strategy (communication-optimal for MSM): inputs carry a leading chunk
axis D = mesh size, sharded over the mesh; every pipeline stage is
vmapped over that axis (msm/pippenger.py::msm_chunked), so each device
runs a full local Pippenger — sort, bucket scan, triangle reduction,
Horner — over its n/D points with zero cross-device traffic.  The
per-chunk results (3 field elements each, a few KB) are then tree-summed
with the group law; XLA inserts the tiny all-gather for that final
combine.  Total inter-device traffic is D points regardless of n.

(Reducing per-window bucket arrays across devices instead would move
2^(w-1) points per window between devices — strictly worse.  Modular
point addition is not a `psum`-able monoid XLA knows, so the final
combine runs the group law redundantly on every device; at D points that
is noise.)

Why GSPMD/vmap rather than a `shard_map` monolith: each stage compiles
separately in seconds, while one traced graph of the whole MSM is ~270k
jaxpr equations and XLA compiles it for tens of minutes.  Batched-op
partitioning gives the same locality with per-stage compile units.

Reference analog: this is the scale-out axis the reference lacks
(single-GPU, core/config.rs:529-531); the local math is identical to the
single-chip path (msm_kernels.cu:602-903 re-derivation in
``msm/pippenger.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..curves import points as pt
from ..curves.field_adapters import FQ_ADAPTER, FQ2_ADAPTER
from .mesh import SHARD_AXIS

tree_map = jax.tree_util.tree_map


def chunk_msm_inputs(scalars, A, n_chunks: int, *, segments: int = 1):
    """(16, N) scalars + affine batch -> leading-chunk-axis form.

    Returns scalars (D, 16, mloc); A leaves (D, K, nloc); inf (D, nloc).

    ``segments`` > 1: the base array's point axis is a concatenation of
    ``segments`` equal blocks (GLV extension contributes x2, a precompute
    factor f contributes xf — block-major order, exactly as
    ``glv_extend_bases`` + ``expand_bases`` lay them out).  Each block is
    chunked independently and a chunk holds its blocks re-concatenated in
    order, so per-chunk key generation (``msm_chunked``'s GLV split +
    factor regroup) lines up with the chunk's own points.
    """
    x, y, inf = A
    n_pts = inf.shape[-1]
    n_sc = scalars.shape[-1]
    if n_pts % (n_chunks * segments) or n_sc % n_chunks:
        raise ValueError(
            f"MSM size {n_pts} (pts) / {n_sc} (scalars) not divisible into "
            f"{n_chunks} chunks of {segments} segment(s)")
    nseg = n_pts // segments
    nloc = nseg // n_chunks

    def chunk(c):
        return jnp.moveaxis(c.reshape(c.shape[:-1] + (n_chunks, -1)), -2, 0)

    def chunk_seg(c):
        if segments == 1:
            return chunk(c)
        # (..., S*nseg) -> (..., S, D, nloc) -> (D, ..., S*nloc)
        t = c.reshape(c.shape[:-1] + (segments, n_chunks, nloc))
        t = jnp.moveaxis(t, -2, 0)
        return t.reshape((n_chunks,) + c.shape[:-1] + (segments * nloc,))

    return (
        chunk(scalars),
        (tree_map(chunk_seg, x), tree_map(chunk_seg, y), chunk_seg(inf)),
    )


def shard_msm_inputs(scalars, A, mesh, *, segments: int = 1):
    """Chunk MSM inputs by mesh size and shard the chunk axis."""
    D = mesh.devices.size
    sc, (x, y, inf) = chunk_msm_inputs(scalars, A, D, segments=segments)
    sh3 = NamedSharding(mesh, P(SHARD_AXIS, None, None))
    sh2 = NamedSharding(mesh, P(SHARD_AXIS, None))
    return (
        jax.device_put(sc, sh3),
        (
            tree_map(lambda c: jax.device_put(c, sh3), x),
            tree_map(lambda c: jax.device_put(c, sh3), y),
            jax.device_put(inf, sh2),
        ),
    )


def _combine_chunks(F, P_chunks):
    """Per-chunk Jacobian points (leaves (D, K..)) -> one point (tree-sum)."""
    batched = tree_map(lambda c: jnp.moveaxis(c, 0, -1), P_chunks)  # (K.., D)
    return pt.sum_reduce(F, batched)


def msm_sharded(F, scalars_c, A_c, mesh=None, *, window_bits: int | None = None,
                scalars_montgomery: bool = True, glv: bool = False,
                factor: int = 1):
    """MSM over chunked (optionally mesh-sharded) inputs.

    ``scalars_c``/``A_c`` come from :func:`shard_msm_inputs` (sharded) or
    :func:`chunk_msm_inputs` (single device, chunk axis as plain batch).
    Returns one Jacobian point.  ``mesh`` is accepted for API symmetry;
    placement travels with the arrays under GSPMD.

    ``glv``/``factor`` compose exactly as on the single-chip path
    (core/msm.rs:594-651's precompute-composes-with-everything analog):
    GLV splits per chunk in-device; ``factor`` > 1 expects bases expanded
    by ``expand_bases`` and chunked with
    ``chunk_msm_inputs(..., segments=factor * (2 if glv else 1))``.
    """
    from ..msm.pippenger import msm_chunked

    D = A_c[2].shape[0]
    n_dev = mesh.devices.size if mesh is not None else len(jax.devices())
    # pmap needs exactly one chunk per addressable device; otherwise run
    # the chunk axis as a plain batch (vmap) and let placement follow the
    # input shardings.
    mapper = "pmap" if D == n_dev == len(jax.local_devices()) else "vmap"
    P_chunks = msm_chunked(
        F, scalars_c, A_c,
        window_bits=window_bits, scalars_montgomery=scalars_montgomery,
        mapper=mapper, glv=glv, factor=factor,
    )
    return _combine_chunks(F, P_chunks)


def msm_g1_sharded(scalars_c, A_c, mesh=None, **kw):
    return msm_sharded(FQ_ADAPTER, scalars_c, A_c, mesh, **kw)


def msm_g2_sharded(scalars_c, A_c, mesh=None, **kw):
    return msm_sharded(FQ2_ADAPTER, scalars_c, A_c, mesh, **kw)
