"""MSM context: device-resident cached bases, precompute, batch, async.

Analog of ``GpuMsmContext`` (core/msm.rs:133-136) and
``PrecomputedBases`` (core/msm.rs:174-262): bases are uploaded once
(optionally expanded by a precompute factor and/or sharded over a mesh)
and reused across many MSMs — the PLONK prover's SRS hot path
(msm_with_device_bases, core/msm.rs:594).  Async variants return
:class:`AsyncHandle`s (core/msm.rs:715, :1439-1640 analogs); batch
variants run many scalar sets against shared bases
(core/msm.rs:1179-1295 analog), dispatched back-to-back so JAX's async
dispatch pipelines them like the reference's dedicated CUDA stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ..curves import points as pt
from ..curves.field_adapters import FQ_ADAPTER, FQ2_ADAPTER
from ..msm import pippenger
from .config import config
from .handles import AsyncHandle
from .tracing import span

tree_map = jax.tree_util.tree_map


@dataclass
class PrecomputedBases:
    """Device-resident (possibly expanded) affine bases + their metadata.

    Mirrors the reference's invariant that precompute metadata must travel
    with the buffer (window size and factor are baked into the expansion;
    using different ones at MSM time would silently corrupt results —
    cf. core/msm.rs:641-643's Montgomery-form bookkeeping).
    """

    A: Any  # affine batch (x, y, inf), factor*n points (2x when glv)
    n: int
    factor: int
    window_bits: int
    glv: bool = False

    @property
    def is_precomputed(self) -> bool:
        return self.factor > 1


class MsmContext:
    """MSM orchestration for one curve (G1 or G2)."""

    def __init__(self, adapter, name: str = "g1"):
        self.F = adapter
        self.name = name

    # --- base management (upload_g1_bases / precompute_bases analogs) -----

    def upload_bases(self, A, *, precompute_factor: int | None = None,
                     window_bits: int | None = None,
                     glv: bool | None = None) -> PrecomputedBases:
        """Place bases on device, optionally expanded by a precompute factor.

        ``glv`` (G1 only; default from MIDNIGHT_MSM_GLV) stores
        [A || phi(A)] and expands for 128-bit scalar halves — every MSM
        against these bases then runs the GLV-split pipeline.
        """
        n = A[2].shape[-1]
        factor = (config().precompute_factor
                  if precompute_factor is None else precompute_factor)
        if glv is None:
            mode = config().msm_glv
            if mode == "auto":
                # same fit rule as pippenger.msm: GLV only while the
                # doubled (and factor-expanded) set runs in one shot in
                # the budget left after the caller's live buffers (the
                # bases being uploaded are excluded — their footprint is
                # part of the pipeline working set)
                glv = (2 * n * max(factor, 1)
                       * pippenger._msm_bytes_per_point(self.F)
                       <= pippenger._available_budget(A))
            else:
                glv = mode == "on"
        glv = bool(glv) and self.name == "g1"
        num_bits = 128 if glv else pippenger.FR_BITS
        w = window_bits or config().msm_window or pippenger.window_bits_for(
            n * max(factor, 1) * (2 if glv else 1), self.F)
        with span("msm", f"{self.name}.precompute_bases[f={factor}]"):
            A_dev = tree_map(jnp.asarray, A)
            if glv:
                A_dev = pippenger.glv_extend_bases(self.F, A_dev)
            A_exp = pippenger.expand_bases(self.F, A_dev, w, factor, num_bits)
            jax.block_until_ready(A_exp)
        return PrecomputedBases(A=A_exp, n=n, factor=factor, window_bits=w,
                                glv=glv)

    # --- sync MSM ----------------------------------------------------------

    def msm(self, scalars, A, *, window_bits: int | None = None,
            scalars_montgomery: bool = True):
        """One MSM against ad-hoc bases; returns a Jacobian point (blocking)."""
        with span("msm", f"{self.name}.msm[n={A[2].shape[-1]}]"):
            out = pippenger.msm(
                self.F, scalars, A,
                window_bits=window_bits or config().msm_window,
                scalars_montgomery=scalars_montgomery,
            )
            jax.block_until_ready(out)
        return out

    def msm_with_bases(self, scalars, bases: PrecomputedBases, *,
                       scalars_montgomery: bool = True):
        """MSM against cached (possibly precomputed) bases (blocking)."""
        handle = self.msm_with_bases_async(
            scalars, bases, scalars_montgomery=scalars_montgomery)
        return handle.wait()

    # --- async MSM (msm_async / MsmHandle analogs) ---------------------------

    def msm_async(self, scalars, A, *, window_bits: int | None = None,
                  scalars_montgomery: bool = True) -> AsyncHandle:
        out = pippenger.msm(
            self.F, scalars, A,
            window_bits=window_bits or config().msm_window,
            scalars_montgomery=scalars_montgomery,
        )
        return AsyncHandle(out)

    def msm_with_bases_async(self, scalars, bases: PrecomputedBases, *,
                             scalars_montgomery: bool = True) -> AsyncHandle:
        out = pippenger.msm_precomputed(
            self.F, scalars, bases.A,
            window_bits=bases.window_bits, factor=bases.factor,
            scalars_montgomery=scalars_montgomery, glv=bases.glv,
        )
        return AsyncHandle(out)

    # --- batch MSM (shared bases, core/msm.rs:1179-1295 analog) -------------

    def msm_batch(self, scalars_list: Sequence, bases: PrecomputedBases, *,
                  scalars_montgomery: bool = True):
        return self.msm_batch_async(
            scalars_list, bases, scalars_montgomery=scalars_montgomery).wait()

    def msm_batch_async(self, scalars_list: Sequence,
                        bases: PrecomputedBases, *,
                        scalars_montgomery: bool = True) -> AsyncHandle:
        """Many MSMs sharing one base set; one handle for all results.

        One batched pipeline (pippenger.msm_batch_shared): the batch axis
        is folded into the tile lanes so every per-window stage — sort,
        shared-table gather, scan — runs once for all B scalar sets, the
        equivalent of the reference's single batched kernel launch
        with are_points_shared_in_batch (core/msm.rs:1179-1407).
        """
        for s in scalars_list:
            if s.shape[-1] != bases.n:
                raise ValueError(
                    f"batch MSM scalar count {s.shape[-1]} != base count {bases.n}")
        if len(scalars_list) == 1:
            out = pippenger.msm_precomputed(
                self.F, scalars_list[0], bases.A,
                window_bits=bases.window_bits, factor=bases.factor,
                scalars_montgomery=scalars_montgomery, glv=bases.glv,
            )
            return AsyncHandle([out])
        sc_b = jnp.stack(list(scalars_list), axis=1)  # (16, B, N)
        P = pippenger.msm_batch_shared(
            self.F, sc_b, bases.A,
            window_bits=bases.window_bits, factor=bases.factor,
            scalars_montgomery=scalars_montgomery, glv=bases.glv,
        )
        B = len(scalars_list)
        outs = [
            jax.tree_util.tree_map(lambda c, i=i: c[..., i], P)
            for i in range(B)
        ]
        return AsyncHandle(outs)

    # --- misc ---------------------------------------------------------------

    def warmup(self, n: int = 256, *, factor: int = 1,
               window_bits: int | None = None) -> None:
        """Compile-warm the MSM stages (core/msm.rs:931 analog).

        Every stage jit is shape-specialized, so pass the *production*
        ``n`` (and precompute ``factor``) to pre-pay the compile the real
        workload would hit — e.g. ``warmup(1 << 20, factor=2)``.  The
        default tiny ``n`` only proves the pipeline works.
        """
        from ..curves import g1 as g1mod

        if self.name == "g1":
            A = g1mod.generator_affine((n,))
        else:
            from ..curves import g2 as g2mod

            A = g2mod.generator_affine((n,))
        scalars = jnp.zeros((16, n), dtype=jnp.uint32).at[0].set(1)
        if factor > 1:
            bases = self.upload_bases(A, precompute_factor=factor,
                                      window_bits=window_bits)
            out = self.msm_with_bases(scalars, bases)
        else:
            out = pippenger.msm(self.F, scalars, A, window_bits=window_bits,
                                scalars_montgomery=True)
        jax.block_until_ready(out)

    def to_affine(self, P):
        return pt.jac_to_affine(self.F, P)


def g1_context() -> MsmContext:
    return MsmContext(FQ_ADAPTER, "g1")


def g2_context() -> MsmContext:
    return MsmContext(FQ2_ADAPTER, "g2")
