"""Field-ops adapters: a single interface over Fq and Fq2 = Fq[u]/(u^2+1).

The Jacobian group law in ``points.py`` is written once against this
interface and instantiated for G1 (base field Fq) and G2 (quadratic
extension Fq2) — the analog of the reference's templated
``Projective<F, S, Tag>`` (point.cuh:455-525) with Fq2 operator overloads
(point.cuh:81-277).

Fq elements: uint32 arrays ``(K, *batch)``; Fq2 elements: ``(c0, c1)``
tuples of Fq elements.  Fq2 multiplication is Karatsuba (3 base muls, as
in point.cuh:137-160); squaring uses the (a0+a1)(a0-a1) / 2*a0*a1 identity.
Adapters are stateless singletons so they can be static jit arguments.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fields import FQ, ops


class FqAdapter:
    """Base-field ops over a FieldSpec (Montgomery domain).

    Multiplies use the scan-based CIOS (ops.mont_mul default).
    """

    # Cost facts consumed by the MSM tuner (msm/pippenger.py): one Fq mul
    # per mul, one limb plane per coordinate.
    fq_muls_per_mul = 1
    limb_planes = 1

    def __init__(self, spec):
        self.spec = spec
        self.limb_shape = (spec.num_limbs,)

    # -- arithmetic ----------------------------------------------------------
    def add(self, a, b):
        return ops.add(self.spec, a, b)

    def sub(self, a, b):
        return ops.sub(self.spec, a, b)

    def mul(self, a, b):
        return ops.mont_mul(self.spec, a, b)

    def sqr(self, a):
        return ops.mont_sqr(self.spec, a)

    def neg(self, a):
        return ops.neg(self.spec, a)

    def double(self, a):
        return ops.add(self.spec, a, a)

    def inv(self, a):
        """Inverse; wide batches via Montgomery's trick (ONE real inversion).

        The Fermat ladder (`ops.inv_mont`) is a 381-iteration
        square-and-multiply — correct at any width, but n full-width
        ladders for base expansion's proj_to_affine at 2^20 lanes is
        wasted work.  Montgomery's trick replaces n inversions with prefix
        products + one (24, 1) inversion — strictly less work and only
        narrow-width programs (vec_ops.cu:155-333 analog,
        vecops.batch_inverse).  Small batches (including traced scalars
        inside jitted formulas) keep the constant-time ladder."""
        batch = a.shape[1:]
        n = 1
        for d in batch:
            n *= int(d)
        if n >= 4096 and not isinstance(a, jax.core.Tracer):
            from .. import vecops

            flat = a.reshape(self.spec.num_limbs, -1)
            return vecops.batch_inverse(self.spec, flat).reshape(a.shape)
        return ops.inv_mont(self.spec, a)

    # -- predicates / selection ---------------------------------------------
    def is_zero(self, a):
        return ops.is_zero(self.spec, a)

    def eq(self, a, b):
        return ops.eq(self.spec, a, b)

    def cmov(self, mask, a, b):
        return jnp.where(mask[None], a, b)

    # -- constants ------------------------------------------------------------
    def zero(self, batch_shape=()):
        return ops.zeros(self.spec, batch_shape)

    def one(self, batch_shape=()):
        return ops.one_mont(self.spec, batch_shape)

    def batch_shape(self, a):
        return a.shape[1:]

    def stack_for_scan(self, elems):  # pragma: no cover - helper
        return jnp.stack(elems)


class Fq2Adapter:
    """Quadratic extension ops; elements are (c0, c1) tuples of Fq arrays."""

    # Karatsuba mul = 3 Fq muls; every coordinate is two limb planes.
    fq_muls_per_mul = 3
    limb_planes = 2

    def __init__(self, base: FqAdapter):
        self.base = base
        self.spec = base.spec

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def mul(self, a, b):
        # Karatsuba: v0 = a0 b0, v1 = a1 b1
        # real = v0 - v1; imag = (a0+a1)(b0+b1) - v0 - v1
        F = self.base
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        s = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        return (F.sub(v0, v1), F.sub(F.sub(s, v0), v1))

    def sqr(self, a):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        F = self.base
        t = F.mul(F.add(a[0], a[1]), F.sub(a[0], a[1]))
        m = F.mul(a[0], a[1])
        return (t, F.add(m, m))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def double(self, a):
        return (self.base.double(a[0]), self.base.double(a[1]))

    def inv(self, a):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        F = self.base
        norm = F.add(F.sqr(a[0]), F.sqr(a[1]))
        ninv = F.inv(norm)
        return (F.mul(a[0], ninv), F.neg(F.mul(a[1], ninv)))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) & self.base.eq(a[1], b[1])

    def cmov(self, mask, a, b):
        return (self.base.cmov(mask, a[0], b[0]), self.base.cmov(mask, a[1], b[1]))

    def zero(self, batch_shape=()):
        return (self.base.zero(batch_shape), self.base.zero(batch_shape))

    def one(self, batch_shape=()):
        return (self.base.one(batch_shape), self.base.zero(batch_shape))

    def batch_shape(self, a):
        return a[0].shape[1:]


FQ_ADAPTER = FqAdapter(FQ)
FQ2_ADAPTER = Fq2Adapter(FQ_ADAPTER)
