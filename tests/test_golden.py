"""Golden-vector (KAT) suite: limb-exact parity against checked-in vectors.

The vectors in ``tests/vectors/`` were produced by ``tools/gen_vectors.py``
— an implementation independent of both the device path and the Python
oracle (affine chord-tangent group law, recursive FFT, plain ints).  This
is the analog of the reference's captured-vector policy
(security_audit_tests.cuh:30-46: BLST/Arkworks/EIP-2537/Zcash vectors;
tests/ntt_fft_comparison.rs:134-173: pinned omega derivation).  Any drift
in serialization, Montgomery parameters, root-of-unity derivation, or
group-law math fails here even if library and oracle agree with each other.
"""

import hashlib
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bls12_381_jax import constants
from bls12_381_jax.fields import FQ, FR, ops
from bls12_381_jax.fields.limbs import ints_to_limbs, limbs_to_ints
from bls12_381_jax.curves import g1, g2
from bls12_381_jax.msm import msm_g1, msm_g2
from bls12_381_jax.ntt import ntt, coset_ntt

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def load(name):
    with open(os.path.join(VEC_DIR, name)) as f:
        return json.load(f)


def _i(s):
    return int(s, 16)


SPECS = {"fr": FR, "fq": FQ}


class TestFieldGolden:
    @pytest.mark.parametrize("name", ["fr", "fq"])
    def test_montgomery_constants(self, name):
        v = load("field_vectors.json")["fields"][name]
        spec = SPECS[name]
        p = _i(v["modulus"])
        assert spec.modulus == p
        assert spec.num_limbs == v["num_limbs"]
        assert spec.r % p == _i(v["mont_r"])
        assert spec.r2 % p == _i(v["mont_r2"])
        assert spec.n0_inv == _i(v["n0_16"])

    @pytest.mark.parametrize("name", ["fr", "fq"])
    def test_wire_format(self, name):
        """Limb images are the pinned little-endian 16-bit layout."""
        v = load("field_vectors.json")["fields"][name]
        spec = SPECS[name]
        for w in v["wire"]:
            got = ints_to_limbs([_i(w["value"])], spec.num_limbs)[:, 0]
            assert got.tolist() == w["limbs_le16"]
            gotm = ints_to_limbs([spec.to_mont(_i(w["value"]))],
                                 spec.num_limbs)[:, 0]
            assert gotm.tolist() == w["mont_limbs_le16"]

    @pytest.mark.parametrize("name", ["fr", "fq"])
    def test_arithmetic_kats(self, name):
        v = load("field_vectors.json")["fields"][name]
        spec = SPECS[name]
        ks = v["kats"]
        a_std = ints_to_limbs([_i(k["a"]) for k in ks], spec.num_limbs)
        b_std = ints_to_limbs([_i(k["b"]) for k in ks], spec.num_limbs)
        a_m = ints_to_limbs([spec.to_mont(_i(k["a"])) for k in ks],
                            spec.num_limbs)
        b_m = ints_to_limbs([spec.to_mont(_i(k["b"])) for k in ks],
                            spec.num_limbs)
        assert limbs_to_ints(np.asarray(ops.add(spec, a_std, b_std))) == \
            [_i(k["add"]) for k in ks]
        assert limbs_to_ints(np.asarray(ops.sub(spec, a_std, b_std))) == \
            [_i(k["sub"]) for k in ks]
        assert limbs_to_ints(np.asarray(ops.neg(spec, a_std))) == \
            [_i(k["neg"]) for k in ks]
        mul = ops.from_mont(spec, ops.mont_mul(spec, a_m, b_m))
        assert limbs_to_ints(np.asarray(mul)) == [_i(k["mul"]) for k in ks]
        sqr = ops.from_mont(spec, ops.mont_sqr(spec, a_m))
        assert limbs_to_ints(np.asarray(sqr)) == [_i(k["sqr"]) for k in ks]
        inv = ops.from_mont(spec, ops.inv_mont(spec, a_m))
        assert limbs_to_ints(np.asarray(inv)) == [_i(k["inv"]) for k in ks]
        # Montgomery image itself (pins R and the encode path)
        assert limbs_to_ints(np.asarray(a_m)) == [_i(k["a_mont"]) for k in ks]


def _fr_mont_limbs(ints):
    return jnp.asarray(
        ints_to_limbs([FR.to_mont(x % constants.FR_MODULUS) for x in ints],
                      FR.num_limbs))


class TestNttGolden:
    def _cases(self, kind):
        return [c for c in load("ntt_vectors.json")["cases"]
                if c["kind"] == kind]

    def test_omega_derivation(self):
        v = load("ntt_vectors.json")
        assert constants.FR_OMEGA == _i(v["omega_2e32"])

    @pytest.mark.parametrize("idx", [0, 1])
    def test_forward(self, idx):
        c = self._cases("forward")[idx]
        x = _fr_mont_limbs([_i(s) for s in c["input"]])
        y = ops.from_mont(FR, ntt(x))
        assert limbs_to_ints(np.asarray(y)) == [_i(s) for s in c["output"]]

    def test_coset(self):
        c = self._cases("coset")[0]
        x = _fr_mont_limbs([_i(s) for s in c["input"]])
        y = ops.from_mont(FR, coset_ntt(x, c["shift"]))
        assert limbs_to_ints(np.asarray(y)) == [_i(s) for s in c["output"]]

    def test_forward_digest_2e14(self):
        c = self._cases("forward_digest")[0]
        n = 1 << c["log_n"]
        r = constants.FR_MODULUS
        x = _fr_mont_limbs([(i * i + 3) % r for i in range(n)])
        y = ops.from_mont(FR, ntt(x))
        hsh = hashlib.sha256()
        for v in limbs_to_ints(np.asarray(y)):
            hsh.update(v.to_bytes(32, "little"))
        assert hsh.hexdigest() == c["output_sha256_le32"]


class TestMsmGolden:
    def _check_g1(self, c):
        scalars = _fr_mont_limbs([_i(s) for s in c["scalars"]])
        pts = [(_i(p["x"]), _i(p["y"])) for p in c["points"]]
        A = g1.affine_from_ints(pts)
        got = g1.jacobian_to_ints(
            jax.tree_util.tree_map(
                lambda v: v[..., None], msm_g1(scalars, A)))[0]
        assert got == (_i(c["expected"]["x"]), _i(c["expected"]["y"]))

    def test_g1_1024(self):
        self._check_g1(load("msm_g1_vectors.json")["cases"][0])

    def test_g1_4096(self):
        self._check_g1(load("msm_g1_vectors.json")["cases"][1])

    def test_g2_1024(self):
        c = load("msm_g2_vectors.json")["cases"][0]
        scalars = _fr_mont_limbs([_i(s) for s in c["scalars"]])
        pts = [((_i(p["x"][0]), _i(p["x"][1])),
                (_i(p["y"][0]), _i(p["y"][1]))) for p in c["points"]]
        A = g2.affine_from_ints(pts)
        got = g2.jacobian_to_ints(
            jax.tree_util.tree_map(lambda v: v[..., None],
                                   msm_g2(scalars, A)))[0]
        exp = c["expected"]
        assert got == ((_i(exp["x"][0]), _i(exp["x"][1])),
                       (_i(exp["y"][0]), _i(exp["y"][1])))


# ---------------------------------------------------------------------------
# External (published) known-answer vectors — verbatim values from public
# sources, NOT generated by this repo's tooling, closing the shared-bug
# channel the self-generated corpus leaves open (the reference pins
# BLST/Arkworks/EIP-2537/Zcash vectors the same way,
# security_audit_tests.cuh:30-46).
#
# Sources:
#  * EIP-2537 precompile test vectors (go-ethereum core/vm/testdata and
#    ethereum/execution-spec-tests): the 2*G1, 3*G1 and 2*G2 affine
#    coordinates below appear verbatim in the bls_g1add / bls_g1mul /
#    bls_g2add cases.
#  * Zcash BLS12-381 spec / IETF pairing-friendly-curves draft: the G1/G2
#    generator coordinates and the Fr parameters (also mirrored in
#    bls12_381_constants.h:37-41 of the reference).
#  * Arkworks/Zcash Fr: the 2-adic root of unity 7^((r-1)/2^32) mod r.
# ---------------------------------------------------------------------------

EIP2537_G1_2G = (
    0x0572CBEA904D67468808C8EB50A9450C9721DB309128012543902D0AC358A62AE28F75BB8F1C7C42C39A8C5529BF0F4E,
    0x166A9D8CABC673A322FDA673779D8E3822BA3ECB8670E461F73BB9021D5FD76A4C56D9D4CD16BD1BBA86881979749D28,
)
EIP2537_G1_3G = (
    0x09ECE308F9D1F0131765212DECA99697B112D61F9BE9A5F1F3780A51335B3FF981747A0B2CA2179B96D2C0C9024E5224,
    0x032B80D3A6F5B09F8A84623389C5F80CA69A0CDDABC3097F9D9C27310FD43BE6E745256C634AF45CA3473B0590AE30D1,
)
EIP2537_G2_2G = (
    (0x1638533957D540A9D2370F17CC7ED5863BC0B995B8825E0EE1EA1E1E4D00DBAE81F14B0BF3611B78C952AACAB827A053,
     0x0A4EDEF9C1ED7F729F520E47730A124FD70662A904BA1074728114D1031E1572C6C886F6B57EC72A6178288C47C33577),
    (0x0468FB440D82B0630AEB8DCA2B5256789A66DA69BF91009CBFE6BD221E47AA8AE88DECE9764BF3BD999D95D71E4C9899,
     0x0F6D4552FA65DD2638B361543F887136A43253D9C66C411697003F7A13C308F5422E1AA0A59C8967ACDEFD8B6E36CCF3),
)
ZCASH_FR_2ADIC_ROOT = (
    0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B
)


class TestExternalVectors:
    """Device ops against verbatim published values (no in-repo generator
    involved on the expected side)."""

    def _g1_one(self, P):
        return g1.jacobian_to_ints(
            jax.tree_util.tree_map(lambda v: v[..., None], P))[0]

    def test_g1_double_generator(self):
        from bls12_381_jax.curves import points as pt
        from bls12_381_jax.curves.field_adapters import FQ_ADAPTER

        G = g1.generator_affine((1,))
        got = g1.jacobian_to_ints(
            pt.jac_double(FQ_ADAPTER, pt.affine_to_jac(FQ_ADAPTER, G)))[0]
        assert got == EIP2537_G1_2G

    def test_g1_add_g_2g_is_3g(self):
        from bls12_381_jax.curves import points as pt
        from bls12_381_jax.curves.field_adapters import FQ_ADAPTER

        G = pt.affine_to_jac(FQ_ADAPTER, g1.generator_affine((1,)))
        twoG = pt.affine_to_jac(
            FQ_ADAPTER, g1.affine_from_ints([EIP2537_G1_2G]))
        got = g1.jacobian_to_ints(pt.jac_add(FQ_ADAPTER, G, twoG))[0]
        assert got == EIP2537_G1_3G

    def test_g1_msm_ones_g_2g_is_3g(self):
        A = g1.affine_from_ints([
            (constants.G1_GENERATOR_X, constants.G1_GENERATOR_Y),
            EIP2537_G1_2G,
        ])
        scalars = _fr_mont_limbs([1, 1])
        assert self._g1_one(msm_g1(scalars, A)) == EIP2537_G1_3G

    def test_g1_scalar_mul_3(self):
        A = g1.affine_from_ints(
            [(constants.G1_GENERATOR_X, constants.G1_GENERATOR_Y)])
        assert self._g1_one(msm_g1(_fr_mont_limbs([3]), A)) == EIP2537_G1_3G

    def test_g2_double_generator(self):
        from bls12_381_jax.curves import points as pt
        from bls12_381_jax.curves.field_adapters import FQ2_ADAPTER

        G = g2.generator_affine((1,))
        got = g2.jacobian_to_ints(
            pt.jac_double(FQ2_ADAPTER, pt.affine_to_jac(FQ2_ADAPTER, G)))[0]
        assert got == EIP2537_G2_2G

    def test_g2_scalar_mul_2(self):
        G = g2.generator_affine((1,))
        got = g2.jacobian_to_ints(
            jax.tree_util.tree_map(lambda v: v[..., None],
                                   msm_g2(_fr_mont_limbs([2]), G)))[0]
        assert got == EIP2537_G2_2G

    def test_fr_two_adic_root(self):
        """The library's NTT omega chain starts at the published Zcash /
        Arkworks 2-adic root (also the reference's FR_OMEGA,
        bls12_381_params.cuh:136-142)."""
        r = constants.FR_MODULUS
        assert constants.FR_OMEGA == ZCASH_FR_2ADIC_ROOT
        assert pow(ZCASH_FR_2ADIC_ROOT, 1 << 32, r) == 1
        assert pow(ZCASH_FR_2ADIC_ROOT, 1 << 31, r) != 1
        assert pow(7, (r - 1) >> 32, r) == ZCASH_FR_2ADIC_ROOT

    def test_published_points_on_curve(self):
        """Published points satisfy y^2 = x^3 + 4 (and the Fq2 b' = 4(1+u))
        — catches coordinate-order / serialization drift."""
        p = constants.FQ_MODULUS
        for (x, y) in (EIP2537_G1_2G, EIP2537_G1_3G):
            assert (y * y - x * x * x - 4) % p == 0
        (x0, x1), (y0, y1) = EIP2537_G2_2G
        # Fq2 arithmetic over u^2 = -1
        def sq(a0, a1):
            return ((a0 * a0 - a1 * a1) % p, (2 * a0 * a1) % p)
        def mul(a, b):
            return ((a[0] * b[0] - a[1] * b[1]) % p,
                    (a[0] * b[1] + a[1] * b[0]) % p)
        lhs = sq(y0, y1)
        x2 = sq(x0, x1)
        x3 = mul(x2, (x0, x1))
        rhs = ((x3[0] + 4) % p, (x3[1] + 4) % p)
        assert lhs == rhs
