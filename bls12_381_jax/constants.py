"""BLS12-381 curve constants (single source of truth).

All values are public curve facts, verified computationally in
``tests/test_constants.py`` (primality, 2-adicity, generator membership,
on-curve and subgroup checks).  They correspond to the reference's
``bls12-381/include/bls12_381_constants.h`` (values only — that file is the
reference's single source of truth for the same facts, validated there
against BLST / Arkworks / EIP-2537).

Conventions used throughout this library:

* ``FQ_MODULUS`` (q): 381-bit base-field prime.
* ``FR_MODULUS`` (r): 255-bit scalar-field prime, 2-adicity 32.
* Montgomery R for the 16-bit limb layout: ``2**256`` for Fr (16 x 16-bit
  limbs) and ``2**384`` for Fq (24 x 16-bit limbs) — identical to the
  reference's 4x64 / 6x64 limb R values, so Montgomery-form byte images are
  interchangeable.
* ``FR_OMEGA``: primitive 2^32-th root of unity, **standard form**
  (= 7^((r-1)/2^32) mod r).  The reference stores the Montgomery image of
  the same value (``bls12_381_constants.h:127-130``); per-size roots are
  derived by repeated squaring exactly as in the reference
  (``core/ntt.rs:1488-1494``).
"""

# --- Base field Fq -----------------------------------------------------------
FQ_MODULUS = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
FQ_BITS = 381

# --- Scalar field Fr ---------------------------------------------------------
FR_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FR_BITS = 255

# Fr multiplicative structure
FR_TWO_ADICITY = 32
FR_MULTIPLICATIVE_GENERATOR = 7
# 7^((r-1)/2^32) mod r — primitive 2^32-th root of unity (standard form)
FR_OMEGA = 0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B

# --- Curve equations ---------------------------------------------------------
# G1: y^2 = x^3 + 4 over Fq
G1_B = 4
# G2: y^2 = x^3 + 4(1+u) over Fq2 = Fq[u]/(u^2+1)
G2_B = (4, 4)

# --- Generators (standard form) ----------------------------------------------
G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_GENERATOR_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GENERATOR_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# --- NTT limits (parity with reference ntt.cuh:60, bls12_381_params.cuh:135) --
MAX_NTT_LOG_SIZE = 32

# --- MSM limits (parity with reference msm.cuh:70-74) -------------------------
MAX_MSM_LOG_SIZE = 24
