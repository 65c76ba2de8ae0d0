// 64-bit-limb BLS12-381 field arithmetic shared by the native host library.
//
// Own implementation (standard CIOS Montgomery multiplication with
// unsigned __int128 products); constants are the public BLS12-381 curve
// parameters (same values the reference pins in
// bls12-381/include/bls12_381_constants.h — they are curve facts).
// This plays the role BLST's field layer plays for the reference's CPU
// fallback (core/traits/cpu_impl.rs): a fast host-side implementation,
// independent of the device limb engine.

#pragma once

#include <cstdint>
#include <cstring>

namespace bls381 {

using u128 = unsigned __int128;

// --- BLS12-381 Montgomery constants (64-bit limbs, little-endian) ---------
static const uint64_t FQ_P[6] = {0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
                                 0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                                 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const uint64_t FQ_R2[6] = {0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
                                  0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
                                  0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
static const uint64_t FQ_INV = 0x89f3fffcfffcfffdULL;

static const uint64_t FR_P[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                                 0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};
static const uint64_t FR_R2[4] = {0xc999e990f3f29c6dULL, 0x2b6cedcb87925c23ULL,
                                  0x05d314967254398fULL, 0x0748d9d99f59ff11ULL};
static const uint64_t FR_INV = 0xfffffffeffffffffULL;

// CIOS Montgomery product out = a*b*R^{-1} mod p for K 64-bit limbs.
template <int K>
static inline void mont_mul(const uint64_t* a, const uint64_t* b,
                            const uint64_t* p, uint64_t inv, uint64_t* out) {
  uint64_t t[K + 2] = {0};
  for (int i = 0; i < K; ++i) {
    // t += a[i] * b
    uint64_t carry = 0;
    for (int j = 0; j < K; ++j) {
      u128 cur = (u128)a[i] * b[j] + t[j] + carry;
      t[j] = (uint64_t)cur;
      carry = (uint64_t)(cur >> 64);
    }
    u128 cur = (u128)t[K] + carry;
    t[K] = (uint64_t)cur;
    t[K + 1] = (uint64_t)(cur >> 64);
    // reduce one limb: m = t[0]*inv mod 2^64; t = (t + m*p) / 2^64
    uint64_t m = t[0] * inv;
    u128 acc = (u128)m * p[0] + t[0];
    carry = (uint64_t)(acc >> 64);
    for (int j = 1; j < K; ++j) {
      acc = (u128)m * p[j] + t[j] + carry;
      t[j - 1] = (uint64_t)acc;
      carry = (uint64_t)(acc >> 64);
    }
    acc = (u128)t[K] + carry;
    t[K - 1] = (uint64_t)acc;
    t[K] = t[K + 1] + (uint64_t)(acc >> 64);
    t[K + 1] = 0;
  }
  // conditional subtract p (t may be in [0, 2p))
  uint64_t d[K];
  uint64_t borrow = 0;
  for (int j = 0; j < K; ++j) {
    u128 cur = (u128)t[j] - p[j] - borrow;
    d[j] = (uint64_t)cur;
    borrow = (uint64_t)(cur >> 64) & 1;
  }
  bool take_d = t[K] != 0 || !borrow;
  for (int j = 0; j < K; ++j) out[j] = take_d ? d[j] : t[j];
}

template <int K>
static inline void add_mod(const uint64_t* a, const uint64_t* b,
                           const uint64_t* p, uint64_t* out) {
  uint64_t t[K];
  uint64_t carry = 0;
  for (int j = 0; j < K; ++j) {
    u128 cur = (u128)a[j] + b[j] + carry;
    t[j] = (uint64_t)cur;
    carry = (uint64_t)(cur >> 64);
  }
  uint64_t d[K];
  uint64_t borrow = 0;
  for (int j = 0; j < K; ++j) {
    u128 cur = (u128)t[j] - p[j] - borrow;
    d[j] = (uint64_t)cur;
    borrow = (uint64_t)(cur >> 64) & 1;
  }
  bool take_d = carry != 0 || !borrow;
  for (int j = 0; j < K; ++j) out[j] = take_d ? d[j] : t[j];
}

template <int K>
static inline void sub_mod(const uint64_t* a, const uint64_t* b,
                           const uint64_t* p, uint64_t* out) {
  uint64_t t[K];
  uint64_t borrow = 0;
  for (int j = 0; j < K; ++j) {
    u128 cur = (u128)a[j] - b[j] - borrow;
    t[j] = (uint64_t)cur;
    borrow = (uint64_t)(cur >> 64) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
    for (int j = 0; j < K; ++j) {
      u128 cur = (u128)t[j] + p[j] + carry;
      t[j] = (uint64_t)cur;
      carry = (uint64_t)(cur >> 64);
    }
  }
  for (int j = 0; j < K; ++j) out[j] = t[j];
}

template <int K>
static inline bool is_zero(const uint64_t* a) {
  uint64_t acc = 0;
  for (int j = 0; j < K; ++j) acc |= a[j];
  return acc == 0;
}

template <int K>
static inline bool eq(const uint64_t* a, const uint64_t* b) {
  uint64_t acc = 0;
  for (int j = 0; j < K; ++j) acc |= a[j] ^ b[j];
  return acc == 0;
}

}  // namespace bls381
