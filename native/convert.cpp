// Host-side bulk conversion library for bls12_381_jax.
//
// The analog of the reference's host conversion hot path
// (core/types.rs TypeConverter): wire-format field elements (little-endian
// 64-bit limbs, 4 for Fr / 6 for Fq) are repacked into the library's
// limbs-first 16-bit-limb uint32 arrays, and Montgomery encode/decode is
// done with 64-bit CIOS arithmetic so multi-million-element SRS uploads
// take milliseconds instead of Python-loop minutes.
//
// Own implementation (standard CIOS Montgomery multiplication with
// unsigned __int128 products); constants are the public BLS12-381 curve
// parameters.  Exposed as a plain C ABI consumed via ctypes.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>

#include "field64.h"

namespace {

using namespace bls381;

template <int K>
static void mont_scale_batch(const uint64_t* in, uint64_t* out, size_t n,
                             const uint64_t* factor, const uint64_t* p,
                             uint64_t inv) {
  for (size_t i = 0; i < n; ++i)
    mont_mul<K>(in + i * K, factor, p, inv, out + i * K);
}

}  // namespace

extern "C" {

// ---- wire (element-major u64 LE words) <-> limbs-first 16-bit limbs ------
// in:  n elements of k64 64-bit words each (n * k64 * 8 bytes)
// out: (4*k64, n) uint32 array, limb-major (out[l*n + i])
void wire_to_limbs16(const uint64_t* in, uint32_t* out, size_t n, int k64) {
  const int k16 = 4 * k64;
  for (size_t i = 0; i < n; ++i) {
    const uint64_t* e = in + i * k64;
    for (int w = 0; w < k64; ++w) {
      uint64_t v = e[w];
      out[(size_t)(4 * w + 0) * n + i] = (uint32_t)(v & 0xFFFF);
      out[(size_t)(4 * w + 1) * n + i] = (uint32_t)((v >> 16) & 0xFFFF);
      out[(size_t)(4 * w + 2) * n + i] = (uint32_t)((v >> 32) & 0xFFFF);
      out[(size_t)(4 * w + 3) * n + i] = (uint32_t)((v >> 48) & 0xFFFF);
    }
    (void)k16;
  }
}

void limbs16_to_wire(const uint32_t* in, uint64_t* out, size_t n, int k64) {
  for (size_t i = 0; i < n; ++i) {
    uint64_t* e = out + i * k64;
    for (int w = 0; w < k64; ++w) {
      e[w] = (uint64_t)(in[(size_t)(4 * w + 0) * n + i] & 0xFFFF) |
             ((uint64_t)(in[(size_t)(4 * w + 1) * n + i] & 0xFFFF) << 16) |
             ((uint64_t)(in[(size_t)(4 * w + 2) * n + i] & 0xFFFF) << 32) |
             ((uint64_t)(in[(size_t)(4 * w + 3) * n + i] & 0xFFFF) << 48);
    }
  }
}

// ---- batch Montgomery encode/decode on wire-format words ------------------
// field: 0 = Fq (6 words), 1 = Fr (4 words).  in/out: n * k64 words.
void mont_encode_batch(const uint64_t* in, uint64_t* out, size_t n, int field) {
  if (field == 0)
    mont_scale_batch<6>(in, out, n, FQ_R2, FQ_P, FQ_INV);
  else
    mont_scale_batch<4>(in, out, n, FR_R2, FR_P, FR_INV);
}

void mont_decode_batch(const uint64_t* in, uint64_t* out, size_t n, int field) {
  static const uint64_t ONE6[6] = {1, 0, 0, 0, 0, 0};
  static const uint64_t ONE4[4] = {1, 0, 0, 0};
  if (field == 0)
    mont_scale_batch<6>(in, out, n, ONE6, FQ_P, FQ_INV);
  else
    mont_scale_batch<4>(in, out, n, ONE4, FR_P, FR_INV);
}

int native_abi_version(void) { return 1; }

}  // extern "C"
