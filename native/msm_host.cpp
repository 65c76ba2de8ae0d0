// Native host-side Pippenger MSM for G1 (Fq) and G2 (Fq2).
//
// This is the fast-CPU-fallback component: the reference routes sub-threshold
// MSMs to BLST's multi_exp (core/traits/cpu_impl.rs, ~line 138) rather than a
// naive double-and-add; here the same role is played by a 64-bit-limb
// Pippenger over the field64.h CIOS arithmetic, exposed via a C ABI and
// consumed through ctypes by runtime/dispatch.py's CPU route.  Formulas are
// the standard EFD Jacobian dbl-2009-l / madd-2007-bl / add-2007-bl (branchy
// host code — the constant-time discipline applies to the device path, not
// this host oracle, mirroring the reference's split).
//
// In/out convention: scalars standard-form LE u64 words (4/element);
// coordinates standard-form LE u64 words (x then y; Fq2 as c0 then c1);
// result is a standard-form Jacobian triple (Z==0 encodes infinity).

#include <cstdint>
#include <cstring>
#include <vector>

#include "field64.h"

namespace {

using namespace bls381;

// ---------------------------------------------------------------------------
// Field wrappers
// ---------------------------------------------------------------------------

struct Fq {
  uint64_t v[6];

  static Fq zero() { Fq r; std::memset(r.v, 0, sizeof r.v); return r; }
  static Fq one() {  // Montgomery R mod p = to_mont(1)
    Fq r = zero();
    r.v[0] = 1;
    Fq out;
    mont_mul<6>(r.v, FQ_R2, FQ_P, FQ_INV, out.v);
    return out;
  }
  bool is_zero() const { return bls381::is_zero<6>(v); }
  bool equals(const Fq& o) const { return eq<6>(v, o.v); }
  Fq add(const Fq& o) const { Fq r; add_mod<6>(v, o.v, FQ_P, r.v); return r; }
  Fq sub(const Fq& o) const { Fq r; sub_mod<6>(v, o.v, FQ_P, r.v); return r; }
  Fq dbl() const { return add(*this); }
  Fq mul(const Fq& o) const {
    Fq r; mont_mul<6>(v, o.v, FQ_P, FQ_INV, r.v); return r;
  }
  Fq sqr() const { return mul(*this); }
  Fq to_mont() const { Fq r; mont_mul<6>(v, FQ_R2, FQ_P, FQ_INV, r.v); return r; }
  Fq from_mont() const {
    Fq one_std = zero(); one_std.v[0] = 1;
    Fq r; mont_mul<6>(v, one_std.v, FQ_P, FQ_INV, r.v); return r;
  }
};

// Fq2 = Fq[u] / (u^2 + 1)
struct Fq2 {
  Fq c0, c1;

  static Fq2 zero() { return {Fq::zero(), Fq::zero()}; }
  static Fq2 one() { return {Fq::one(), Fq::zero()}; }
  bool is_zero() const { return c0.is_zero() && c1.is_zero(); }
  bool equals(const Fq2& o) const { return c0.equals(o.c0) && c1.equals(o.c1); }
  Fq2 add(const Fq2& o) const { return {c0.add(o.c0), c1.add(o.c1)}; }
  Fq2 sub(const Fq2& o) const { return {c0.sub(o.c0), c1.sub(o.c1)}; }
  Fq2 dbl() const { return add(*this); }
  Fq2 mul(const Fq2& o) const {  // Karatsuba, u^2 = -1
    Fq t0 = c0.mul(o.c0);
    Fq t1 = c1.mul(o.c1);
    Fq s = c0.add(c1).mul(o.c0.add(o.c1));
    return {t0.sub(t1), s.sub(t0).sub(t1)};
  }
  Fq2 sqr() const {  // (c0+c1)(c0-c1), 2*c0*c1
    Fq t = c0.add(c1).mul(c0.sub(c1));
    Fq u = c0.mul(c1);
    return {t, u.dbl()};
  }
  Fq2 to_mont() const { return {c0.to_mont(), c1.to_mont()}; }
  Fq2 from_mont() const { return {c0.from_mont(), c1.from_mont()}; }
};

// ---------------------------------------------------------------------------
// Jacobian curve ops (generic over Fq / Fq2; a = 0 curves)
// ---------------------------------------------------------------------------

template <typename F>
struct Aff { F x, y; bool inf; };

template <typename F>
struct Jac {
  F X, Y, Z;  // Z == 0 encodes infinity

  static Jac identity() { return {F::one(), F::one(), F::zero()}; }
  bool is_identity() const { return Z.is_zero(); }
};

// dbl-2009-l
template <typename F>
static Jac<F> jac_dbl(const Jac<F>& P) {
  if (P.is_identity()) return P;
  F A = P.X.sqr();
  F B = P.Y.sqr();
  F C = B.sqr();
  F D = P.X.add(B).sqr().sub(A).sub(C).dbl();
  F E = A.dbl().add(A);
  F Ff = E.sqr();
  F X3 = Ff.sub(D.dbl());
  F Y3 = E.mul(D.sub(X3)).sub(C.dbl().dbl().dbl());
  F Z3 = P.Y.mul(P.Z).dbl();
  return {X3, Y3, Z3};
}

// madd-2007-bl (Z2 = 1)
template <typename F>
static Jac<F> jac_madd(const Jac<F>& P, const Aff<F>& a) {
  if (a.inf) return P;
  if (P.is_identity()) return {a.x, a.y, F::one()};
  F Z1Z1 = P.Z.sqr();
  F U2 = a.x.mul(Z1Z1);
  F S2 = a.y.mul(P.Z).mul(Z1Z1);
  F H = U2.sub(P.X);
  F r = S2.sub(P.Y).dbl();
  if (H.is_zero()) {
    if (r.is_zero()) return jac_dbl(P);
    return Jac<F>::identity();
  }
  F HH = H.sqr();
  F I = HH.dbl().dbl();
  F J = H.mul(I);
  F V = P.X.mul(I);
  F X3 = r.sqr().sub(J).sub(V.dbl());
  F Y3 = r.mul(V.sub(X3)).sub(P.Y.mul(J).dbl());
  F Z3 = P.Z.add(H).sqr().sub(Z1Z1).sub(HH);
  return {X3, Y3, Z3};
}

// add-2007-bl
template <typename F>
static Jac<F> jac_add(const Jac<F>& P, const Jac<F>& Q) {
  if (P.is_identity()) return Q;
  if (Q.is_identity()) return P;
  F Z1Z1 = P.Z.sqr();
  F Z2Z2 = Q.Z.sqr();
  F U1 = P.X.mul(Z2Z2);
  F U2 = Q.X.mul(Z1Z1);
  F S1 = P.Y.mul(Q.Z).mul(Z2Z2);
  F S2 = Q.Y.mul(P.Z).mul(Z1Z1);
  F H = U2.sub(U1);
  F r = S2.sub(S1).dbl();
  if (H.is_zero()) {
    if (r.is_zero()) return jac_dbl(P);
    return Jac<F>::identity();
  }
  F I = H.dbl().sqr();
  F J = H.mul(I);
  F V = U1.mul(I);
  F X3 = r.sqr().sub(J).sub(V.dbl());
  F Y3 = r.mul(V.sub(X3)).sub(S1.mul(J).dbl());
  F Z3 = P.Z.add(Q.Z).sqr().sub(Z1Z1).sub(Z2Z2).mul(H);
  return {X3, Y3, Z3};
}

// ---------------------------------------------------------------------------
// Pippenger
// ---------------------------------------------------------------------------

static const int SCALAR_BITS = 255;

static inline unsigned digit_at(const uint64_t* s, int pos, int w) {
  // w-bit window starting at bit `pos` of a 4x64-bit little-endian scalar
  int word = pos >> 6, off = pos & 63;
  uint64_t d = s[word] >> off;
  if (off + w > 64 && word + 1 < 4) d |= s[word + 1] << (64 - off);
  return (unsigned)(d & ((1ULL << w) - 1));
}

static inline int window_bits_host(size_t n) {
  int ln = 0;
  while ((n >> ln) > 1) ++ln;
  int w = ln - 2;
  if (w < 2) w = 2;
  if (w > 13) w = 13;
  return w;
}

template <typename F>
static Jac<F> pippenger(const uint64_t* scalars, const Aff<F>* pts, size_t n) {
  int w = window_bits_host(n);
  int T = (SCALAR_BITS + w - 1) / w;
  size_t nb = ((size_t)1 << w) - 1;
  std::vector<Jac<F>> buckets(nb);
  Jac<F> acc = Jac<F>::identity();
  for (int t = T - 1; t >= 0; --t) {
    if (t != T - 1)
      for (int d = 0; d < w; ++d) acc = jac_dbl(acc);
    for (size_t b = 0; b < nb; ++b) buckets[b] = Jac<F>::identity();
    for (size_t i = 0; i < n; ++i) {
      unsigned d = digit_at(scalars + 4 * i, t * w, w);
      if (d) buckets[d - 1] = jac_madd(buckets[d - 1], pts[i]);
    }
    // sum_b (b+1) * buckets[b] via running suffix sums
    Jac<F> running = Jac<F>::identity();
    Jac<F> win = Jac<F>::identity();
    for (size_t b = nb; b-- > 0;) {
      running = jac_add(running, buckets[b]);
      win = jac_add(win, running);
    }
    acc = jac_add(acc, win);
  }
  return acc;
}

template <typename F, int KW>
static void load_affine(const uint64_t* xy, const uint8_t* inf, size_t n,
                        std::vector<Aff<F>>* out);

template <>
void load_affine<Fq, 12>(const uint64_t* xy, const uint8_t* inf, size_t n,
                         std::vector<Aff<Fq>>* out) {
  out->resize(n);
  for (size_t i = 0; i < n; ++i) {
    Aff<Fq>& a = (*out)[i];
    std::memcpy(a.x.v, xy + 12 * i, 6 * 8);
    std::memcpy(a.y.v, xy + 12 * i + 6, 6 * 8);
    a.x = a.x.to_mont();
    a.y = a.y.to_mont();
    a.inf = inf != nullptr && inf[i] != 0;
  }
}

template <>
void load_affine<Fq2, 24>(const uint64_t* xy, const uint8_t* inf, size_t n,
                          std::vector<Aff<Fq2>>* out) {
  out->resize(n);
  for (size_t i = 0; i < n; ++i) {
    Aff<Fq2>& a = (*out)[i];
    std::memcpy(a.x.c0.v, xy + 24 * i, 6 * 8);
    std::memcpy(a.x.c1.v, xy + 24 * i + 6, 6 * 8);
    std::memcpy(a.y.c0.v, xy + 24 * i + 12, 6 * 8);
    std::memcpy(a.y.c1.v, xy + 24 * i + 18, 6 * 8);
    a.x = a.x.to_mont();
    a.y = a.y.to_mont();
    a.inf = inf != nullptr && inf[i] != 0;
  }
}

}  // namespace

extern "C" {

// scalars: n*4 standard-form LE words.  xy: n*12 standard-form words (x, y).
// inf: n bytes (nonzero = point at infinity), may be NULL.
// out: 18 words — standard-form Jacobian X, Y, Z (Z == 0 => identity).
void g1_msm_host(const uint64_t* scalars, const uint64_t* xy,
                 const uint8_t* inf, size_t n, uint64_t* out) {
  std::vector<Aff<Fq>> pts;
  load_affine<Fq, 12>(xy, inf, n, &pts);
  Jac<Fq> r = pippenger<Fq>(scalars, pts.data(), n);
  Fq X = r.X.from_mont(), Y = r.Y.from_mont(), Z = r.Z.from_mont();
  std::memcpy(out, X.v, 6 * 8);
  std::memcpy(out + 6, Y.v, 6 * 8);
  std::memcpy(out + 12, Z.v, 6 * 8);
}

// xy: n*24 standard-form words (x.c0, x.c1, y.c0, y.c1).  out: 36 words.
void g2_msm_host(const uint64_t* scalars, const uint64_t* xy,
                 const uint8_t* inf, size_t n, uint64_t* out) {
  std::vector<Aff<Fq2>> pts;
  load_affine<Fq2, 24>(xy, inf, n, &pts);
  Jac<Fq2> r = pippenger<Fq2>(scalars, pts.data(), n);
  Fq2 X = r.X.from_mont(), Y = r.Y.from_mont(), Z = r.Z.from_mont();
  std::memcpy(out, X.c0.v, 6 * 8);
  std::memcpy(out + 6, X.c1.v, 6 * 8);
  std::memcpy(out + 12, Y.c0.v, 6 * 8);
  std::memcpy(out + 18, Y.c1.v, 6 * 8);
  std::memcpy(out + 24, Z.c0.v, 6 * 8);
  std::memcpy(out + 30, Z.c1.v, 6 * 8);
}

}  // extern "C"
