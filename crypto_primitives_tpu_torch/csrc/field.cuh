// Prime-field arithmetic on N little-endian 32-bit words, shared by the
// port's kernels (poseidon_permute.cu, msm_te.cu, msm_sw.cu, field_probe.cu).
//
// Elements are in Montgomery form with R = 2^(32N), the JAX package's
// R = 2^(16 L) with its 16-bit digits paired into words.  Inputs are canonical
// (< p) and every result is fully reduced, so a kernel's output equals the
// plain PyTorch version's (and the JAX package's) word for word.  Every
// supported p has a spare top bit (p < 2^(32N - 1), so rho = p / R < 1/2).
//
// The arithmetic is written on the PTX carry flag: every word step of a
// product is one mad.lo / mad.hi with carry in and out (madc.lo.cc.u32,
// madc.hi.cc.u32), every add and subtract one add.cc / sub.cc; no 64-bit
// accumulator.  Each helper below is one asm volatile instruction, and a
// carry chain is a run of calls with nothing between them that writes the
// flag (NVIDIA's CGBN library chains its carries the same way).  The flag is
// not an operand the compiler sees, so the chains rely on nvcc keeping
// volatile asm statements in order and emitting no carry-writing instruction
// of its own between them; field_probe.cu holds every routine here against
// the plain field tier on the card, at the values that carry through every
// word (p - 1, all-ones words), which a broken chain would fail.
//
// Products are separated from reductions, so that a sum of products takes one
// reduction (the lazy MDS of poseidon_permute.cu):
//   mul_wide  2N-word product a b               2N^2 + N - 1 multiply-adds
//   sqr_wide  2N-word square a^2                 N^2 + 3N - 2, plus 2N shifts
//   mac_wide  (acc, top) += a b                  2N^2 + 3N
//   redc      (acc, top) R^-1, then K steps of   N (2N + 4)
//             conditional subtraction of p
// and mont_mul = mul_wide (mont_sqr = sqr_wide), then redc with one
// subtraction.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// One row of a product into a 2N-word accumulator: acc[i .. i+N] += a * bi,
// plus `pend` (the carries left over from the row before) at word i + N.
// Returns the carries out of word i + N (at most 2), which the next row adds
// one word higher, so no carry ripples through the upper words.
template <int N>
__device__ __forceinline__ uint32_t mac_row(uint32_t* acc, int i, const uint32_t* a, uint32_t bi,
                                            uint32_t pend) {
  acc[i] = mad_lo_cc(a[0], bi, acc[i]);
#pragma unroll
  for (int j = 1; j < N; ++j) acc[i + j] = madc_lo_cc(a[j], bi, acc[i + j]);
  acc[i + N] = addc_cc(acc[i + N], pend);
  const uint32_t c = addc(0u, 0u);
  acc[i + 1] = mad_hi_cc(a[0], bi, acc[i + 1]);
#pragma unroll
  for (int j = 1; j < N; ++j) acc[i + 1 + j] = madc_hi_cc(a[j], bi, acc[i + 1 + j]);
  return addc(c, 0u);
}

// t = a * b as 2N words (no reduction).  a, b < 2^(32N).
template <int N>
__device__ __forceinline__ void mul_wide(uint32_t* t, const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int j = 0; j < N; ++j) t[j] = mul_lo(a[j], b[0]);
  t[1] = mad_hi_cc(a[0], b[0], t[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) t[j + 1] = madc_hi_cc(a[j], b[0], t[j + 1]);
  t[N] = madc_hi(a[N - 1], b[0], 0u);
  // rows 0 .. i-1 hold a * (b mod 2^(32 i)) < 2^(32 (N + i)), so word i + N
  // is still 0 when row i starts and nothing carries out of its hi chain
#pragma unroll
  for (int i = 1; i < N; ++i) {
    t[i] = mad_lo_cc(a[0], b[i], t[i]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[i + j] = madc_lo_cc(a[j], b[i], t[i + j]);
    t[i + N] = addc(0u, 0u);
    t[i + 1] = mad_hi_cc(a[0], b[i], t[i + 1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[i + j + 1] = madc_hi_cc(a[j], b[i], t[i + j + 1]);
    t[i + N] = madc_hi(a[N - 1], b[i], t[i + N]);
  }
}

// t = a^2 as 2N words: the cross products a_i a_j (i < j) once, doubled by a
// one-bit shift, then the squares a_i^2 added; N (N + 1) / 2 word products
// where mul_wide takes N^2.
template <int N>
__device__ __forceinline__ void sqr_wide(uint32_t* t, const uint32_t* a) {
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) t[k] = 0;
  // row i adds a_i * a[i+1 ..] at words 2i+1 .. i+N; rows 0 .. i-1 end at
  // word i+N-1, so word i+N is still 0 and nothing carries out of row i
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    t[2 * i + 1] = mad_lo_cc(a[i], a[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < N; ++j) t[i + j] = madc_lo_cc(a[i], a[j], t[i + j]);
    t[i + N] = addc(0u, 0u);
    if (i + 1 == N - 1) {
      t[i + N] = mad_hi(a[i], a[i + 1], t[i + N]);
    } else {
      t[2 * i + 2] = mad_hi_cc(a[i], a[i + 1], t[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; j < N - 1; ++j) t[i + j + 1] = madc_hi_cc(a[i], a[j], t[i + j + 1]);
      t[i + N] = madc_hi(a[i], a[N - 1], t[i + N]);
    }
  }
  // the cross sum is below a^2 / 2 < 2^(64N - 1): doubling it carries out nothing
#pragma unroll
  for (int k = 2 * N - 1; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] <<= 1;
  t[0] = mad_lo_cc(a[0], a[0], t[0]);
  t[1] = madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) {
    t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[2 * N - 2] = madc_lo_cc(a[N - 1], a[N - 1], t[2 * N - 2]);
  t[2 * N - 1] = madc_hi(a[N - 1], a[N - 1], t[2 * N - 1]);
}

// (acc, top) += a * b, acc 2N words and top the word above them.
template <int N>
__device__ __forceinline__ void mac_wide(uint32_t* acc, uint32_t& top, const uint32_t* a,
                                         const uint32_t* b) {
  uint32_t pend = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) pend = mac_row<N>(acc, i, a, b[i], pend);
  top += pend;
}

// (acc, top) += x * R: an addend that the reduction turns into + x.
template <int N>
__device__ __forceinline__ void add_hi(uint32_t* acc, uint32_t& top, const uint32_t* x) {
  acc[N] = add_cc(acc[N], x[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) acc[N + j] = addc_cc(acc[N + j], x[j]);
  top = addc(top, 0u);
}

// (s, top) -= p if (s, top) >= p.  s and top are updated in place.
template <int N>
__device__ __forceinline__ void sub_if_geq(uint32_t* s, uint32_t& top, const uint32_t* p) {
  uint32_t d[N];
  d[0] = sub_cc(s[0], p[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(s[j], p[j]);
  const uint32_t dt = subc(top, 0u);
  const bool keep = (int32_t)dt < 0;  // (s, top) < p: the borrow ran out of the top word
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = keep ? s[j] : d[j];
  top = keep ? top : dt;
}

// r = (acc, top) * R^-1 mod p, fully reduced, with n0 = -p^(-1) mod 2^32.
// The Montgomery quotient M < R gives (acc + M p) / R < (acc, top) / R + p;
// K conditional subtractions of p follow, so the caller must know that
// (acc, top) / R + p <= (K + 1) p.  For a sum of T products of elements
// below p and A addends below p (add_hi), that bound is (1 + T rho + A) p
// < (1 + T / 2 + A) p, so K = ceil(T / 2 + A) (kSubs below) always does.
// acc is clobbered; r may alias nothing in acc.
template <int N, int K>
__device__ __forceinline__ void redc(uint32_t* r, uint32_t* acc, uint32_t top, const uint32_t* p,
                                     uint32_t n0) {
  uint32_t pend = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) pend = mac_row<N>(acc, i, p, acc[i] * n0, pend);
  top += pend;
#pragma unroll
  for (int k = 0; k < K; ++k) sub_if_geq<N>(acc + N, top, p);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = acc[N + j];
}

// Conditional subtractions that redc needs after T products and A addends.
template <int T, int A>
struct kSubs {
  static constexpr int value = (T + 2 * A + 1) / 2;
};

// r = a * b * R^-1 mod p.  r may alias a or b: both are read before r is written.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t n0) {
  uint32_t t[2 * N];
  mul_wide<N>(t, a, b);
  redc<N, 1>(r, t, 0u, p, n0);
}

// r = a^2 * R^-1 mod p.  r may alias a.
template <int N>
__device__ __forceinline__ void mont_sqr(uint32_t* r, const uint32_t* a, const uint32_t* p,
                                         uint32_t n0) {
  uint32_t t[2 * N];
  sqr_wide<N>(t, a);
  redc<N, 1>(r, t, 0u, p, n0);
}

// r = a + b mod p.  a + b < 2p < 2^(32N) never carries out of the top word.
// r may alias a or b.
template <int N>
__device__ __forceinline__ void mod_add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                        const uint32_t* p) {
  uint32_t s[N];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) s[j] = addc_cc(a[j], b[j]);
  s[N - 1] = addc(a[N - 1], b[N - 1]);
  uint32_t top = 0;
  sub_if_geq<N>(s, top, p);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = s[j];
}

// r = a - b mod p, for a, b < p.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mod_sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                        const uint32_t* p) {
  uint32_t d[N];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0u, 0u);  // all ones if a < b
  // a < b: add p back (the sum wraps past 2^(32N) to a - b + p)
  r[0] = add_cc(d[0], p[0] & mask);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r[j] = addc_cc(d[j], p[j] & mask);
  r[N - 1] = addc(d[N - 1], p[N - 1] & mask);
}

}  // namespace
