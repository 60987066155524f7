// Prime-field arithmetic on N little-endian 32-bit words, shared by the
// port's kernels (poseidon_permute.cu, msm_te.cu, msm_sw.cu).
//
// Elements are in Montgomery form with R = 2^(32N), the JAX package's
// R = 2^(16 L) with its 16-bit digits paired into words.  Inputs are canonical
// (< p) and every result is fully reduced, so a kernel's output equals the
// plain PyTorch version's (and the JAX package's) word for word.  Every
// supported p has a spare top bit (p < 2^(32N - 1)).
#pragma once

#include <cstdint>

namespace {

// r = s - p if s + s_top * 2^(32N) >= p, else s.  r may alias s.
template <int N>
__device__ __forceinline__ void sub_if_geq(uint32_t* r, const uint32_t* s, uint32_t s_top,
                                           const uint32_t* p) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t v = (uint64_t)s[j] - p[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool keep = (s_top == 0) && borrow;
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = keep ? s[j] : d[j];
}

// r = a + b mod p.  Every supported p has a spare top bit, so a + b < 2p
// never carries out of the top word.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mod_add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                        const uint32_t* p) {
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  sub_if_geq<N>(r, s, 0u, p);
}

// r = a * b * 2^(-32N) mod p (CIOS), with n0 = -p^(-1) mod 2^32.
// r may alias a or b: both are read before r is written.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t n0) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // t += a * b[i]; each step is at most (2^32-1)^2 + 2 (2^32-1) < 2^64
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    // t = (t + m p) / 2^32, with m chosen so the low word vanishes
    const uint32_t m = t[0] * n0;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  sub_if_geq<N>(r, t, t[N], p);  // t < 2p
}

// r = a - b mod p, for a, b < p.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mod_sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                        const uint32_t* p) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  // a < b: add p back (the sum wraps past 2^(32N) to a - b + p)
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)d[j] + (p[j] & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

}  // namespace
