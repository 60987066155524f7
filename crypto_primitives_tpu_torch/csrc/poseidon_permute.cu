// Poseidon permutation over a prime field, one CUDA thread per state.
//
// Replaces both TPU kernels of crypto_primitives_tpu that compute this
// permutation: permute_rns (ops/poseidon_rns_pallas.py, over RNS residues)
// and permute_pallas (ops/poseidon_pallas.py, over 16-bit digits).  Both hold
// a state in Montgomery form with R = 2^(16 L); this kernel keeps the same R
// in N = L / 2 little-endian 32-bit words, so its input and output are the
// JAX limb states with adjacent digits paired into words.
//
// What bounds it: 32-bit integer multiplies.  A t = 3 state over a 255-bit
// field is 96 bytes in and 96 bytes out, against about 600 Montgomery
// products of 8 x 8 words per permutation (BLS12-381 Fr: alpha = 17, 8 full
// and 31 partial rounds), so the kernel sits far above the memory roofline.
// The design follows from that: a state stays in registers for the whole
// permutation; products are CIOS Montgomery multiplications with 64-bit
// accumulators; every thread of a warp reads a round constant at the same
// address, a broadcast through the read-only cache; and the round loop stays
// rolled, so nvcc does not unroll several hundred 256-bit products and the
// build takes seconds.
//
// Inputs are canonical (< p) and every result is fully reduced, so the output
// equals the JAX package's word for word.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;

// x = x^alpha, square-and-multiply from the top bit of alpha.
template <int N>
__device__ __forceinline__ void pow_alpha(uint32_t* x, int alpha, const uint32_t* p, uint32_t n0) {
  uint32_t base[N];
#pragma unroll
  for (int j = 0; j < N; ++j) base[j] = x[j];
  const int top = 31 - __clz(alpha);
#pragma unroll 1
  for (int bit = top - 1; bit >= 0; --bit) {
    mont_mul<N>(x, x, x, p, n0);
    if ((alpha >> bit) & 1) mont_mul<N>(x, x, base, p, n0);
  }
}

// One thread permutes one state of t <= TMAX elements.  UNROLL == TMAX keeps
// the state in registers; UNROLL == 1 (the wide-state build) keeps the code
// small and lets the state live in local memory.
template <int N, int TMAX, int UNROLL>
__global__ void __launch_bounds__(kThreads)
permute_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ ark, const uint32_t* __restrict__ mds,
               const uint32_t* __restrict__ modulus, uint32_t n0, long long batch, int t,
               int alpha, int full_rounds, int partial_rounds) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;

  uint32_t p[N];
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = __ldg(modulus + j);

  uint32_t s[TMAX][N];
  const uint32_t* src = in + row * t * N;
#pragma unroll(UNROLL)
  for (int k = 0; k < TMAX; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[k][j] = k < t ? src[k * N + j] : 0u;
  }

  const int half = full_rounds / 2;
  const int rounds = full_rounds + partial_rounds;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const bool full = r < half || r >= half + partial_rounds;
    const uint32_t* ark_r = ark + (size_t)r * t * N;
    // add round constants, then the S-box (all elements in a full round,
    // the first in a partial round)
#pragma unroll(UNROLL)
    for (int k = 0; k < TMAX; ++k) {
      if (k < t) {
        uint32_t c[N];
#pragma unroll
        for (int j = 0; j < N; ++j) c[j] = __ldg(ark_r + k * N + j);
        mod_add<N>(s[k], s[k], c, p);
        if (full || k == 0) pow_alpha<N>(s[k], alpha, p, n0);
      }
    }
    // MDS: o[i] = sum_k mds[i][k] * s[k]
    uint32_t o[TMAX][N];
#pragma unroll(UNROLL)
    for (int i = 0; i < TMAX; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) o[i][j] = 0;
      if (i < t) {
#pragma unroll(UNROLL)
        for (int k = 0; k < TMAX; ++k) {
          if (k < t) {
            uint32_t m[N], prod[N];
#pragma unroll
            for (int j = 0; j < N; ++j) m[j] = __ldg(mds + (i * t + k) * N + j);
            mont_mul<N>(prod, m, s[k], p, n0);
            mod_add<N>(o[i], o[i], prod, p);
          }
        }
      }
    }
#pragma unroll(UNROLL)
    for (int k = 0; k < TMAX; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) s[k][j] = o[k][j];
    }
  }

  uint32_t* dst = out + row * t * N;
#pragma unroll(UNROLL)
  for (int k = 0; k < TMAX; ++k) {
    if (k < t) {
#pragma unroll
      for (int j = 0; j < N; ++j) dst[k * N + j] = s[k][j];
    }
  }
}

template <int N, int TMAX, int UNROLL>
cudaError_t launch(const void* in, void* out, const void* ark, const void* mds,
                   const void* modulus, uint32_t n0, long long batch, int t, int alpha,
                   int full_rounds, int partial_rounds, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  permute_kernel<N, TMAX, UNROLL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(ark), static_cast<const uint32_t*>(mds),
      static_cast<const uint32_t*>(modulus), n0, batch, t, alpha, full_rounds, partial_rounds);
  return cudaGetLastError();
}

}  // namespace

// Permute `batch` states of t elements of `nwords` words each, from `in` to
// `out` (both (batch, t, nwords) uint32), on `stream`.  `ark` is
// (full_rounds + partial_rounds, t, nwords) and `mds` (t, t, nwords), both in
// Montgomery form; `modulus` is p in nwords words and n0 = -p^(-1) mod 2^32.
// Returns a cudaError_t (0 on success) and does not synchronise.
extern "C" int poseidon_permute(const void* in, void* out, const void* ark, const void* mds,
                                const void* modulus, unsigned int n0, long long batch,
                                int nwords, int t, int alpha, int full_rounds,
                                int partial_rounds, int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (t < 1 || alpha < 1 || full_rounds < 0 || partial_rounds < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwords == 8 && t <= 3) {
    return launch<8, 3, 3>(in, out, ark, mds, modulus, n0, batch, t, alpha, full_rounds,
                           partial_rounds, s);
  }
  if (nwords == 8 && t <= 9) {
    return launch<8, 9, 1>(in, out, ark, mds, modulus, n0, batch, t, alpha, full_rounds,
                           partial_rounds, s);
  }
  if (nwords == 12 && t <= 3) {
    return launch<12, 3, 3>(in, out, ark, mds, modulus, n0, batch, t, alpha, full_rounds,
                            partial_rounds, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
