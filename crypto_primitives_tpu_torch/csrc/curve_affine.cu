// The curve tier's affine step: a batch of projective points to affine
// (X / Z, Y / Z), one CUDA thread per point.
//
// Replaces no TPU kernel: the JAX package makes points affine in plain XLA
// (ops/curve.py te_to_affine, ops/curve_sw.py sw_to_affine), and the port's
// plain version (ops/affine_kernel.py to_affine_plain) does the same in
// plain PyTorch, one schoolbook Montgomery product at a time, which on the
// card is hundreds of small launches a product.  This kernel does the whole
// step in one launch: each thread reads its point's Z, computes the Fermat
// inverse zi = Z^(p-2) by left-to-right square-and-multiply with field.cuh's
// mont_sqr / mont_mul, and writes X zi and Y zi.  Every chain that computes
// Z^(p-2) gives the same fully reduced element, so the output equals the
// plain version's word for word.  Z = 0 (a short-Weierstrass identity) maps
// to (0, 0), as in the plain version and the JAX package: 0^(p-2) = 0.
//
// Input (batch, coords, N) words, Z last: coords 4 is twisted-Edwards
// extended (X, Y, T, Z), coords 3 short-Weierstrass projective (X, Y, Z).
// Output (batch, 2, N).  Built for N = 8, 9 and 12, the word counts of every
// known curve's base field.
//
// What bounds it: 32-bit integer multiply-adds.  A point is (nbits - 1)
// squares, popcount(p - 2) - 1 products and 2 more, about 386 Montgomery
// products at ed-on-bls12-377's 253-bit p, against (coords + 2) N words read
// and written.  At 2^16 points that is about 2.5e7 products and 12 MB, and
// 65,536 threads are under one wave of the 132 SMs.  The design:
//   * the exponent p - 2 and p are kernel parameters (__grid_constant__,
//     the constant bank); every thread takes the same branch at every bit,
//     so the chain costs no divergence;
//   * the bit loop and the two output products stay rolled, so nvcc inlines
//     one square and two products and the build takes seconds;
//   * one thread a point is enough: Montgomery's batch trick across a block
//     would do about 100 times fewer products, but needs zero masking, and
//     at about a millisecond this step is not what limits a Pedersen job.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
struct AffineParams {
  uint32_t p[N];  // the modulus
  uint32_t e[N];  // the exponent p - 2
  uint32_t n0;    // -p^(-1) mod 2^32
  int ebits;      // bit length of e
};

template <int N>
__global__ void __launch_bounds__(kThreads)
curve_affine_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    const __grid_constant__ AffineParams<N> prm, long long batch, int coords) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* src = in + row * coords * N;
  const uint32_t* p = prm.p;
  const uint32_t n0 = prm.n0;

  uint32_t z[N], zi[N];
#pragma unroll
  for (int j = 0; j < N; ++j) z[j] = zi[j] = __ldg(src + (coords - 1) * N + j);
  // the top bit of e is set: zi starts at z and takes the bits below it
#pragma unroll 1
  for (int i = prm.ebits - 2; i >= 0; --i) {
    mont_sqr<N>(zi, zi, p, n0);
    if ((prm.e[i >> 5] >> (i & 31)) & 1u) mont_mul<N>(zi, zi, z, p, n0);
  }

  uint32_t* dst = out + row * 2 * N;
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    uint32_t v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __ldg(src + c * N + j);
    mont_mul<N>(v, v, zi, p, n0);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[c * N + j] = v[j];
  }
}

template <int N>
cudaError_t launch(const void* in, void* out, const uint32_t* consts, uint32_t n0, int ebits,
                   long long batch, int coords, cudaStream_t stream) {
  AffineParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.e, consts + N, sizeof(prm.e));
  prm.n0 = n0;
  prm.ebits = ebits;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  curve_affine_kernel<N><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), prm, batch, coords);
  return cudaGetLastError();
}

}  // namespace

// out[b] = (X_b / Z_b, Y_b / Z_b) for `batch` points, on `stream`.  `in` is
// (batch, coords, nwords) uint32 on the device, Montgomery form, canonical,
// Z at coordinate coords - 1 (coords 3 or 4); `out` is (batch, 2, nwords).
// `host_consts` is a HOST array of 2 * nwords words: p, then p - 2;
// `ebits` is the bit length of p - 2.  Returns a cudaError_t (0 on success)
// and does not synchronise.
extern "C" int curve_affine(const void* in, void* out, const void* host_consts, unsigned int n0,
                            int ebits, long long batch, int coords, int nwords, int device,
                            void* stream) {
  if (batch <= 0) return cudaSuccess;
  if ((coords != 3 && coords != 4) || ebits < 1 || ebits > 32 * nwords) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* consts = static_cast<const uint32_t*>(host_consts);
  switch (nwords) {
    case 8: return launch<8>(in, out, consts, n0, ebits, batch, coords, s);
    case 9: return launch<9>(in, out, consts, n0, ebits, batch, coords, s);
    case 12: return launch<12>(in, out, consts, n0, ebits, batch, coords, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
