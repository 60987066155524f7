// The curve tier's extended Montgomery words from canonical affine
// coordinates on a twisted-Edwards curve: a batch of points (x, y) becomes
// (X, Y, T, Z) = (x R, y R, x y R, R) mod p, one CUDA thread per point.
//
// Replaces no TPU kernel: the JAX package builds the words on the host
// (ops/curve.py TECurveSpec.pack_points, FieldSpec.pack: Python ints, each
// element's Montgomery form one at a time), as the port's host pack does.
// The port's device pack (ops/curve_fast.py pack_points_device) builds only
// the canonical (x, y) words on the host, by one bytes join, uploads them,
// and leaves the Montgomery form and T to this kernel (on the CPU to the
// plain version, ops/pack_kernel.py te_pack_plain).  Each thread computes,
// on field.cuh,
//   X = x R^2 R^-1, Y = y R^2 R^-1, T = X Y R^-1, Z = R mod p,
// three Montgomery products with R^2 mod p and R mod p taken as kernel
// parameters.  Every field.cuh result is fully reduced, so the output equals
// the host pack's word for word.
//
// Input (batch, 2, N) canonical words (each below p, as the host's % p
// leaves them), output (batch, 4, N); built for N = 8, the word count of
// every known twisted-Edwards curve's base field.
//
// What bounds it: bytes.  A point reads 2 x N words and writes 4 x N (192
// bytes at N = 8: 12.6 MB, 3.8 us at 3.35 TB/s, at 2^16 points) against 3
// products of N x N words (1.6 us of the card's 32-bit rate).  So the design
// is A2's (curve_add.cu): one thread a point, nothing shared, every
// coordinate read once and written once in 16-byte accesses.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
struct PackParams {
  uint32_t p[N];    // the modulus
  uint32_t r2[N];   // R^2 mod p
  uint32_t one[N];  // R mod p: 1 in Montgomery form
  uint32_t n0;      // -p^(-1) mod 2^32
};

// One coordinate in or out as N / 4 16-byte accesses (see curve_add.cu).
template <int N>
__device__ __forceinline__ void load(uint32_t* v, const uint32_t* src) {
  static_assert(N % 4 == 0, "a coordinate is whole 16-byte vectors");
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src) + k);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void store(uint32_t* dst, const uint32_t* v) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<uint4*>(dst)[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
curve_pack_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  const __grid_constant__ PackParams<N> prm, long long batch) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* p = prm.p;
  const uint32_t n0 = prm.n0;
  const uint32_t* src = in + row * 2 * N;
  uint32_t* dst = out + row * 4 * N;

  uint32_t x[N], y[N];
  load<N>(x, src);
  load<N>(y, src + N);
  mont_mul<N>(x, x, prm.r2, p, n0);  // X = x R
  store<N>(dst, x);
  mont_mul<N>(y, y, prm.r2, p, n0);  // Y = y R
  store<N>(dst + N, y);
  mont_mul<N>(x, x, y, p, n0);       // T = x y R
  store<N>(dst + 2 * N, x);
  store<N>(dst + 3 * N, prm.one);    // Z = R
}

template <int N>
cudaError_t launch(const void* in, void* out, const uint32_t* consts, uint32_t n0, long long batch,
                   cudaStream_t stream) {
  PackParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.r2, consts + N, sizeof(prm.r2));
  std::memcpy(prm.one, consts + 2 * N, sizeof(prm.one));
  prm.n0 = n0;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  curve_pack_kernel<N><<<blocks, kThreads, 0, stream>>>(static_cast<const uint32_t*>(in),
                                                         static_cast<uint32_t*>(out), prm, batch);
  return cudaGetLastError();
}

}  // namespace

// out[b] = (x R, y R, x y R, R) mod p for the `batch` points in[b] = (x, y),
// on `stream`.  `in` is (batch, 2, nwords) and `out` (batch, 4, nwords)
// uint32 on the device, 16-byte aligned; `in` holds canonical standard-form
// words.  `host_consts` is a HOST array of 3 * nwords words: p, R^2 mod p and
// R mod p.  Returns a cudaError_t (0 on success; invalid value for an nwords
// the kernel is not built for) and does not synchronise.
extern "C" int curve_pack(const void* in, void* out, const void* host_consts, unsigned int n0, long long batch,
                          int nwords, int device, void* stream) {
  if (nwords != 8) return cudaErrorInvalidValue;
  if (batch <= 0) return cudaSuccess;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  if ((addresses & 15) != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch<8>(in, out, static_cast<const uint32_t*>(host_consts), n0, batch,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
