// The curve tier's complete addition on a twisted-Edwards curve: a batch of
// point pairs in extended coordinates (X, Y, T, Z) added by add-2008-hwcd,
// one CUDA thread per pair.
//
// Replaces no TPU kernel: the JAX package adds points in plain XLA
// (ops/curve.py te_add), and the port's plain version
// (ops/add_kernel.py te_add_plain, ops/curve.py te_add_digits) does the same
// in plain PyTorch as three stacked Montgomery products on 16-bit digits,
// which on the card is about 730 small launches at 2^16 pairs.  This kernel
// does the whole addition in one launch: each thread reads its two points
// and computes, on field.cuh,
//   A = X1 X2, B = Y1 Y2, C = d T1 T2, D = Z1 Z2,
//   E = (X1 + Y1)(X2 + Y2) - A - B, F = D - C, G = D + C, H = B - a A,
//   X3 = E F, Y3 = G H, T3 = E H, Z3 = F G,
// 11 Montgomery products with d and a (both in Montgomery form) taken as
// kernel parameters, so every twisted-Edwards curve, a = -1 or not, takes
// the same kernel.  Every field.cuh result is fully reduced, so the output
// equals the plain version's word for word.
//
// Input two (batch, 4, N) arrays, output one; built for N = 8, the word
// count of every known twisted-Edwards curve's base field.
//
// What bounds it: bytes.  A pair reads 2 x 4 x N words and writes 4 x N
// (384 bytes at N = 8: 25.2 MB, 7.5 us at 3.35 TB/s, at 2^16 pairs) against
// 11 products of N x N words (5.7 us of the card's 32-bit rate).  Both are
// microseconds, so the design is the simplest that keeps every value in
// registers: one thread a pair, nothing shared between threads, every
// coordinate read once and written once in 16-byte accesses, the products in
// the order that frees each input as soon as it is used.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
struct AddParams {
  uint32_t p[N];  // the modulus
  uint32_t d[N];  // the curve's d, Montgomery form
  uint32_t a[N];  // the curve's a, Montgomery form
  uint32_t n0;    // -p^(-1) mod 2^32
};

// One coordinate in or out as N / 4 16-byte accesses: a warp's load touches
// 32 cache lines (its threads' rows lie 16 N bytes apart) whatever its width,
// so four words an access take a quarter of the L1 wavefronts of one.
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
curve_add_kernel(const uint32_t* __restrict__ in1, const uint32_t* __restrict__ in2,
                 uint32_t* __restrict__ out, const __grid_constant__ AddParams<N> prm, long long batch) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* p = prm.p;
  const uint32_t n0 = prm.n0;
  const uint32_t* s1 = in1 + row * 4 * N;
  const uint32_t* s2 = in2 + row * 4 * N;

  uint32_t u[N], v[N], A[N], B[N], C[N], D[N];
  load<N>(u, s1);
  load<N>(v, s2);
  mont_mul<N>(A, u, v, p, n0);  // A = X1 X2
  load<N>(C, s1 + N);
  load<N>(D, s2 + N);
  mont_mul<N>(B, C, D, p, n0);  // B = Y1 Y2
  mod_add<N>(u, u, C, p);       // X1 + Y1
  mod_add<N>(v, v, D, p);       // X2 + Y2
  uint32_t E[N];
  mont_mul<N>(E, u, v, p, n0);  // (X1 + Y1)(X2 + Y2)
  mod_sub<N>(E, E, A, p);
  mod_sub<N>(E, E, B, p);       // E
  load<N>(u, s1 + 2 * N);
  load<N>(v, s2 + 2 * N);
  mont_mul<N>(C, u, v, p, n0);
  mont_mul<N>(C, C, prm.d, p, n0);  // C = d T1 T2
  load<N>(u, s1 + 3 * N);
  load<N>(v, s2 + 3 * N);
  mont_mul<N>(D, u, v, p, n0);  // D = Z1 Z2
  mont_mul<N>(A, A, prm.a, p, n0);
  mod_sub<N>(B, B, A, p);       // H = B - a A
  mod_sub<N>(u, D, C, p);       // F = D - C
  mod_add<N>(v, D, C, p);       // G = D + C

  uint32_t* dst = out + row * 4 * N;
  mont_mul<N>(A, E, u, p, n0);  // X3 = E F
  store<N>(dst, A);
  mont_mul<N>(A, v, B, p, n0);  // Y3 = G H
  store<N>(dst + N, A);
  mont_mul<N>(A, E, B, p, n0);  // T3 = E H
  store<N>(dst + 2 * N, A);
  mont_mul<N>(A, u, v, p, n0);  // Z3 = F G
  store<N>(dst + 3 * N, A);
}

template <int N>
cudaError_t launch(const void* in1, const void* in2, void* out, const uint32_t* consts, uint32_t n0,
                   long long batch, cudaStream_t stream) {
  AddParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.d, consts + N, sizeof(prm.d));
  std::memcpy(prm.a, consts + 2 * N, sizeof(prm.a));
  prm.n0 = n0;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  curve_add_kernel<N><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(in1), static_cast<const uint32_t*>(in2), static_cast<uint32_t*>(out), prm,
      batch);
  return cudaGetLastError();
}

}  // namespace

// out[b] = in1[b] + in2[b] for `batch` pairs of twisted-Edwards points, on
// `stream`.  `in1`, `in2` and `out` are (batch, 4, nwords) uint32 on the
// device, 16-byte aligned, extended (X, Y, T, Z), Montgomery form,
// canonical.  `host_consts` is a HOST array of 3 * nwords words: p, then the
// curve's d and a in Montgomery form.  Returns a cudaError_t (0 on success;
// invalid value for an nwords the kernel is not built for) and does not
// synchronise.
extern "C" int curve_add(const void* in1, const void* in2, void* out, const void* host_consts, unsigned int n0,
                         long long batch, int nwords, int device, void* stream) {
  if (nwords != 8) return cudaErrorInvalidValue;
  if (batch <= 0) return cudaSuccess;
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(in1) | reinterpret_cast<uintptr_t>(in2) | reinterpret_cast<uintptr_t>(out);
  if ((addresses & 15) != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch<8>(in1, in2, out, static_cast<const uint32_t*>(host_consts), n0, batch,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
