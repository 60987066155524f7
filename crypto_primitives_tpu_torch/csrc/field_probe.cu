// Elementwise entry point to field.cuh, for tests only: no TPU kernel maps to
// it, and no path of the port launches it.
//
// field.cuh's carry chains hold their carry in the PTX carry flag between
// separate asm statements; a chain the compiler broke would show only in the
// values that carry through every word.  This probe runs each routine the
// kernels use on word arrays, so tests/test_torch_cuda.py can hold it
// against the plain field tier (ops/field.py) on such values:
// 0, 1, p - 1, p - 2, R mod p, words of all ones below p.
//
// op (each on elements a, b < p, Montgomery form):
//   0  mont_mul(a, b)                       mul_wide, then redc with K = 1
//   1  redc(3 a b + a R)                    a dense row at t = 3 with its fold
//   2  redc(9 a b + a R)                    a dense row at t = 9 with its fold
//   3  redc(a b + (a + b) R)                a sparse row k >= 1 (z_k and fold)
//   4  mod_add(a, b)
//   5  mod_sub(a, b)
//   6  mont_sqr(a)                          sqr_wide, then redc with K = 1
//   7  a b^iters: iters dependent mont_mul   the product's throughput ceiling
//   8  a^(2^iters): iters dependent mont_sqr (native/kernel_times.py)

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
struct ProbeParams {
  uint32_t p[N];
  uint32_t n0;
};

template <int N, int T>
__device__ __forceinline__ void dot_same(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t n0) {
  uint32_t acc[2 * N], top = 0;
  mul_wide<N>(acc, a, b);
#pragma unroll 1
  for (int k = 1; k < T; ++k) mac_wide<N>(acc, top, a, b);
  add_hi<N>(acc, top, a);
  redc<N, kSubs<T, 1>::value>(r, acc, top, p, n0);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
probe_kernel(int op, const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, const __grid_constant__ ProbeParams<N> prm, long long count,
             int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t x[N], y[N], r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = a[i * N + j];
    y[j] = b[i * N + j];
  }
  const uint32_t* p = prm.p;
  if (op == 0) {
    mont_mul<N>(r, x, y, p, prm.n0);
  } else if (op == 1) {
    dot_same<N, 3>(r, x, y, p, prm.n0);
  } else if (op == 2) {
    dot_same<N, 9>(r, x, y, p, prm.n0);
  } else if (op == 3) {
    uint32_t acc[2 * N], top = 0;
    mul_wide<N>(acc, x, y);
    add_hi<N>(acc, top, x);
    add_hi<N>(acc, top, y);
    redc<N, kSubs<1, 2>::value>(r, acc, top, p, prm.n0);
  } else if (op == 4) {
    mod_add<N>(r, x, y, p);
  } else if (op == 5) {
    mod_sub<N>(r, x, y, p);
  } else if (op == 6) {
    mont_sqr<N>(r, x, p, prm.n0);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = x[j];
#pragma unroll 1
    for (int k = 0; k < iters; ++k) {
      if (op == 7) mont_mul<N>(r, r, y, p, prm.n0);
      else mont_sqr<N>(r, r, p, prm.n0);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) out[i * N + j] = r[j];
}

template <int N>
cudaError_t launch(int op, const void* a, const void* b, void* out, const uint32_t* p,
                   uint32_t n0, long long count, int iters, cudaStream_t stream) {
  ProbeParams<N> prm;
  std::memcpy(prm.p, p, sizeof(prm.p));
  prm.n0 = n0;
  const unsigned blocks = (unsigned)((count + kThreads - 1) / kThreads);
  probe_kernel<N><<<blocks, kThreads, 0, stream>>>(
      op, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), prm, count, iters);
  return cudaGetLastError();
}

}  // namespace

// out[i] = op(a[i], b[i]) for `count` elements of `nwords` words (8 or 12),
// all (count, nwords) uint32 on the device, on `stream`; `iters` is the chain
// length of ops 7 and 8.  `host_p` is a HOST
// array of p's nwords words; n0 = -p^(-1) mod 2^32.  Returns a cudaError_t
// (0 on success) and does not synchronise.
extern "C" int field_ops(int op, const void* a, const void* b, void* out, const void* host_p,
                         unsigned int n0, long long count, int iters, int nwords, int device,
                         void* stream) {
  if (count <= 0) return cudaSuccess;
  if (op < 0 || op > 8 || iters < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(host_p);
  if (nwords == 8) return launch<8>(op, a, b, out, p, n0, count, iters, s);
  if (nwords == 12) return launch<12>(op, a, b, out, p, n0, count, iters, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
