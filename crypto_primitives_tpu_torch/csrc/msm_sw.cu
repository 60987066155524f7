// Grouped subset-sum MSM on a short-Weierstrass curve, one CUDA thread per
// batch row.
//
// Replaces the TPU kernel grouped_msm_sw_pallas of crypto_primitives_tpu
// (ops/msm_sw_rns_pallas.py): out[b] = sum_g table[g][idx[b][g]], where group
// g of the table holds the 2^w subset sums of w fixed points as projective
// (X : Y : Z) (the identity (0 : 1 : 0) is not affine, so the table stays
// projective).  The sum starts at the identity and takes one complete
// Renes-Costello-Batina addition per group (eprint 2015/1060, Algorithm 1,
// any a): 12 products, 3 by a and 2 by 3b.  The kAZero build drops the three
// products by a when a = 0 (BLS12-381 G1, Pallas); every value it computes
// equals the general build's.  The TPU kernel's chunk-of-8 tree sum is a
// latency device for the TPU's lanes; this kernel sums the groups in order,
// which gives the same points as the plain version's sequential sum, word for
// word.  The output is projective (X, Y, Z), fully reduced.  The TPU kernel's
// RNS residues, digit planes and value-bound budget are not carried over.
//
// What bounds it: 32-bit integer multiplies (12 to 17 products of N x N
// words per group against 3 N words of table read and one index).  The
// accumulator and the six RCB temporaries stay in registers (at N = 12 that
// is about 110 words, so the build may spill; ptxas -v reports it); the group
// loop stays rolled; the curve constants are kernel parameters
// (__grid_constant__, read from the constant bank).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 64;

template <int N>
struct SwParams {
  uint32_t p[N];    // the modulus
  uint32_t one[N];  // R mod p, the Montgomery one
  uint32_t a[N];    // a, Montgomery form
  uint32_t b3[N];   // 3 b, Montgomery form
  uint32_t n0;      // -p^(-1) mod 2^32
};

// (X, Y, Z) += (X2, Y2, Z2), RCB Algorithm 1; X2, Y2, Z2 are clobbered.
template <int N, bool kAZero>
__device__ __forceinline__ void rcb_add(uint32_t* X, uint32_t* Y, uint32_t* Z, uint32_t* X2,
                                        uint32_t* Y2, uint32_t* Z2, const SwParams<N>& prm) {
  const uint32_t* p = prm.p;
  const uint32_t n0 = prm.n0;
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N], t5[N], u[N];
  mont_mul<N>(t0, X, X2, p, n0);  // t0 = X1 X2
  mont_mul<N>(t1, Y, Y2, p, n0);  // t1 = Y1 Y2
  mont_mul<N>(t2, Z, Z2, p, n0);  // t2 = Z1 Z2
  mod_add<N>(t3, X, Y, p);
  mod_add<N>(u, X2, Y2, p);
  mont_mul<N>(t3, t3, u, p, n0);
  mod_add<N>(u, t0, t1, p);
  mod_sub<N>(t3, t3, u, p);       // t3 = X1 Y2 + X2 Y1
  mod_add<N>(t4, X, Z, p);
  mod_add<N>(u, X2, Z2, p);
  mont_mul<N>(t4, t4, u, p, n0);
  mod_add<N>(u, t0, t2, p);
  mod_sub<N>(t4, t4, u, p);       // t4 = X1 Z2 + X2 Z1
  mod_add<N>(t5, Y, Z, p);
  mod_add<N>(u, Y2, Z2, p);
  mont_mul<N>(t5, t5, u, p, n0);
  mod_add<N>(u, t1, t2, p);
  mod_sub<N>(t5, t5, u, p);       // t5 = Y1 Z2 + Y2 Z1
  // the inputs are dead from here; X, Y, Z take X3, Y3, Z3
  mont_mul<N>(X, prm.b3, t2, p, n0);  // 3b t2
  if (!kAZero) {
    mont_mul<N>(Z, prm.a, t4, p, n0);
    mod_add<N>(Z, X, Z, p);       // Z3 = 3b t2 + a t4
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) Z[j] = X[j];
  }
  mod_sub<N>(X, t1, Z, p);        // X3 = t1 - Z3
  mod_add<N>(Z, t1, Z, p);        // Z3 = t1 + Z3
  mont_mul<N>(Y, X, Z, p, n0);    // Y3 = X3 Z3
  mod_add<N>(t1, t0, t0, p);
  mod_add<N>(t1, t1, t0, p);      // t1 = 3 t0
  mont_mul<N>(t4, prm.b3, t4, p, n0);  // t4 = 3b t4
  if (!kAZero) {
    mont_mul<N>(t2, prm.a, t2, p, n0);  // t2 = a t2
    mod_add<N>(t1, t1, t2, p);          // t1 = 3 t0 + a t2
    mod_sub<N>(t2, t0, t2, p);
    mont_mul<N>(t2, prm.a, t2, p, n0);  // t2 = a (t0 - a t2)
    mod_add<N>(t4, t4, t2, p);          // t4 = 3b t4 + a (t0 - a t2)
  }
  mont_mul<N>(t0, t1, t4, p, n0);
  mod_add<N>(Y, Y, t0, p);        // Y3 = X3 Z3 + t1 t4
  mont_mul<N>(t0, t5, t4, p, n0);
  mont_mul<N>(X, t3, X, p, n0);
  mod_sub<N>(X, X, t0, p);        // X3 = t3 X3 - t5 t4
  mont_mul<N>(t0, t3, t1, p, n0);
  mont_mul<N>(Z, t5, Z, p, n0);
  mod_add<N>(Z, Z, t0, p);        // Z3 = t5 Z3 + t3 t1
}

template <int N, bool kAZero>
__global__ void __launch_bounds__(kThreads)
msm_sw_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, const __grid_constant__ SwParams<N> prm,
              long long batch, int groups, int ncombos) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;

  uint32_t X[N], Y[N], Z[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    X[j] = 0;
    Y[j] = prm.one[j];
    Z[j] = 0;
  }

  const int32_t* my_idx = idx + row * groups;
  // the caller keeps indices in [0, 2^w); the mask only keeps the read of a
  // bad index inside the table, and that row's sum is then meaningless
  const unsigned mask = (unsigned)ncombos - 1u;
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    const unsigned e = (unsigned)__ldg(my_idx + g) & mask;
    const uint32_t* c = table + ((size_t)g * ncombos + e) * 3 * N;
    uint32_t X2[N], Y2[N], Z2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      X2[j] = __ldg(c + j);
      Y2[j] = __ldg(c + N + j);
      Z2[j] = __ldg(c + 2 * N + j);
    }
    rcb_add<N, kAZero>(X, Y, Z, X2, Y2, Z2, prm);
  }

  uint32_t* dst = out + row * 3 * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    dst[j] = X[j];
    dst[N + j] = Y[j];
    dst[2 * N + j] = Z[j];
  }
}

template <int N, bool kAZero>
cudaError_t launch(const void* table, const void* idx, void* out, const uint32_t* consts,
                   uint32_t n0, long long batch, int groups, int ncombos, cudaStream_t stream) {
  SwParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.one, consts + N, sizeof(prm.one));
  std::memcpy(prm.a, consts + 2 * N, sizeof(prm.a));
  std::memcpy(prm.b3, consts + 3 * N, sizeof(prm.b3));
  prm.n0 = n0;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  msm_sw_kernel<N, kAZero><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), prm, batch, groups, ncombos);
  return cudaGetLastError();
}

}  // namespace

// out[b] = sum_g table[g][idx[b][g]] for `batch` rows, on `stream`.
// `table` is (groups, ncombos, 3, nwords) uint32 projective points on the
// device, in Montgomery form; `idx` is (batch, groups) int32 on the device;
// `out` is (batch, 3, nwords) uint32 projective points (X, Y, Z).
// `host_consts` is a HOST array of 4 * nwords words: p, R mod p, a and 3b
// (the last two in Montgomery form); a_is_zero selects the build without the
// products by a.  Built for nwords = 8 (any a) and nwords = 12 (a = 0).
// ncombos must be a power of two.  Returns a cudaError_t (0 on success) and
// does not synchronise.
extern "C" int msm_sw(const void* table, const void* idx, void* out, const void* host_consts,
                      unsigned int n0, int a_is_zero, long long batch, int groups, int ncombos,
                      int nwords, int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (groups < 0 || ncombos < 1 || (ncombos & (ncombos - 1))) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* consts = static_cast<const uint32_t*>(host_consts);
  if (nwords == 8 && a_is_zero) {
    return launch<8, true>(table, idx, out, consts, n0, batch, groups, ncombos, s);
  }
  if (nwords == 8) return launch<8, false>(table, idx, out, consts, n0, batch, groups, ncombos, s);
  if (nwords == 12 && a_is_zero) {
    return launch<12, true>(table, idx, out, consts, n0, batch, groups, ncombos, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
