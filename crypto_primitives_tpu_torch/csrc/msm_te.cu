// Grouped subset-sum MSM on a twisted-Edwards curve with a = -1, one CUDA
// thread per batch row.
//
// Replaces the TPU kernel grouped_msm_pallas of crypto_primitives_tpu
// (ops/msm_rns_pallas.py): out[b] = sum_g table[g][idx[b][g]], where group g
// of the table holds the 2^w subset sums of w fixed points, each stored
// affine as (x, y, d*x*y).  The sum starts at the identity (0 : 1 : 0 : 1) and
// takes one complete add-2008-hwcd addition per group, specialised as the TPU
// kernel specialises it: the table point is affine (Z2 = 1 drops a product),
// d is folded into its T coordinate (C = T1 * (d T2) needs no constant
// product) and a = -1 (H = B + A).  That is 8 Montgomery products per group.
// The output is extended (X, Y, T, Z), fully reduced, in the JAX limb tier's
// coordinate order.  The TPU kernel's RNS residues, 6-bit digit planes and
// one-hot matmul select exist because of the TPU and are not carried over.
//
// What bounds it: 32-bit integer multiply-adds.  A row reads G indices and G
// table points (the table, 263 KB at Pedersen's 250 x 8 window with w = 3 and
// 342 groups, stays in L2) and writes one point, against 8 products of N x N
// words per group.  The design follows from that:
//   * the products are field.cuh's carry-chain products;
//   * the accumulator stays in registers for the whole row, and the group
//     loop stays rolled, so nvcc inlines only 8 products and the build takes
//     seconds;
//   * a block stages the indices of its 128 rows for a chunk of 32 groups in
//     shared memory with coalesced loads (a warp reads 32 consecutive indices
//     of one row), then each thread walks its own row of the tile (stride
//     33 words, so no bank conflicts); without the tile a warp's index reads
//     were G * 4 bytes apart;
//   * a table point is read as six 16-byte loads through the read-only cache
//     (all rows of a block read the same group's 8 points at about the same
//     time, so they hit in L1).  Staging each chunk's table slice in shared
//     memory with cp.async instead measured the same (6.64 and 6.54 ms
//     against 6.57 and 6.73 ms at 2^16 rows x 342 groups on an NVIDIA H100
//     80GB HBM3 at 700.00 W; PERF.md), so the simpler read stays;
//   * the modulus and the Montgomery one are kernel parameters
//     (__grid_constant__, read from the constant bank).
// One row per thread and the groups in order keep the projective output
// word-equal to the plain version's.  At 2^16 rows the grid is 512 blocks of
// 4 warps, 15.5 warps per SM: one wave, whatever the block size, since every
// row is one thread.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // groups per index tile

template <int N>
struct TeParams {
  uint32_t p[N];    // the modulus
  uint32_t one[N];  // R mod p, the Montgomery one
  uint32_t n0;      // -p^(-1) mod 2^32
};

template <int N>
__global__ void __launch_bounds__(kThreads)
msm_te_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, const __grid_constant__ TeParams<N> prm,
              long long batch, int groups, int ncombos) {
  __shared__ int32_t tile[kThreads][kChunk + 1];
  const long long row0 = (long long)blockIdx.x * kThreads;
  const long long row = row0 + threadIdx.x;
  const bool live = row < batch;
  const int rows_here = (int)min((long long)kThreads, batch - row0);
  const uint32_t* p = prm.p;
  const uint32_t n0 = prm.n0;

  uint32_t X[N], Y[N], T[N], Z[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    X[j] = 0;
    Y[j] = prm.one[j];
    T[j] = 0;
    Z[j] = prm.one[j];
  }

  // the caller keeps indices in [0, 2^w); the mask only keeps the read of a
  // bad index inside the table, and that row's sum is then meaningless
  const unsigned mask = (unsigned)ncombos - 1u;
  constexpr int kVec = 3 * N / 4;  // 16-byte vectors per table point
#pragma unroll 1
  for (int g0 = 0; g0 < groups; g0 += kChunk) {
    const int cg = min(kChunk, groups - g0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < rows_here * cg; e += kThreads) {
      const int r = e / cg, c = e - r * cg;
      tile[r][c] = __ldg(idx + (row0 + r) * groups + g0 + c);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 1
    for (int c = 0; c < cg; ++c) {
      const unsigned e = (unsigned)tile[threadIdx.x][c] & mask;
      const uint4* pt = reinterpret_cast<const uint4*>(table + ((size_t)(g0 + c) * ncombos + e) * 3 * N);
      uint32_t x2[N], y2[N], t2[N];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const uint4 q = __ldg(pt + v);
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int word = 4 * v + k;
          if (word < N) x2[word] = w[k];
          else if (word < 2 * N) y2[word - N] = w[k];
          else t2[word - 2 * N] = w[k];
        }
      }
      uint32_t A[N], B[N], C[N], S[N];
      mont_mul<N>(A, X, x2, p, n0);  // A = X1 x2
      mont_mul<N>(B, Y, y2, p, n0);  // B = Y1 y2
      mont_mul<N>(C, T, t2, p, n0);  // C = T1 (d x2 y2)
      mod_add<N>(S, X, Y, p);
      mod_add<N>(x2, x2, y2, p);
      mont_mul<N>(S, S, x2, p, n0);  // (X1 + Y1)(x2 + y2)
      mod_sub<N>(S, S, A, p);
      mod_sub<N>(S, S, B, p);        // E = S - A - B
      mod_add<N>(B, B, A, p);        // H = B + A  (a = -1)
      mod_sub<N>(A, Z, C, p);        // F = Z1 - C (D = Z1, as Z2 = 1)
      mod_add<N>(C, Z, C, p);        // G = Z1 + C
      mont_mul<N>(X, S, A, p, n0);   // X3 = E F
      mont_mul<N>(Y, C, B, p, n0);   // Y3 = G H
      mont_mul<N>(T, S, B, p, n0);   // T3 = E H
      mont_mul<N>(Z, A, C, p, n0);   // Z3 = F G
    }
  }
  if (!live) return;

  uint32_t* dst = out + row * 4 * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    dst[j] = X[j];
    dst[N + j] = Y[j];
    dst[2 * N + j] = T[j];
    dst[3 * N + j] = Z[j];
  }
}

template <int N>
cudaError_t launch(const void* table, const void* idx, void* out, const uint32_t* consts,
                   uint32_t n0, long long batch, int groups, int ncombos, cudaStream_t stream) {
  TeParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.one, consts + N, sizeof(prm.one));
  prm.n0 = n0;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  msm_te_kernel<N><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), prm, batch, groups, ncombos);
  return cudaGetLastError();
}

}  // namespace

// out[b] = sum_g table[g][idx[b][g]] for `batch` rows, on `stream`.
// `table` is (groups, ncombos, 3, nwords) uint32 on the device, each entry
// (x, y, d x y) in Montgomery form, and 16-byte aligned; `idx` is (batch,
// groups) int32 on the device; `out` is (batch, 4, nwords) uint32 extended
// points (X, Y, T, Z).
// `host_consts` is a HOST array of 2 * nwords words: p, then R mod p.
// ncombos must be a power of two.  Returns a cudaError_t (0 on success) and
// does not synchronise.
extern "C" int msm_te(const void* table, const void* idx, void* out, const void* host_consts,
                      unsigned int n0, long long batch, int groups, int ncombos, int nwords,
                      int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (groups < 0 || ncombos < 1 || (ncombos & (ncombos - 1))) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* consts = static_cast<const uint32_t*>(host_consts);
  if ((reinterpret_cast<uintptr_t>(table) & 15) != 0) return cudaErrorMisalignedAddress;
  if (nwords == 8) return launch<8>(table, idx, out, consts, n0, batch, groups, ncombos, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
