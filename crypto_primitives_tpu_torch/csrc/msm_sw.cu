// Grouped subset-sum MSM on a short-Weierstrass curve, each batch row split
// over k CUDA threads.
//
// Replaces the TPU kernel grouped_msm_sw_pallas of crypto_primitives_tpu
// (ops/msm_sw_rns_pallas.py): out[b] = sum_g table[g][idx[b][g]], where group
// g of the table holds the 2^w subset sums of w fixed points as projective
// (X : Y : Z) (the identity (0 : 1 : 0) is not affine, so the table stays
// projective).  Each addition is the complete Renes-Costello-Batina law
// (eprint 2015/1060, Algorithm 1, any a): 12 products, 3 by a and 2 by 3b.
// The kAZero build drops the three products by a when a = 0 (BLS12-381 G1,
// Pallas); every value it computes equals the general build's.  Builds:
// N = 8 (any a, a = 0), N = 9 (any a: P-256, whose 256-bit p takes a spare
// word) and N = 12 (a = 0).
//
// The split: thread j of a row's k adjacent threads sums the contiguous group
// range [j c, min(G, (j + 1) c)), c = ceil(G / k), in order from the identity;
// the k partial sums then merge in a fixed pairwise tree, (P0 + P1) +
// (P2 + P3) and so on, an odd one carried up a round.  When k divides 32 the
// k threads are lanes of one warp and a round is a __shfl_xor_sync of the 3N
// words; otherwise it goes through shared memory.  ops/msm_sw_kernel.py keeps
// k per build in one table that its plain version reads too, and the plain
// version takes the same ranges and the same tree, so the kernel's projective
// output equals it word for word.  The TPU kernel's chunk-of-8 tree sum is
// another order of the same group sum; its RNS residues, digit planes and
// value-bound budget are not carried over.
//
// What bounds it: 32-bit integer multiplies (12 to 17 products of N x N
// words per group against 3 N words of table read and one index).  A thread
// holds 128 registers at N = 8 and 168 at N = 9 and 12 (the launch bounds
// below), so an SM holds 16 or 12 warps; one thread per row gave 2^14 rows
// about four warps per SM, each running 342 dependent additions.  The split
// fills the SMs with k times as many threads, each with G / k dependent
// additions, at the cost of ceil(log2 k) merge additions; at 2^14 rows and
// N = 12, k = 3 is 512 blocks of 96 threads, one wave at four blocks an SM.  The accumulator and the RCB
// temporaries stay in registers; the group loop and the merge rounds share
// one call of the addition and stay rolled; the curve constants are kernel
// parameters (__grid_constant__, read from the constant bank).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

// A block holds 128 threads where k divides 128, else 32 rows of k threads;
// so k is 1, 2, 3, 4 or 8.
constexpr int kMaxThreads = 128;

// Blocks of 128 threads an SM must hold: 4 at N = 8 (at most 128 registers a
// thread, 16 warps an SM), 3 above (at most 168, 12 warps).  ptxas left to
// itself gives the N = 9 and N = 12 builds 176-181 registers, one warp fewer
// an SM, and at 2^14 rows the last warps then run in a second wave.
template <int N>
constexpr int kMinBlocks = N <= 8 ? 4 : 3;

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
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<N>)
msm_sw_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, const __grid_constant__ SwParams<N> prm,
              long long batch, int groups, int ncombos, int split) {
  const int j = threadIdx.x % split;  // this thread's part of its row
  const long long row = (long long)blockIdx.x * (blockDim.x / split) + threadIdx.x / split;
  const bool live = row < batch;  // the rows past the batch only take part in the merge
  const int chunk = (groups + split - 1) / split;
  int rounds = 0;
  while ((1 << rounds) < split) ++rounds;

  uint32_t X[N], Y[N], Z[N];
#pragma unroll
  for (int w = 0; w < N; ++w) {
    X[w] = 0;
    Y[w] = prm.one[w];
    Z[w] = 0;
  }

  const int32_t* my_idx = idx + (live ? row : 0) * groups;
  // the caller keeps indices in [0, 2^w); the mask only keeps the read of a
  // bad index inside the table, and that row's sum is then meaningless
  const unsigned mask = (unsigned)ncombos - 1u;
  extern __shared__ uint32_t part[];  // (blockDim, 3N) words, where k does not divide 32
  // steps 0 .. chunk-1 add this thread's groups; the last `rounds` steps
  // merge.  Every thread of a block runs every step, so the merge's
  // shuffles and barriers are reached by all of them.
#pragma unroll 1
  for (int step = 0; step < chunk + rounds; ++step) {
    uint32_t X2[N], Y2[N], Z2[N];
    bool add;
    if (step < chunk) {
      const int g = j * chunk + step;
      add = live && g < groups;
      if (add) {
        const unsigned e = (unsigned)__ldg(my_idx + g) & mask;
        const uint32_t* c = table + ((size_t)g * ncombos + e) * 3 * N;
#pragma unroll
        for (int w = 0; w < N; ++w) {
          X2[w] = __ldg(c + w);
          Y2[w] = __ldg(c + N + w);
          Z2[w] = __ldg(c + 2 * N + w);
        }
      }
    } else {
      // round r: part j takes part j + 2^r when j is a multiple of 2^(r+1)
      const int s = 1 << (step - chunk);
      add = (j & (2 * s - 1)) == 0 && j + s < split;
      if (32 % split == 0) {
#pragma unroll
        for (int w = 0; w < N; ++w) {
          X2[w] = __shfl_xor_sync(0xffffffffu, X[w], s);
          Y2[w] = __shfl_xor_sync(0xffffffffu, Y[w], s);
          Z2[w] = __shfl_xor_sync(0xffffffffu, Z[w], s);
        }
      } else {
        uint32_t* mine = part + threadIdx.x * 3 * N;
#pragma unroll
        for (int w = 0; w < N; ++w) {
          mine[w] = X[w];
          mine[N + w] = Y[w];
          mine[2 * N + w] = Z[w];
        }
        __syncthreads();
        if (add) {
          const uint32_t* theirs = mine + s * 3 * N;
#pragma unroll
          for (int w = 0; w < N; ++w) {
            X2[w] = theirs[w];
            Y2[w] = theirs[N + w];
            Z2[w] = theirs[2 * N + w];
          }
        }
        __syncthreads();
      }
    }
    if (add) rcb_add<N, kAZero>(X, Y, Z, X2, Y2, Z2, prm);
  }

  if (!live || j != 0) return;
  uint32_t* dst = out + row * 3 * N;
#pragma unroll
  for (int w = 0; w < N; ++w) {
    dst[w] = X[w];
    dst[N + w] = Y[w];
    dst[2 * N + w] = Z[w];
  }
}

template <int N, bool kAZero>
cudaError_t launch(const void* table, const void* idx, void* out, const uint32_t* consts,
                   uint32_t n0, long long batch, int groups, int ncombos, int split,
                   cudaStream_t stream) {
  SwParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.one, consts + N, sizeof(prm.one));
  std::memcpy(prm.a, consts + 2 * N, sizeof(prm.a));
  std::memcpy(prm.b3, consts + 3 * N, sizeof(prm.b3));
  prm.n0 = n0;
  const int rows = kMaxThreads % split == 0 ? kMaxThreads / split : 32;
  const int threads = rows * split;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = 32 % split == 0 ? 0 : (size_t)threads * 3 * N * sizeof(uint32_t);
  const unsigned blocks = (unsigned)((batch + rows - 1) / rows);
  msm_sw_kernel<N, kAZero><<<blocks, threads, smem, stream>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), prm, batch, groups, ncombos, split);
  return cudaGetLastError();
}

}  // namespace

// out[b] = sum_g table[g][idx[b][g]] for `batch` rows, on `stream`, each row
// split over `split` threads (1, 2, 3, 4 or 8).
// `table` is (groups, ncombos, 3, nwords) uint32 projective points on the
// device, in Montgomery form; `idx` is (batch, groups) int32 on the device;
// `out` is (batch, 3, nwords) uint32 projective points (X, Y, Z).
// `host_consts` is a HOST array of 4 * nwords words: p, R mod p, a and 3b
// (the last two in Montgomery form); a_is_zero selects the build without the
// products by a.  Built for nwords = 8 (any a), 9 (any a) and 12 (a = 0).
// ncombos must be a power of two.  Returns a cudaError_t (0 on success) and
// does not synchronise.
extern "C" int msm_sw(const void* table, const void* idx, void* out, const void* host_consts,
                      unsigned int n0, int a_is_zero, long long batch, int groups, int ncombos,
                      int nwords, int split, int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (groups < 0 || ncombos < 1 || (ncombos & (ncombos - 1))) return cudaErrorInvalidValue;
  if (split < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* consts = static_cast<const uint32_t*>(host_consts);
  if (nwords == 8 && a_is_zero) {
    return launch<8, true>(table, idx, out, consts, n0, batch, groups, ncombos, split, s);
  }
  if (nwords == 8) return launch<8, false>(table, idx, out, consts, n0, batch, groups, ncombos, split, s);
  if (nwords == 9) return launch<9, false>(table, idx, out, consts, n0, batch, groups, ncombos, split, s);
  if (nwords == 12 && a_is_zero) {
    return launch<12, true>(table, idx, out, consts, n0, batch, groups, ncombos, split, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
