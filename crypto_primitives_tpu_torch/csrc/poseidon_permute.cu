// Poseidon permutation over a prime field, one CUDA thread per state.
//
// Replaces both TPU kernels of crypto_primitives_tpu that compute this
// permutation: permute_rns (ops/poseidon_rns_pallas.py, over RNS residues)
// and permute_pallas (ops/poseidon_pallas.py, over 16-bit digits).  Both hold
// a state in Montgomery form with R = 2^(16 L); this kernel keeps the same R
// in N = L / 2 little-endian 32-bit words, so its input and output are the
// JAX limb states with adjacent digits paired into words.
//
// What bounds it: 32-bit integer multiply-adds.  A t = 3 state over a 255-bit
// field is 96 bytes in and 96 bytes out, against about 500 products of 8 x 8
// words per permutation (BLS12-381 Fr: alpha = 17, 8 full and 31 partial
// rounds), so the kernel sits far above the memory roofline.  The design
// follows from that:
//   * fewer products: the partial rounds run the sparse schedule of
//     ops/poseidon_sparse.py (port_schedule: one sparse run over every
//     partial round but the last, 2t - 1 products per round instead of t^2;
//     506 products per permutation instead of 626 at t = 3, alpha = 17);
//   * fewer reductions: each output of a linear layer sums its t unreduced
//     2N-word products and reduces once (field.cuh's mul_wide / mac_wide /
//     redc), with the round's fold added as x R before the reduction, so it
//     costs no separate addition.  The sum of T products of elements below p
//     and A addends below p reduces to below (1 + T / 2 + A) p, so redc takes
//     kSubs<T, A> = ceil(T / 2 + A) conditional subtractions: 3 for a dense
//     or sparse first row at t = 3 (T = 3, A = 1; also at W = 12), 6 at
//     t = 9, and 3 for a sparse row k >= 1 (T = 1; the addends z_k and the
//     fold).  tests/test_torch_poseidon_sparse.py checks these bounds in
//     Python ints for every field the kernel is instantiated for;
//   * the products are field.cuh's carry-chain products, and the S-box's
//     squarings its squaring (N (N + 1) / 2 word products instead of N^2);
//   * the state stays in registers (t <= 3); ark[0], the matrices, the sparse
//     rows and the folds sit in the constant bank (kBank), read by uniform
//     address, so a warp's threads share every read; the modulus and n0 sit
//     at fixed offsets there, so the products take them as constant operands;
//   * the round loop stays rolled, so the build takes seconds.
//
// Round order (the schedule's, equal mod p to the reference's ark, S-box,
// MDS; src/sponge/poseidon/mod.rs:98-121): s += ark[0]; then for every round
// r: S-box (all elements in a full round, the first in a partial round),
// the matmul (the MDS; pre_full in round rf2 - 1; the sparse row set in the
// first n_sparse partial rounds), then + folds[r].
//
// Inputs are canonical (< p) and every result is fully reduced, so the output
// equals the JAX package's word for word.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBankWords = 16384;  // 64 KB, the whole constant bank
constexpr int kHeader = 16;        // p at words 0 .. N-1, n0 at word 15
constexpr int kMaxDevices = 64;

// The kernel image of the config being run: header, then the rows of
// poseidon_sparse.kernel_rows, each N words.  Loaded before every launch on
// the launch's stream (see poseidon_permute below).
__constant__ uint32_t kBank[kBankWords];

template <int N>
__device__ __forceinline__ const uint32_t* elem(int e) {
  return kBank + kHeader + e * N;
}

// x = x^alpha, square-and-multiply from the top bit of alpha.
template <int N>
__device__ __forceinline__ void pow_alpha(uint32_t* x, int alpha, const uint32_t* p, uint32_t n0) {
  uint32_t base[N];
#pragma unroll
  for (int j = 0; j < N; ++j) base[j] = x[j];
  const int top = 31 - __clz(alpha);
#pragma unroll 1
  for (int bit = top - 1; bit >= 0; --bit) {
    mont_sqr<N>(x, x, p, n0);
    if ((alpha >> bit) & 1) mont_mul<N>(x, x, base, p, n0);
  }
}

// One thread permutes one state of t <= TMAX elements.  UNROLL == TMAX keeps
// the state in registers; UNROLL == 1 (the wide-state build) keeps the code
// small and lets the state live in local memory.
template <int N, int TMAX, int UNROLL>
__global__ void __launch_bounds__(kThreads)
permute_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long batch,
               int t, int alpha, int full_rounds, int partial_rounds, int n_sparse) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* p = kBank;
  const uint32_t n0 = kBank[15];

  // element offsets of the tables in the bank (poseidon_sparse.kernel_rows)
  const int o_mds = t;
  const int o_pre = o_mds + t * t;
  const int o_sp = o_pre + t * t;
  const int o_fs = o_sp + n_sparse * (2 * t - 1);
  const int o_fv = o_fs + n_sparse;
  const int rf2 = full_rounds / 2;

  uint32_t s[TMAX][N];
  const uint32_t* src = in + row * t * N;
#pragma unroll(UNROLL)
  for (int k = 0; k < TMAX; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[k][j] = k < t ? src[k * N + j] : 0u;
    if (k < t) mod_add<N>(s[k], s[k], elem<N>(k), p);  // + ark[0]
  }

  const int rounds = full_rounds + partial_rounds;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const bool full = r < rf2 || r >= rf2 + partial_rounds;
    // S-box: every element in a full round, the first in a partial round
#pragma unroll(UNROLL)
    for (int k = 0; k < TMAX; ++k) {
      if (k < t && (full || k == 0)) pow_alpha<N>(s[k], alpha, p, n0);
    }
    // this round's fold: element 0 only (a scalar) or the whole vector
    const bool scalar_fold = r >= rf2 - 1 && r < rf2 - 1 + n_sparse;
    const uint32_t* fold = scalar_fold ? elem<N>(o_fs + r - (rf2 - 1))
                                       : elem<N>(o_fv + (r < rf2 - 1 ? r : r - n_sparse) * t);
    const int i = r - rf2;  // partial round index
    uint32_t o[TMAX][N];
    if (!full && i < n_sparse) {
      // sparse: o0 = m00 z0 + sum_k v[k-1] z_k;  o_k = z_k + w[k-1] z0
      const uint32_t* c = elem<N>(o_sp + i * (2 * t - 1));
      uint32_t acc[2 * N], top = 0;
      mul_wide<N>(acc, s[0], c);
#pragma unroll(UNROLL)
      for (int k = 1; k < TMAX; ++k) {
        if (k < t) mac_wide<N>(acc, top, s[k], c + k * N);
      }
      add_hi<N>(acc, top, fold);
      redc<N, kSubs<TMAX, 1>::value>(o[0], acc, top, p, n0);
#pragma unroll(UNROLL)
      for (int k = 1; k < TMAX; ++k) {
        if (k < t) {
          uint32_t a2[2 * N], top2 = 0;
          mul_wide<N>(a2, s[0], c + (t - 1 + k) * N);
          add_hi<N>(a2, top2, s[k]);
          if (!scalar_fold) add_hi<N>(a2, top2, fold + k * N);
          redc<N, kSubs<1, 2>::value>(o[k], a2, top2, p, n0);
        }
      }
    } else {
      // dense: o_j = sum_k mat[j][k] s_k (+ fold), one reduction per output
      const uint32_t* mat = elem<N>(r == rf2 - 1 ? o_pre : o_mds);
#pragma unroll(UNROLL)
      for (int j = 0; j < TMAX; ++j) {
        if (j < t) {
          uint32_t acc[2 * N], top = 0;
          mul_wide<N>(acc, s[0], mat + (j * t) * N);
#pragma unroll(UNROLL)
          for (int k = 1; k < TMAX; ++k) {
            if (k < t) mac_wide<N>(acc, top, s[k], mat + (j * t + k) * N);
          }
          if (!scalar_fold || j == 0) add_hi<N>(acc, top, fold + (scalar_fold ? 0 : j * N));
          redc<N, kSubs<TMAX, 1>::value>(o[j], acc, top, p, n0);
        }
      }
    }
#pragma unroll(UNROLL)
    for (int k = 0; k < TMAX; ++k) {
      if (k < t) {
#pragma unroll
        for (int j = 0; j < N; ++j) s[k][j] = o[k][j];
      }
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
cudaError_t launch(const void* in, void* out, long long batch, int t, int alpha, int full_rounds,
                   int partial_rounds, int n_sparse, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  permute_kernel<N, TMAX, UNROLL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), batch, t, alpha,
      full_rounds, partial_rounds, n_sparse);
  return cudaGetLastError();
}

// The constant bank is one per device, so a launch must not overwrite it
// while an earlier launch, perhaps on another stream, still reads it: every
// load waits for the previous launch on the device (an event), and host
// threads take turns.  Under stream capture (a CUDA graph) the wait and the
// record are captured as external event nodes, so every replay of the graph
// takes its turn on the same event as the launches outside it.
std::mutex g_bank_mutex;
cudaEvent_t g_bank_free[kMaxDevices];

}  // namespace

// Permute `batch` states of t elements of `nwords` words each, from `in` to
// `out` (both (batch, t, nwords) uint32), on `stream`.  `image` is a device
// array of `image_words` words: a 16-word header (p in nwords words from
// word 0, n0 = -p^(-1) mod 2^32 at word 15), then the rows of
// poseidon_sparse.kernel_rows in Montgomery form, nwords words each, for a
// schedule whose first n_sparse partial rounds are sparse.  Returns a
// cudaError_t (0 on success) and does not synchronise.  It may be captured
// into a CUDA graph (the bank's load, the launch and the event's wait and
// record become the graph's nodes), provided `image` outlives the graph.
extern "C" int poseidon_permute(const void* in, void* out, const void* image, long long image_words,
                                long long batch, int nwords, int t, int alpha, int full_rounds,
                                int partial_rounds, int n_sparse, int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  // a sparse run starts after a full round and ends before the last partial round
  const bool bad_run = n_sparse < 0 || (n_sparse > 0 && (full_rounds < 2 || n_sparse >= partial_rounds));
  if (t < 1 || alpha < 1 || full_rounds < 0 || full_rounds % 2 || partial_rounds < 0 || bad_run ||
      image_words > kBankWords || device < 0 || device >= kMaxDevices) {
    return cudaErrorInvalidValue;
  }
  const long long need = kHeader + (long long)nwords *
      (t + 2 * t * t + n_sparse * (2 * t - 1) + n_sparse +
       (long long)(full_rounds + partial_rounds - n_sparse) * t);
  if (need != image_words) return cudaErrorInvalidValue;
  const bool w8t3 = nwords == 8 && t <= 3, w8t9 = nwords == 8 && t <= 9, w12t3 = nwords == 12 && t <= 3;
  if (!(w8t3 || w8t9 || w12t3)) return cudaErrorInvalidValue;

  std::lock_guard<std::mutex> lock(g_bank_mutex);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(s, &capture);
  if (err != cudaSuccess) return err;
  const bool captured = capture == cudaStreamCaptureStatusActive;
  cudaEvent_t& free_ev = g_bank_free[device];
  if (free_ev == nullptr) {
    err = cudaEventCreateWithFlags(&free_ev, cudaEventDisableTiming);
  } else {
    err = cudaStreamWaitEvent(s, free_ev, captured ? cudaEventWaitExternal : cudaEventWaitDefault);
  }
  if (err != cudaSuccess) return err;
  err = cudaMemcpyToSymbolAsync(kBank, image, (size_t)image_words * 4, 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  if (w8t3) {
    err = launch<8, 3, 3>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  } else if (w8t9) {
    err = launch<8, 9, 1>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  } else {
    err = launch<12, 3, 3>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  }
  if (err != cudaSuccess) return err;
  return cudaEventRecordWithFlags(free_ev, s, captured ? cudaEventRecordExternal : cudaEventRecordDefault);
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
