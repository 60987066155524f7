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
// Lane groups (permute_kernel_group), for launches that cannot fill the card.
// Below one wave of the one-thread kernel a launch takes the time of one
// thread's permutation whatever its size: 4096 states are 32 blocks, on 32 of
// the 132 SMs, one warp per scheduler, each issuing the ~500 products of its
// thread's permutation alone.  The group kernel spreads every permutation
// over G lanes of a warp (G divides N), so the same states keep G times as many
// schedulers busy, each with a share of the words.  Lane l of a group holds
// words lK .. lK+K-1 (K = N / G) of every state element.  A product a b R^-1,
// or a sum of them, runs over b digit by digit, K words a digit, each digit
// one step of a Montgomery reduction whose radix is 2^(32 K) (CIOS):
//   * every lane adds its K words of a times the digit into its 2K + 1
//     words (b is the same in every lane: a row of the bank, read by uniform
//     address, or an S-box operand gathered whole by N shuffles);
//   * lane 0 works out the quotient digit (K words, word by word from n0,
//     that make its low K words 0) and broadcasts it (K shuffles), while the
//     low K words of each lane travel to the lane below (K shuffles);
//   * every lane adds the quotient digit times its K words of p, and works
//     out the lane above's low K words after the same product from that
//     lane's words of p, so the sum moves down one lane without waiting on a
//     second shuffle: a lane keeps its upper K words plus the lower K of the
//     lane above, and the word above those as a carry owed to the lane above.
// After G steps the owed carries go up one lane (one shuffle) and on through
// any run of all-ones lanes by a carry-lookahead over two warp votes; the
// conditional subtractions of p resolve their borrows the same way.  The
// bounds are the one-thread kernel's: the same sums reduce to below the same
// (1 + T / 2 + A) p, and take the same kSubs subtractions (the sparse round's
// three outputs, reduced together, take the larger count, 3 at t = 3).
// Independent products go through each phase together (the t S-boxes of a
// full round, the t outputs of a linear layer), so their shuffles and votes
// wait at once; the words are plain C on 64-bit sums, so that only real data
// dependences order them.  What bounds a group, by clock64 on an H100: one
// warp on a scheduler issues its integer instructions about one per 2.3
// cycles, interleaved or not, and a lane at G = 4 issues about 0.6 of a
// thread's instructions at G = 1 for 1/4 of its multiplies: the quotient
// digit, the shuffles, the 64-bit carries and the lookaheads do not shrink
// with K.  So
// the wrapper (ops/poseidon_kernel.py) takes G = 1 once a launch fills the
// card, and below that the G that the crossover table in PERF.md found
// fastest for its states per SM.  Groups are built at G = 4 for t <= 3 (W =
// 8 and 12): G = 2 and 8 gave the same outputs but never led G = 4 by more
// than the noise between runs (PERF.md), so they are not built.  The t <= 9
// build keeps one thread a state, since its state lives in local memory and
// its launches (wide sponges) are rare.
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

constexpr unsigned kWarp = 0xffffffffu;

template <int G>
__device__ __forceinline__ int group_lane() {
  return threadIdx.x & (G - 1);
}

// The carries into the lanes of this lane's group, where each lane either
// generates a carry (gen), passes on the one it receives (prop), or neither:
// bit i of the result is the carry into lane i, bit G the carry out of the
// group.  They are the carries of the sum (gen | prop) + gen, one bit a lane,
// as in a carry-lookahead adder.
template <int G>
__device__ __forceinline__ uint32_t group_carries(bool gen, bool prop) {
  const int shift = threadIdx.x & 31 & ~(G - 1);
  const uint32_t mask = (1u << G) - 1;
  const uint32_t g = (__ballot_sync(kWarp, gen) >> shift) & mask;
  const uint32_t a = g | ((__ballot_sync(kWarp, prop) >> shift) & mask);
  return (a + g) ^ a ^ g;
}

// The group kernel's word arithmetic is plain C on 64-bit sums, not
// field.cuh's carry-flag chains: the NP values of a phase are independent,
// and the compiler sees only their real data dependences, where one carry
// flag would order every chain after the one before.

// x += y over K words; the carry out goes into c.
template <int K>
__device__ __forceinline__ void add_words(uint32_t* x, uint32_t& c, const uint32_t* y) {
  uint64_t t = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    t += (uint64_t)x[j] + y[j];
    x[j] = (uint32_t)t;
    t >>= 32;
  }
  c += (uint32_t)t;
}

// (acc, top) += a b, acc 2K words and top the word above them: mac_wide's
// rows, each row's carry out of word r + K owed to word r + K + 1.
template <int K>
__device__ __forceinline__ void mac64(uint32_t* acc, uint32_t& top, const uint32_t* a, const uint32_t* b) {
  uint32_t pend = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    uint64_t t = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      t = (uint64_t)a[j] * b[r] + acc[r + j] + (t >> 32);  // < 2^64
      acc[r + j] = (uint32_t)t;
    }
    t = (uint64_t)acc[r + K] + (t >> 32) + pend;
    acc[r + K] = (uint32_t)t;
    pend = (uint32_t)(t >> 32);
  }
  top += pend;
}

// NP group values, each held as every lane's K words x and a word c above
// them, owed to the lane above (the top lane's c is the value's top word):
// pays every c into the lane above.  top becomes the top word in the top
// lane and 0 in the others.
template <int G, int K, int NP>
__device__ __forceinline__ void group_settle(uint32_t (*x)[K], const uint32_t* c, uint32_t* top) {
  const int lane = group_lane<G>();
  uint32_t gen[NP], carry[NP];
#pragma unroll
  for (int v = 0; v < NP; ++v) {
    const uint32_t in = __shfl_up_sync(kWarp, c[v], 1, G);
    uint64_t t = lane == 0 ? 0u : in;
    uint32_t ones = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      t += x[v][j];
      x[v][j] = (uint32_t)t;
      ones &= x[v][j];
      t >>= 32;
    }
    gen[v] = (uint32_t)t;
    // a lane that carried out holds less than what came in, so not all ones
    carry[v] = (group_carries<G>(gen[v] != 0, ones == 0xffffffffu) >> lane) & 1u;
  }
#pragma unroll
  for (int v = 0; v < NP; ++v) {
    uint64_t t = carry[v];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      t += x[v][j];
      x[v][j] = (uint32_t)t;
      t >>= 32;
    }
    top[v] = lane == G - 1 ? c[v] + gen[v] + (uint32_t)t : 0u;
  }
}

// (x, top) -= p if (x, top) >= p, for NP group values together; top is 0
// but in the top lane, and pk is this lane's K words of p.
template <int G, int K, int NP>
__device__ __forceinline__ void group_sub_if_geq(uint32_t (*x)[K], uint32_t* top, const uint32_t* pk) {
  const int lane = group_lane<G>();
  uint32_t d[NP][K + 1], borrows[NP];
#pragma unroll
  for (int v = 0; v < NP; ++v) {
    // (x, top) - (pk, 0); a borrow leaves the top bits of t set
    uint64_t t = 0;
    uint32_t nz = 0;
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      t = (uint64_t)(j < K ? x[v][j] : top[v]) - (j < K ? pk[j] : 0u) - (uint32_t)(t >> 63);
      d[v][j] = (uint32_t)t;
      nz |= d[v][j];
    }
    // a lane whose difference is 0 borrowed nothing, and passes a borrow on
    borrows[v] = group_carries<G>((t >> 63) != 0, nz == 0);
  }
#pragma unroll
  for (int v = 0; v < NP; ++v) {
    uint32_t b = (borrows[v] >> lane) & 1u;  // the borrow from the lanes below
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      const uint64_t t = (uint64_t)d[v][j] - b;
      d[v][j] = (uint32_t)t;
      b = (uint32_t)(t >> 63);
    }
    const bool keep = (borrows[v] >> G) & 1u;  // the group borrows out: (x, top) < p
#pragma unroll
    for (int j = 0; j < K; ++j) x[v][j] = keep ? x[v][j] : d[v][j];
    top[v] = keep || lane != G - 1 ? top[v] : d[v][K];
  }
}

// The quotient digit of one step: the K words q with x + q p = 0 mod
// 2^(32 K), x the low K words of acc, word by word as redc finds its
// quotient words (p's low words from the bank).
template <int K>
__device__ __forceinline__ void quotient_digit(uint32_t* q, const uint32_t* acc, uint32_t n0) {
  uint32_t y[K];
#pragma unroll
  for (int j = 0; j < K; ++j) y[j] = acc[j];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    q[j] = y[j] * n0;
    // y += q_j p 2^(32 j) mod 2^(32 K): word j becomes 0
    uint64_t t = 0;
#pragma unroll
    for (int m = j; m < K; ++m) {
      t = (uint64_t)q[j] * kBank[m - j] + y[m] + (t >> 32);
      y[m] = (uint32_t)t;
    }
  }
}

// r[v] = (the sum of products that terms adds for v) R^-1 + (the addends
// that addends adds for v), fully reduced by SUBS conditional subtractions,
// for NP values v over a lane group, which go through every phase together.
// terms(v, acc, top, i) adds (mac64) this lane's K words of each left operand
// times digit i (words iK .. iK+K-1, the same in every lane) of its right
// operand into (acc, top), which start at 0, so a step's products need
// nothing of the step before; addends(v, x, c) adds this lane's K words of
// each addend.  pk and pu are this lane's and the lane above's K words of p.
// r is written last, so it may be an operand of terms.
template <int N, int G, int NP, int SUBS, class Terms, class Addends>
__device__ __forceinline__ void group_mont(uint32_t (*r)[N / G], const uint32_t* pk, const uint32_t* pu, uint32_t n0,
                                           Terms terms, Addends addends) {
  constexpr int K = N / G;
  const int lane = group_lane<G>();
  uint32_t x[NP][K], c[NP];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    uint32_t acc[NP][2 * K], top[NP], q[NP][K], up[NP][K];
#pragma unroll
    for (int v = 0; v < NP; ++v) {
#pragma unroll
      for (int j = 0; j < 2 * K; ++j) acc[v][j] = 0;
      top[v] = 0;
      terms(v, acc[v], top[v], i);
      if (i > 0) {  // + (x, c), from the step before
        uint64_t t = 0;
#pragma unroll
        for (int j = 0; j < 2 * K; ++j) {
          t += (uint64_t)acc[v][j] + (j < K ? x[v][j] : j == K ? c[v] : 0u);
          acc[v][j] = (uint32_t)t;
          t >>= 32;
        }
        top[v] += (uint32_t)t;
      }
      // the low words of the lane above, before its quotient product: they
      // travel while lane 0 works out the quotient
#pragma unroll
      for (int j = 0; j < K; ++j) up[v][j] = __shfl_down_sync(kWarp, acc[v][j], 1, G);
      quotient_digit<K>(q[v], acc[v], n0);
    }
#pragma unroll
    for (int v = 0; v < NP; ++v) {
#pragma unroll
      for (int j = 0; j < K; ++j) q[v][j] = __shfl_sync(kWarp, q[v][j], 0, G);
    }
#pragma unroll
    for (int v = 0; v < NP; ++v) {
      mac64<K>(acc[v], top[v], pk, q[v]);
      // the lane above's low K words after its quotient product, mod
      // 2^(32 K), from its p words pu: lane 0's are 0, and the sum moves down
      // one lane with no second shuffle
#pragma unroll
      for (int r = 0; r < K; ++r) {
        uint64_t t = 0;
#pragma unroll
        for (int j = 0; j + r < K; ++j) {
          t = (uint64_t)q[v][r] * pu[j] + up[v][r + j] + (t >> 32);
          up[v][r + j] = (uint32_t)t;
        }
      }
      uint64_t t = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        t += (uint64_t)acc[v][K + j] + (lane == G - 1 ? 0u : up[v][j]);
        x[v][j] = (uint32_t)t;
        t >>= 32;
      }
      c[v] = top[v] + (uint32_t)t;
    }
  }
  uint32_t top[NP];
#pragma unroll
  for (int v = 0; v < NP; ++v) addends(v, x[v], c[v]);
  group_settle<G, K, NP>(x, c, top);
#pragma unroll
  for (int k = 0; k < SUBS; ++k) group_sub_if_geq<G, K, NP>(x, top, pk);
#pragma unroll
  for (int v = 0; v < NP; ++v) {
#pragma unroll
    for (int j = 0; j < K; ++j) r[v][j] = x[v][j];
  }
}

// dst = the K words at y where on, else 0: a term or an addend that a state
// of t < TMAX elements lacks, taken without a branch to split a step (the
// words past a config's rows still lie in the bank).
template <int K>
__device__ __forceinline__ void words_if(uint32_t* dst, const uint32_t* y, bool on) {
#pragma unroll
  for (int j = 0; j < K; ++j) dst[j] = on ? y[j] : 0u;
}

struct NoAddends {
  __device__ __forceinline__ void operator()(int, uint32_t*, uint32_t&) const {}
};

// s[k] = s[k]^alpha for k < NP, over a lane group, square-and-multiply from
// the top bit of alpha; the NP chains run together.  Each product gathers
// its right operand whole (N shuffles).
template <int N, int G, int NP>
__device__ __forceinline__ void group_pow_alpha(uint32_t (*s)[N / G], int alpha, const uint32_t* pk,
                                                const uint32_t* pu, uint32_t n0) {
  constexpr int K = N / G;
  uint32_t base[NP][K], full[NP][N];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
#pragma unroll
    for (int j = 0; j < K; ++j) base[k][j] = s[k][j];
  }
  const auto gather = [&]() {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
#pragma unroll
      for (int w = 0; w < N; ++w) full[k][w] = __shfl_sync(kWarp, s[k][w % K], w / K, G);
    }
  };
  const int top = 31 - __clz(alpha);
#pragma unroll 1
  for (int bit = top - 1; bit >= 0; --bit) {
    gather();
    group_mont<N, G, NP, 1>(s, pk, pu, n0, [&](int k, uint32_t* acc, uint32_t& hi, int i) {
      mac64<K>(acc, hi, s[k], full[k] + i * K);
    }, NoAddends());
    if ((alpha >> bit) & 1) {
      gather();
      group_mont<N, G, NP, 1>(s, pk, pu, n0, [&](int k, uint32_t* acc, uint32_t& hi, int i) {
        mac64<K>(acc, hi, base[k], full[k] + i * K);
      }, NoAddends());
    }
  }
}

// One group of G lanes permutes one state of t <= TMAX elements: the round
// function of permute_kernel, each element spread over the group, the t
// S-boxes of a full round and the t outputs of every linear layer computed
// together.  Elements t .. TMAX-1 stay 0 (their S-boxes and products give 0).
template <int N, int TMAX, int G>
__global__ void __launch_bounds__(kThreads)
permute_kernel_group(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long batch,
                     int t, int alpha, int full_rounds, int partial_rounds, int n_sparse) {
  constexpr int K = N / G;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = group_lane<G>();
  const uint32_t n0 = kBank[15];
  // this lane's words of p, and the lane above's (the top lane's are
  // header words it never uses)
  uint32_t pk[K], pu[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    pk[j] = kBank[lane * K + j];
    pu[j] = kBank[(lane + 1) * K + j];
  }

  const int o_mds = t;
  const int o_pre = o_mds + t * t;
  const int o_sp = o_pre + t * t;
  const int o_fs = o_sp + n_sparse * (2 * t - 1);
  const int o_fv = o_fs + n_sparse;
  const int rf2 = full_rounds / 2;

  // a group past the batch permutes the last state and stores nothing:
  // every lane of a warp takes part in the warp's shuffles and votes
  const long long src_row = row < batch ? row : batch - 1;
  const uint32_t* src = in + src_row * t * N + lane * K;
  uint32_t s[TMAX][K], c[TMAX], top[TMAX];
#pragma unroll
  for (int k = 0; k < TMAX; ++k) {  // + ark[0]
    c[k] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) s[k][j] = k < t ? src[k * N + j] : 0u;
    if (k < t) add_words<K>(s[k], c[k], elem<N>(k) + lane * K);
  }
  group_settle<G, K, TMAX>(s, c, top);
  group_sub_if_geq<G, K, TMAX>(s, top, pk);

  const int rounds = full_rounds + partial_rounds;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const bool full = r < rf2 || r >= rf2 + partial_rounds;
    if (full) {
      group_pow_alpha<N, G, TMAX>(s, alpha, pk, pu, n0);
    } else {
      group_pow_alpha<N, G, 1>(s, alpha, pk, pu, n0);
    }
    // this round's fold (an element index): element 0 only, or the whole vector
    const bool scalar_fold = r >= rf2 - 1 && r < rf2 - 1 + n_sparse;
    const int fold = scalar_fold ? o_fs + r - (rf2 - 1) : o_fv + (r < rf2 - 1 ? r : r - n_sparse) * t;
    const int i = r - rf2;  // partial round index
    uint32_t o[TMAX][K];
    if (!full && i < n_sparse) {
      // sparse: o0 = m00 z0 + sum_k v[k-1] z_k;  o_k = z_k + w[k-1] z0, the
      // outputs together under the larger of their subtraction counts
      constexpr int subs = kSubs<TMAX, 1>::value > kSubs<1, 2>::value ? kSubs<TMAX, 1>::value : kSubs<1, 2>::value;
      const uint32_t* m = elem<N>(o_sp + i * (2 * t - 1));
      group_mont<N, G, TMAX, subs>(o, pk, pu, n0, [&](int j, uint32_t* acc, uint32_t& hi, int d) {
        if (j == 0) {  // (elements past t are 0, and so are their products)
#pragma unroll
          for (int k = 0; k < TMAX; ++k) mac64<K>(acc, hi, s[k], m + k * N + d * K);
        } else {
          uint32_t w[K];
          words_if<K>(w, m + (t - 1 + j) * N + d * K, j < t);
          mac64<K>(acc, hi, s[0], w);
        }
      }, [&](int j, uint32_t* x, uint32_t& cy) {
        uint32_t f[K];
        words_if<K>(f, elem<N>(fold + j) + lane * K, j == 0 || (j < t && !scalar_fold));
        add_words<K>(x, cy, f);
        if (j > 0) add_words<K>(x, cy, s[j]);
      });
    } else {
      // dense: o_j = sum_k mat[j][k] s_k (+ fold), one reduction per output
      const uint32_t* mat = elem<N>(r == rf2 - 1 ? o_pre : o_mds);
      group_mont<N, G, TMAX, kSubs<TMAX, 1>::value>(o, pk, pu, n0, [&](int j, uint32_t* acc, uint32_t& hi, int d) {
#pragma unroll
        for (int k = 0; k < TMAX; ++k) {
          uint32_t m[K];
          words_if<K>(m, mat + (j * t + k) * N + d * K, j < t);
          mac64<K>(acc, hi, s[k], m);
        }
      }, [&](int j, uint32_t* x, uint32_t& cy) {
        uint32_t f[K];
        words_if<K>(f, elem<N>(scalar_fold ? fold : fold + j) + lane * K, j < t && (!scalar_fold || j == 0));
        add_words<K>(x, cy, f);
      });
    }
#pragma unroll
    for (int k = 0; k < TMAX; ++k) {
#pragma unroll
      for (int j = 0; j < K; ++j) s[k][j] = o[k][j];
    }
  }

  if (row < batch) {
    uint32_t* dst = out + row * t * N + lane * K;
#pragma unroll
    for (int k = 0; k < TMAX; ++k) {
      if (k < t) {
#pragma unroll
        for (int j = 0; j < K; ++j) dst[k * N + j] = s[k][j];
      }
    }
  }
}

template <int N, int TMAX, int G>
cudaError_t launch_group(const void* in, void* out, long long batch, int t, int alpha, int full_rounds,
                         int partial_rounds, int n_sparse, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((batch * G + kThreads - 1) / kThreads);
  permute_kernel_group<N, TMAX, G><<<blocks, kThreads, 0, stream>>>(
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
// schedule whose first n_sparse partial rounds are sparse.  `group` is the
// lanes a state: 1 (permute_kernel), or 4 for t <= 3 (permute_kernel_group);
// the outputs are the same.  Returns a
// cudaError_t (0 on success) and does not synchronise.  It may be captured
// into a CUDA graph (the bank's load, the launch and the event's wait and
// record become the graph's nodes), provided `image` outlives the graph.
extern "C" int poseidon_permute(const void* in, void* out, const void* image, long long image_words,
                                long long batch, int nwords, int t, int alpha, int full_rounds,
                                int partial_rounds, int n_sparse, int group, int device, void* stream) {
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
  if (group != 1 && !((w8t3 || w12t3) && group == 4)) return cudaErrorInvalidValue;

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
  if (w8t3 && group == 4) {
    err = launch_group<8, 3, 4>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  } else if (w8t3) {
    err = launch<8, 3, 3>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  } else if (w8t9) {
    err = launch<8, 9, 1>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  } else if (group == 4) {
    err = launch_group<12, 3, 4>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  } else {
    err = launch<12, 3, 3>(in, out, batch, t, alpha, full_rounds, partial_rounds, n_sparse, s);
  }
  if (err != cudaSuccess) return err;
  return cudaEventRecordWithFlags(free_ev, s, captured ? cudaEventRecordExternal : cudaEventRecordDefault);
}

// Blocks of the one-thread kernel (permute_kernel) that one SM of `device`
// holds at once, for states of nwords words and t elements, into *blocks:
// its registers decide.  With the SM count it gives the batch at which a
// launch fills the card.  Returns a cudaError_t.
extern "C" int poseidon_permute_blocks_per_sm(int nwords, int t, int device, int* blocks) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nwords == 8 && t <= 3) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, permute_kernel<8, 3, 3>, kThreads, 0);
  }
  if (nwords == 8 && t <= 9) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, permute_kernel<8, 9, 1>, kThreads, 0);
  }
  if (nwords == 12 && t <= 3) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, permute_kernel<12, 3, 3>, kThreads, 0);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
