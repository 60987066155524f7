// The curve tier's windowed variable-base product on a twisted-Edwards curve:
// a batch of points in extended coordinates (X, Y, T, Z), each times its own
// scalar given as bits, one CUDA thread per row.
//
// Replaces no TPU kernel: the JAX package runs the product in plain XLA
// (ops/curve_rns.py te_scalar_mul_bits_windowed_rns), and the port's plain
// version (ops/windowed_kernel.py te_windowed_plain, ops/curve_fast.py
// windowed_digits) runs it in plain PyTorch: 324 complete additions at
// w = 4 and 251 bits, each about 728 small launches, 231,158 device ops a
// product of 2^16 rows that the host cannot issue faster than about 19 us
// each.  This kernel takes the same schedule in one launch.  Each thread
//   1. stores the 16 multiples 0, P, 2P, ..., 15P of its point in a scratch
//      table (14 complete additions, each entry P plus the one before),
//   2. starts from the entry that the most significant window of its bits
//      selects, and
//   3. for each lower window, from the top down, doubles 4 times and adds
//      the entry that the window selects,
// every addition and doubling by add-2008-hwcd (11 Montgomery products on
// field.cuh, d and a in Montgomery form as kernel parameters), as the plain
// version doubles with the complete addition.  Every field.cuh result is
// fully reduced and the same formula runs in the same order, so the output
// equals the plain version's word for word.
//
// Input (batch, 4, N) points and (batch, nbits) bits of 0 or 1, least
// significant first (a nonzero byte reads as 1); output (batch, 4, N).  The
// scratch table is (16, 4, N / 4, batch) 16-byte vectors: entry e, vector k
// of row r at (e * N + k) * batch + r, so a warp's store of one vector is 32
// neighbouring vectors, 512 contiguous bytes, and each window's gather reads
// 128 bytes a row.  Built for N = 8 (every known twisted-Edwards curve's base
// field) and windows of w = 4 bits.
//
// What bounds it: operations.  At 251 bits a row takes 14 + 62 additions
// and 248 doublings, 3,564 products of N x N words; the least work of the
// same schedule with a dedicated doubling (portbench/roofline/
// a3_curve_windowed.py: 76 additions of 8 products, 248 doublings of 3
// products and 4 squares) is 1.13e6 operations a row, 1.10 ms at 2^16 rows
// on the card's 67e12 operations/s, against 6 us for the point, the scalar
// and the result and 0.2 ms for every table access even from HBM.  So the
// design keeps the products in registers and in a single copy of the
// addition: one loop of 14 + 5 x 62 steps, each step one inlined addition
// whose second operand is the row's point (the table's build), the
// accumulator itself (a doubling) or a table entry (a window's addition),
// chosen by a branch that every thread of a warp takes alike.  The table
// lives in device memory: 2 KB a row fits neither in registers nor, at more
// than a few warps an SM, in shared memory.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kW = 4;              // bits a window
constexpr int kEntries = 1 << kW;  // multiples in the table

template <int N>
struct WindowedParams {
  uint32_t p[N];    // the modulus
  uint32_t d[N];    // the curve's d, Montgomery form
  uint32_t a[N];    // the curve's a, Montgomery form
  uint32_t one[N];  // 1 in Montgomery form: the identity is (0, 1, 0, 1)
  uint32_t n0;      // -p^(-1) mod 2^32
};

// v = N / 4 vectors `stride` vectors apart from q.  Plain loads: the table
// is written by this kernel.
template <int N>
__device__ __forceinline__ void load_vectors(uint32_t* v, const uint4* q, long long stride) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 x = q[k * stride];
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
}

// v = coordinate c of the second operand: the accumulator P itself, or the
// point whose vectors lie `stride` apart from q (the row's point: stride 1;
// a table entry: stride batch).
template <int N>
__device__ __forceinline__ void operand(uint32_t* v, const uint32_t (&P)[4][N], int c, bool self,
                                        const uint4* q, long long stride) {
  if (self) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = P[c][j];
  } else {
    load_vectors<N>(v, q + c * (N / 4) * stride, stride);
  }
}

// P = P + Q by add-2008-hwcd (A2's law, csrc/curve_add.cu):
//   A = X1 X2, B = Y1 Y2, C = d T1 T2, D = Z1 Z2,
//   E = (X1 + Y1)(X2 + Y2) - A - B, F = D - C, G = D + C, H = B - a A,
//   X3 = E F, Y3 = G H, T3 = E H, Z3 = F G.
// P is read in full before any coordinate of it is written, so Q may be P.
template <int N>
__device__ __forceinline__ void add_into(uint32_t (&P)[4][N], bool self, const uint4* q, long long stride,
                                         const WindowedParams<N>& prm) {
  const uint32_t* p = prm.p;
  const uint32_t n0 = prm.n0;
  uint32_t u[N], v[N], w[N], A[N], B[N], C[N], D[N], E[N];
  operand<N>(v, P, 0, self, q, stride);
  mont_mul<N>(A, P[0], v, p, n0);  // A = X1 X2
  operand<N>(w, P, 1, self, q, stride);
  mont_mul<N>(B, P[1], w, p, n0);  // B = Y1 Y2
  mod_add<N>(u, P[0], P[1], p);    // X1 + Y1
  mod_add<N>(v, v, w, p);          // X2 + Y2
  mont_mul<N>(E, u, v, p, n0);
  mod_sub<N>(E, E, A, p);
  mod_sub<N>(E, E, B, p);          // E
  operand<N>(v, P, 2, self, q, stride);
  mont_mul<N>(C, P[2], v, p, n0);
  mont_mul<N>(C, C, prm.d, p, n0);  // C = d T1 T2
  operand<N>(v, P, 3, self, q, stride);
  mont_mul<N>(D, P[3], v, p, n0);  // D = Z1 Z2
  mont_mul<N>(A, A, prm.a, p, n0);
  mod_sub<N>(B, B, A, p);          // H = B - a A
  mod_sub<N>(u, D, C, p);          // F = D - C
  mod_add<N>(v, D, C, p);          // G = D + C
  mont_mul<N>(P[0], E, u, p, n0);  // X3 = E F
  mont_mul<N>(P[1], v, B, p, n0);  // Y3 = G H
  mont_mul<N>(P[2], E, B, p, n0);  // T3 = E H
  mont_mul<N>(P[3], u, v, p, n0);  // Z3 = F G
}

// Entry e of a table whose vectors lie `batch` apart (tab = table + row)
// into P, and P into it; with batch 1, a row's own (4, N) words.
template <int N>
__device__ __forceinline__ void load_entry(uint32_t (&P)[4][N], const uint4* tab, int e, long long batch) {
#pragma unroll
  for (int c = 0; c < 4; ++c) load_vectors<N>(P[c], tab + ((long long)e * N + c * (N / 4)) * batch, batch);
}

template <int N>
__device__ __forceinline__ void store_entry(uint4* tab, int e, const uint32_t (&P)[4][N], long long batch) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      tab[((long long)e * N + c * (N / 4) + k) * batch] =
          make_uint4(P[c][4 * k], P[c][4 * k + 1], P[c][4 * k + 2], P[c][4 * k + 3]);
}

// The value of window g of a row's bits b (bit i of the window weighs 2^i);
// bits at or past nbits read as 0.
__device__ __forceinline__ int window(const uint8_t* b, int g, int nbits) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int j = g * kW + i;
    if (j < nbits) v |= (__ldg(b + j) != 0) << i;
  }
  return v;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
curve_windowed_kernel(const uint32_t* __restrict__ base, const uint8_t* __restrict__ bits, uint4* __restrict__ table,
                      uint32_t* __restrict__ out, const __grid_constant__ WindowedParams<N> prm, long long batch,
                      int nbits) {
  static_assert(N % 4 == 0, "a coordinate is whole 16-byte vectors");
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const uint4* point = reinterpret_cast<const uint4*>(base + row * 4 * N);
  const uint8_t* b = bits + row * nbits;
  uint4* tab = table + row;
  const int G = (nbits + kW - 1) / kW;

  uint32_t P[4][N];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < N; ++j) P[c][j] = (c & 1) ? prm.one[j] : 0u;
  store_entry<N>(tab, 0, P, batch);  // the identity
  load_entry<N>(P, point, 0, 1);
  store_entry<N>(tab, 1, P, batch);  // the point

  // steps 0 .. kEntries - 3 build entries 2 .. kEntries - 1; then each lower
  // window is kW doublings and one addition
  const int build = kEntries - 2;
  const int steps = build + (kW + 1) * (G - 1);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const uint4* q = point;
    long long stride = 1;
    bool self = false;
    if (s >= build) {
      const int t = s - build;
      if (t % (kW + 1) < kW) {
        self = true;
      } else {
        q = tab + (long long)window(b, G - 2 - t / (kW + 1), nbits) * N * batch;
        stride = batch;
      }
    }
    add_into<N>(P, self, q, stride, prm);
    if (s < build) {
      store_entry<N>(tab, s + 2, P, batch);
      if (s == build - 1) load_entry<N>(P, tab, window(b, G - 1, nbits), batch);
    }
  }

  store_entry<N>(reinterpret_cast<uint4*>(out + row * 4 * N), 0, P, 1);
}

template <int N>
cudaError_t launch(const void* base, const void* bits, void* table, void* out, const uint32_t* consts, uint32_t n0,
                   long long batch, int nbits, cudaStream_t stream) {
  WindowedParams<N> prm;
  std::memcpy(prm.p, consts, sizeof(prm.p));
  std::memcpy(prm.d, consts + N, sizeof(prm.d));
  std::memcpy(prm.a, consts + 2 * N, sizeof(prm.a));
  std::memcpy(prm.one, consts + 3 * N, sizeof(prm.one));
  prm.n0 = n0;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  curve_windowed_kernel<N><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(base), static_cast<const uint8_t*>(bits), static_cast<uint4*>(table),
      static_cast<uint32_t*>(out), prm, batch, nbits);
  return cudaGetLastError();
}

}  // namespace

// out[r] = (bits[r] as a scalar) * base[r] for `batch` rows of a
// twisted-Edwards curve, on `stream`.  `base` and `out` are (batch, 4,
// nwords) uint32 on the device, extended (X, Y, T, Z), Montgomery form,
// canonical; `bits` is (batch, nbits) uint8, least significant first;
// `table` is scratch of 16 * 4 * nwords * batch words.  `base`, `table` and
// `out` are 16-byte aligned.  `host_consts` is a HOST array of 4 * nwords
// words: p, then the curve's d, a and 1 in Montgomery form.  Returns a
// cudaError_t (0 on success; invalid value for an nwords or a window the
// kernel is not built for, or nbits < 1) and does not synchronise.
extern "C" int curve_windowed(const void* base, const void* bits, void* table, void* out, const void* host_consts,
                              unsigned int n0, long long batch, int nbits, int nwords, int w, int device,
                              void* stream) {
  if (nwords != 8 || w != kW || nbits < 1) return cudaErrorInvalidValue;
  if (batch <= 0) return cudaSuccess;
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(base) | reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if ((addresses & 15) != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch<8>(base, bits, table, out, static_cast<const uint32_t*>(host_consts), n0, batch, nbits,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
