// SHA-256 on the card, one CUDA thread per message: two entry points over one
// copy of the rounds.
//
// Replaces sha256_state_pallas (crypto_primitives_tpu/ops/sha256_pallas.py):
//   sha256_digest    (batch, n) message bytes of one length n -> (batch, 32)
//                    digest bytes (FIPS 180-4): the padding, the byte order
//                    and every block's compression in one launch;
//   sha256_compress  (batch, nblocks, 16) pre-padded big-endian words ->
//                    (batch, 8) state words, the TPU kernel's own contract.
//
// What bounds it: 32-bit integer operations.  A 64-byte block costs about
// 2,200 adds, rotates and logic operations against 64 bytes read, some 35
// operations per byte, above the card's ratio of integer rate to memory rate.
// So the design keeps everything out of memory: the 16-word schedule window
// and the 8 working words stay in registers, the 64 rounds are unrolled so
// every index into the window is a register name, rotations are single
// funnel shifts, the round constants sit in constant memory (one address per
// round for the whole warp), a thread reads its message as 16-byte loads where
// the length and the address allow and turns bytes into big-endian words with
// __byte_perm, and the padding is laid in from n in registers, so no padded
// copy of the batch is ever written.  When n is a multiple of 64 the last
// block is the fixed padding block (0x80, zeros, the bit length), whose
// message schedule depends on n alone: its 64 sums K[r] + W[r] are prepared
// once per launch on the host and read from the constant bank, and its 48
// schedule steps are not computed (the 64-byte inner levels of a Merkle tree).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u,
    0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu,
    0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu,
    0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u,
    0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u, 0x90befffau, 0xa4506cebu, 0xbef9a3f7u,
    0xc67178f2u,
};

// K[r] + W[r] of the fixed padding block of an n-byte message (n % 64 == 0)
struct PadBlock {
  uint32_t kw[64];
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0u, 0x0123u); }

__device__ __forceinline__ void init_state(uint32_t* h) {
  h[0] = 0x6a09e667u;
  h[1] = 0xbb67ae85u;
  h[2] = 0x3c6ef372u;
  h[3] = 0xa54ff53au;
  h[4] = 0x510e527fu;
  h[5] = 0x9b05688cu;
  h[6] = 0x1f83d9abu;
  h[7] = 0x5be0cd19u;
}

// The 64 rounds of one block on the state h.  kFixed: the block's K[r] + W[r]
// are given in kw (the fixed padding block).  Otherwise w holds the block's 16
// message words and the schedule runs in place in a ring of 16.
template <bool kFixed>
__device__ __forceinline__ void compress_block(uint32_t* h, uint32_t* w, const uint32_t* kw) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    uint32_t kwr;
    if constexpr (kFixed) {
      kwr = kw[r];
    } else {
      if (r >= 16) {
        // w[r] = s1(w[r-2]) + w[r-7] + s0(w[r-15]) + w[r-16], in a ring of 16
        const uint32_t w15 = w[(r + 1) & 15], w2 = w[(r + 14) & 15];
        w[r & 15] += (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)) + w[(r + 9) & 15] +
                     (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10));
      }
      kwr = kK[r] + w[r & 15];
    }
    const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + kwr;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// The big-endian word at byte o of the padded message m (n bytes, then 0x80,
// then zeros; the length words are laid in by the caller).
__device__ __forceinline__ uint32_t padded_word(const uint8_t* m, int n, int o) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = o + i;
    const uint32_t byte = p < n ? (uint32_t)__ldg(m + p) : (p == n ? 0x80u : 0u);
    v = (v << 8) | byte;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
compress_kernel(const uint4* __restrict__ words, uint4* __restrict__ out, long long batch,
                int nblocks) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;
  uint32_t h[8];
  init_state(h);
  const uint4* msg = words + row * nblocks * 4;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(msg + blk * 4 + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    compress_block<false>(h, w, nullptr);
  }
  out[row * 2] = make_uint4(h[0], h[1], h[2], h[3]);
  out[row * 2 + 1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// kVec: n % 16 == 0 and the batch starts on a 16-byte boundary, so every
// 16 bytes of a message are one aligned load.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
digest_kernel(const uint8_t* __restrict__ msgs, uint4* __restrict__ out, long long batch, int n,
              const __grid_constant__ PadBlock pad) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;
  const uint8_t* m = msgs + row * n;
  // blocks through the schedule: every block holding message bytes, and the
  // padding with them unless it is the fixed block
  const bool fixed_tail = n % 64 == 0;
  const int nblocks = fixed_tail ? n / 64 : (n + 9 + 63) / 64;
  const unsigned long long nbits = 8ull * (unsigned long long)n;
  uint32_t h[8];
  init_state(h);
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = blk * 64 + 16 * q;
      if (kVec && o + 16 <= n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + o));
        w[4 * q] = bswap(v.x);
        w[4 * q + 1] = bswap(v.y);
        w[4 * q + 2] = bswap(v.z);
        w[4 * q + 3] = bswap(v.w);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[4 * q + i] = padded_word(m, n, o + 4 * i);
      }
    }
    if (!fixed_tail && blk == nblocks - 1) {
      w[14] = (uint32_t)(nbits >> 32);
      w[15] = (uint32_t)nbits;
    }
    compress_block<false>(h, w, nullptr);
  }
  if (fixed_tail) compress_block<true>(h, nullptr, pad.kw);
  out[row * 2] = make_uint4(bswap(h[0]), bswap(h[1]), bswap(h[2]), bswap(h[3]));
  out[row * 2 + 1] = make_uint4(bswap(h[4]), bswap(h[5]), bswap(h[6]), bswap(h[7]));
}

}  // namespace

// Compress `batch` messages of `nblocks` 64-byte blocks: `words` is
// (batch, nblocks, 16) uint32, `out` (batch, 8) uint32, both 16-byte aligned.
// Returns a cudaError_t (0 on success) and does not synchronise.
extern "C" int sha256_compress(const void* words, void* out, long long batch, int nblocks,
                               int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (nblocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  compress_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), static_cast<uint4*>(out), batch, nblocks);
  return cudaGetLastError();
}

// SHA-256 digests of `batch` messages of n bytes each: `msgs` is (batch, n)
// uint8 on the device, `out` (batch, 32) uint8, 16-byte aligned.
// `host_pad_kw` is a HOST array of the 64 words K[r] + W[r] of the fixed
// padding block of an n-byte message, read when n % 64 == 0.  Returns a
// cudaError_t (0 on success) and does not synchronise.
extern "C" int sha256_digest(const void* msgs, void* out, long long batch, int n,
                             const void* host_pad_kw, int device, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PadBlock pad;
  std::memcpy(pad.kw, host_pad_kw, sizeof(pad.kw));
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(msgs);
  uint4* o = static_cast<uint4*>(out);
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0) {
    digest_kernel<true><<<blocks, kThreads, 0, s>>>(m, o, batch, n, pad);
  } else {
    digest_kernel<false><<<blocks, kThreads, 0, s>>>(m, o, batch, n, pad);
  }
  return cudaGetLastError();
}

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
