// SHA-256 compression of pre-padded messages, one CUDA thread per message.
//
// Replaces sha256_state_pallas (crypto_primitives_tpu/ops/sha256_pallas.py):
// FIPS 180-4 compression of (batch, nblocks, 16) big-endian message words,
// chained over the blocks from the initial state, into (batch, 8) state words.
//
// What bounds it: 32-bit integer operations.  A 64-byte block costs about
// 2,400 adds, rotates and logic operations against 64 bytes read, some 37
// operations per byte, above the card's ratio of integer rate to memory rate.
// So the design keeps everything out of memory: the 16-word schedule window
// and the 8 working words stay in registers, the 64 rounds are unrolled so
// every index into the window is a register name, rotations are single
// funnel shifts, the round constants sit in constant memory (one address per
// round for the whole warp), and a thread reads its block as four 16-byte
// loads.

#include <cstdint>
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

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__global__ void __launch_bounds__(kThreads)
compress_kernel(const uint4* __restrict__ words, uint4* __restrict__ out, long long batch,
                int nblocks) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
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
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      if (r >= 16) {
        // w[r] = s1(w[r-2]) + w[r-7] + s0(w[r-15]) + w[r-16], in a ring of 16
        const uint32_t w15 = w[(r + 1) & 15], w2 = w[(r + 14) & 15];
        w[r & 15] += (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)) + w[(r + 9) & 15] +
                     (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10));
      }
      const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                          kK[r] + w[r & 15];
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
  out[row * 2] = make_uint4(h[0], h[1], h[2], h[3]);
  out[row * 2 + 1] = make_uint4(h[4], h[5], h[6], h[7]);
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

extern "C" const char* cpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
