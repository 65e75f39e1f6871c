// Kernel B: SHA-256-CTR stream states, one thread per (lane, counter).
//
// Replaces the Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py: _ctr_kernel, launched by
// _shactr_stream_states), which crypto/shactr.stream_u64s(pallas_sha=True)
// calls for the sigma draw streams.
//
// Thread (lane, ctr) hashes label || le64(word_0) .. le64(word_{n-1}) ||
// le64(ctr) and writes the final 8-word state; the caller reads it as four
// little-endian u64 draws (core/hash.digest_words_to_le_u64_pairs).  The
// message is assembled from a host-built template (label, 0x80 pad, bit
// length) by overlaying the field bytes.
//
// What bounds it: the 64-round compressions (about 2 per thread at the
// scheme's message sizes), integer ALU work; inputs are 56 B per lane and
// the output 32 B per thread.  This first version recompresses the
// counter-free first block for every counter; hoisting that midstate (as
// the TPU kernel does) would halve the work and is left to a later change.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"

namespace {

__constant__ uint32_t c_k[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4;  // messages of up to 4 x 64 bytes

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ void compress(uint32_t st[8], const uint32_t* m) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + c_k[i] + wi;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

__global__ void __launch_bounds__(kThreads)
sha256_ctr_kernel(const uint32_t* __restrict__ tmpl, int n_msg_blocks,
                  int prefix_len, const uint32_t* __restrict__ lanes,
                  int n_lanes, int n_words, int n_refills,
                  uint32_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_lanes * n_refills) return;
  const int lane = (int)(t / n_refills);
  const uint32_t ctr = (uint32_t)(t % n_refills);

  uint32_t m[kMaxBlocks * 16];
  for (int i = 0; i < n_msg_blocks * 16; ++i) m[i] = tmpl[i];
  const uint32_t* lw = lanes + (size_t)lane * n_words * 2;
  for (int f = 0; f <= n_words; ++f) {
    const uint32_t lo = f < n_words ? lw[2 * f] : ctr;
    const uint32_t hi = f < n_words ? lw[2 * f + 1] : 0u;
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = ((j < 4 ? lo : hi) >> (8 * (j & 3))) & 0xffu;
      const int pos = prefix_len + 8 * f + j;
      const int sh = (3 - (pos & 3)) * 8;
      m[pos >> 2] = (m[pos >> 2] & ~(0xffu << sh)) | (byte << sh);
    }
  }

  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  for (int b = 0; b < n_msg_blocks; ++b) compress(st, m + 16 * b);
  uint32_t* dst = out + (size_t)t * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = st[i];
}

}  // namespace

extern "C" int pvk_sha256_ctr(int device, void* stream, const uint32_t* tmpl,
                              int n_msg_blocks, int prefix_len,
                              const uint32_t* lanes, int n_lanes, int n_words,
                              int n_refills, uint32_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_msg_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_lanes * n_refills;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  sha256_ctr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tmpl, n_msg_blocks, prefix_len, lanes, n_lanes, n_words, n_refills, out);
  return (int)cudaGetLastError();
}
