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
#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4;  // messages of up to 4 x 64 bytes

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

  uint32_t st[8];
  sha256_init(st);
  for (int b = 0; b < n_msg_blocks; ++b) sha256_compress(st, m + 16 * b);
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
