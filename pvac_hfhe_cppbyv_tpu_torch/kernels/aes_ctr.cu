// Kernel A: AES-256-CTR keystream, one CTA per lane.
//
// Replaces the fused bitsliced Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/aes_fused.py: _kernel, launched by _run) and
// the XLA key-schedule companions (aesv.expand_keys_packed_xp,
// rk_masks_from_packed): the key expands inside the kernel.
//
// TABLE-BASED, NOT CONSTANT-TIME: the rounds (aes.cuh, shared with kernel
// E) look up T-tables in shared memory, indexed by secret-dependent bytes.
// The TPU kernel is bitsliced and its timing does not depend on the data;
// this one's shared memory bank conflicts do.  A bitsliced variant is
// listed in ROADMAP.md.
//
// Counter block b of a lane is le64(nonce + b) || 0^8 (64-bit wrap, carry
// from the low u32 into the high one), the reference's AesCtr256
// (include/pvac/crypto/lpn.hpp:41-149).  Output word w of block b is the
// little-endian u32 of ciphertext bytes 4w..4w+3, so [n_blocks, 4] read as
// u64 pairs is the reference's fill_u64 stream.
//
// What bounds it: about 14 x 16 shared-memory lookups per block; the
// keystream write (16 B per block) is small next to that.  A PRF core
// needs 4128 blocks, so a CTA of 256 threads loops ~16 blocks per thread
// after expanding the key once in shared memory.
#include <cuda_runtime.h>
#include <cstdint>

#include "aes.cuh"
#include "pvac_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aes_ctr_kernel(const uint8_t* __restrict__ keys,
               const uint32_t* __restrict__ nlo,
               const uint32_t* __restrict__ nhi, uint4* __restrict__ out,
               int n_blocks) {
  __shared__ AesTables tab;
  __shared__ uint32_t rk[60];
  const int lane = blockIdx.x;

  aes_fill_tables(tab);
  __syncthreads();

  // AES-256 key schedule, big-endian word convention (crypto/aes.py
  // expand_key_256); 52 dependent steps, done once per lane.
  if (threadIdx.x == 0) {
    const uint8_t* k = keys + (size_t)lane * 32;
    for (int i = 0; i < 8; ++i)
      rk[i] = ((uint32_t)k[4 * i] << 24) | ((uint32_t)k[4 * i + 1] << 16) |
              ((uint32_t)k[4 * i + 2] << 8) | (uint32_t)k[4 * i + 3];
    uint32_t rcon = 1;
    for (int i = 8; i < 60; ++i) {
      uint32_t t = rk[i - 1];
      if (i % 8 == 0) {
        t = aes_sub_word(tab, (t << 8) | (t >> 24)) ^ (rcon << 24);
        rcon <<= 1;
      } else if (i % 8 == 4) {
        t = aes_sub_word(tab, t);
      }
      rk[i] = rk[i - 8] ^ t;
    }
  }
  __syncthreads();

  const uint32_t lo0 = nlo[lane];
  const uint32_t hi0 = nhi[lane];
  uint4* dst = out + (size_t)lane * n_blocks;
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    const uint32_t clo = lo0 + (uint32_t)b;
    const uint32_t chi = hi0 + (clo < lo0 ? 1u : 0u);
    dst[b] = aes_ctr_block(tab, rk, clo, chi);
  }
}

}  // namespace

extern "C" int pvk_aes_ctr(int device, void* stream, const uint8_t* keys,
                           const uint32_t* nlo, const uint32_t* nhi,
                           uint32_t* out, int n_lanes, int n_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0 || n_blocks == 0) return 0;
  aes_ctr_kernel<<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
      keys, nlo, nhi, reinterpret_cast<uint4*>(out), n_blocks);
  return (int)cudaGetLastError();
}
