// Kernel D: SHA-256 of many pre-padded fixed-length messages, one thread
// per message.
//
// Replaces the Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py: _kernel, launched by
// _sha256_fixed_blocks, public sha256_many).  The port runs it for PRF key
// derivation on the card: the AES keys of every prf_R core are
// SHA-256(prf_k || canon_tag || H_digest || ztag || nonce || dom_hash),
// two 64-byte blocks per message (crypto/lpn.derive_keys_device).
//
// Message i is blocks[i, 0..nb-1, 0..15], u32 big-endian words with the
// 0x80 pad byte and the bit length already in place; the output is the
// final state h0..h7 (digest bytes BE(h0) .. BE(h7)).  The TPU kernel pads
// the batch to tiles of 1024 messages; here the grid covers exactly the
// messages there are.
//
// What bounds it: the 64-round compressions, integer ALU work (about 2,000
// instructions per block); a message is 64 B per block in and 32 B out.
// The first block of a derivation message is prefix only for a fixed key
// pair, so its midstate could be hoisted; that is left to a later change.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"
#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sha256_blocks_kernel(const uint32_t* __restrict__ blocks, int n_msgs, int nb,
                     uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_msgs) return;
  const uint32_t* src = blocks + (size_t)i * nb * 16;
  uint32_t st[8];
  sha256_init(st);
  for (int b = 0; b < nb; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = src[16 * b + j];
    sha256_compress(st, m);
  }
  uint32_t* dst = out + (size_t)i * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k] = st[k];
}

}  // namespace

extern "C" int pvk_sha256_blocks(int device, void* stream,
                                 const uint32_t* blocks, int n_msgs, int nb,
                                 uint32_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  if (n_msgs == 0) return 0;
  const unsigned grid = (unsigned)((n_msgs + kThreads - 1) / kThreads);
  sha256_blocks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, n_msgs, nb, out);
  return (int)cudaGetLastError();
}
