// Kernel E: AES-256-CTR keystream from round keys supplied already
// expanded, one thread per (lane, block).
//
// Replaces the per-lane Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/aes_pallas.py: _kernel, launched by
// aes_ctr_keystream_pallas), which the JAX engine's _keystream_words sends
// the one-block Toeplitz stream of every prf_R core to.  Kernel A (one warp
// per core, key expanded in the kernel) suits the 4128-block main stream;
// this kernel spends one thread per block, so 16384 one-block lanes fill
// 64 CTAs.
//
// TABLE-BASED, NOT CONSTANT-TIME: the rounds (aes.cuh) look up T-tables in
// shared memory, indexed by secret-dependent bytes, with data-dependent
// bank conflicts, unlike the bitsliced TPU kernel.
//
// Counter block b of a lane is le64(nonce + b) || 0^8: a 64-bit add, the
// low u32 carrying into the high one and the sum wrapping at 2^64, for any
// number of blocks.
//
// What bounds it: at one block per lane, the 240 B of round keys each
// thread reads (15x the 16 B it writes) and the shared-memory table
// fill of each CTA; the 14 rounds are ~220 table lookups.
#include <cuda_runtime.h>
#include <cstdint>

#include "aes.cuh"
#include "pvac_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aes_ctr_rk_kernel(const uint32_t* __restrict__ rk_all,
                  const uint32_t* __restrict__ nlo,
                  const uint32_t* __restrict__ nhi, uint4* __restrict__ out,
                  long long n_total, int n_blocks) {
  __shared__ AesTables tab;
  aes_fill_tables(tab);
  __syncthreads();

  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_total) return;
  const long long lane = t / n_blocks;
  const uint32_t b = (uint32_t)(t % n_blocks);

  uint32_t rk[60];
  const uint32_t* src = rk_all + lane * 60;
#pragma unroll
  for (int i = 0; i < 60; ++i) rk[i] = src[i];

  const uint32_t lo0 = nlo[lane];
  const uint32_t clo = lo0 + b;
  const uint32_t chi = nhi[lane] + (clo < lo0 ? 1u : 0u);
  out[t] = aes_ctr_block(tab, rk, clo, chi);
}

}  // namespace

extern "C" int pvk_aes_ctr_rk(int device, void* stream, const uint32_t* rk,
                              const uint32_t* nlo, const uint32_t* nhi,
                              uint32_t* out, int n_lanes, int n_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)n_lanes * n_blocks;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  aes_ctr_rk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rk, nlo, nhi, reinterpret_cast<uint4*>(out), n, n_blocks);
  return (int)cudaGetLastError();
}
