// Kernel A: AES-256-CTR keystream, one CTA per lane.
//
// Replaces the fused bitsliced Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/aes_fused.py: _kernel, launched by _run) and
// the XLA key-schedule companions (aesv.expand_keys_packed_xp,
// rk_masks_from_packed): the key expands inside the kernel.
//
// TABLE-BASED, NOT CONSTANT-TIME.  Rounds look up four 1 KB T-tables in
// shared memory, indexed by secret-dependent bytes.  The TPU kernel is
// bitsliced and its timing does not depend on the data; this one's shared
// memory bank conflicts do.  A bitsliced variant is listed in ROADMAP.md.
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

#include "pvac_kernels.h"

namespace {

__constant__ uint8_t c_sbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t ror32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__global__ void __launch_bounds__(kThreads)
aes_ctr_kernel(const uint8_t* __restrict__ keys,
               const uint32_t* __restrict__ nlo,
               const uint32_t* __restrict__ nhi, uint4* __restrict__ out,
               int n_blocks) {
  __shared__ uint32_t T0[256], T1[256], T2[256], T3[256];
  __shared__ uint32_t S[256];
  __shared__ uint32_t rk[60];
  const int lane = blockIdx.x;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t s = c_sbox[i];
    uint32_t s2 = ((s << 1) ^ ((s & 0x80) ? 0x1b : 0)) & 0xff;
    uint32_t t = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
    T0[i] = t;
    T1[i] = ror32(t, 8);
    T2[i] = ror32(t, 16);
    T3[i] = ror32(t, 24);
    S[i] = s;
  }
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
        t = (t << 8) | (t >> 24);
        t = (S[t >> 24] << 24) | (S[(t >> 16) & 0xff] << 16) |
            (S[(t >> 8) & 0xff] << 8) | S[t & 0xff];
        t ^= rcon << 24;
        rcon <<= 1;
      } else if (i % 8 == 4) {
        t = (S[t >> 24] << 24) | (S[(t >> 16) & 0xff] << 16) |
            (S[(t >> 8) & 0xff] << 8) | S[t & 0xff];
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
    uint32_t s0 = bswap32(clo) ^ rk[0];
    uint32_t s1 = bswap32(chi) ^ rk[1];
    uint32_t s2 = rk[2];
    uint32_t s3 = rk[3];
#pragma unroll
    for (int r = 1; r < 14; ++r) {
      const uint32_t t0 = T0[s0 >> 24] ^ T1[(s1 >> 16) & 0xff] ^
                          T2[(s2 >> 8) & 0xff] ^ T3[s3 & 0xff] ^ rk[4 * r];
      const uint32_t t1 = T0[s1 >> 24] ^ T1[(s2 >> 16) & 0xff] ^
                          T2[(s3 >> 8) & 0xff] ^ T3[s0 & 0xff] ^ rk[4 * r + 1];
      const uint32_t t2 = T0[s2 >> 24] ^ T1[(s3 >> 16) & 0xff] ^
                          T2[(s0 >> 8) & 0xff] ^ T3[s1 & 0xff] ^ rk[4 * r + 2];
      const uint32_t t3 = T0[s3 >> 24] ^ T1[(s0 >> 16) & 0xff] ^
                          T2[(s1 >> 8) & 0xff] ^ T3[s2 & 0xff] ^ rk[4 * r + 3];
      s0 = t0;
      s1 = t1;
      s2 = t2;
      s3 = t3;
    }
    const uint32_t f0 = (S[s0 >> 24] << 24) | (S[(s1 >> 16) & 0xff] << 16) |
                        (S[(s2 >> 8) & 0xff] << 8) | S[s3 & 0xff];
    const uint32_t f1 = (S[s1 >> 24] << 24) | (S[(s2 >> 16) & 0xff] << 16) |
                        (S[(s3 >> 8) & 0xff] << 8) | S[s0 & 0xff];
    const uint32_t f2 = (S[s2 >> 24] << 24) | (S[(s3 >> 16) & 0xff] << 16) |
                        (S[(s0 >> 8) & 0xff] << 8) | S[s1 & 0xff];
    const uint32_t f3 = (S[s3 >> 24] << 24) | (S[(s0 >> 16) & 0xff] << 16) |
                        (S[(s1 >> 8) & 0xff] << 8) | S[s2 & 0xff];
    dst[b] = make_uint4(bswap32(f0 ^ rk[56]), bswap32(f1 ^ rk[57]),
                        bswap32(f2 ^ rk[58]), bswap32(f3 ^ rk[59]));
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
