// AES-256 pieces shared by kernels A (lpn_ybits.cu) and E (toep_core.cu):
// the S-box, the key schedule into registers and one block's rounds over
// T-tables replicated once per lane.
//
// The four T-tables live in shared memory with each entry replicated
// across the 32 banks: entry x of copy l of table k is word
// 32 (256 k + x) + l (kAesTableWords words, 128 KB), and lane l reads only
// copy l, so every table load is one shared-memory cycle whatever the
// index.  The S-box is byte 1 of T0.
//
// NOT BITSLICED: table indices are secret bytes, unlike the TPU kernels.
// With each lane on its own table copies the loads meet no bank conflicts,
// so their time does not vary with the data through conflicts; no other
// data-dependent timing of shared memory is known on this card, but the
// design does not rule one out by construction.
//
// Round keys are 60 u32 words in the big-endian word convention of
// crypto/aes.py expand_key_256.  Counter block (clo, chi) is
// le64(chi:clo) || 0^8; output word w is the little-endian u32 of
// ciphertext bytes 4w..4w+3, so a block read as two u64s is the
// reference's AesCtr256.fill_u64 stream (include/pvac/crypto/lpn.hpp).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kAesTableWords = 4 * 256 * 32;

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

__device__ __forceinline__ uint32_t aes_bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// x rotated right by 8 k bits.
__device__ __forceinline__ uint32_t aes_ror8(uint32_t v, int k) {
  return k == 0 ? v : __funnelshift_r(v, v, 8 * k);
}

__device__ __forceinline__ uint32_t aes_t0_entry(uint32_t s) {
  const uint32_t s2 = ((s << 1) ^ ((s & 0x80) ? 0x1b : 0)) & 0xff;
  return (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
}

// Fill the replicated tables (kAesTableWords words of shared memory);
// every thread of the CTA calls this, then __syncthreads().
// Word 32 (256 k + x) + l: table k = i >> 13, entry x = (i >> 5) & 255.
__device__ __forceinline__ void aes_fill_lane_tables(uint32_t* tab) {
  for (int i = threadIdx.x; i < kAesTableWords; i += blockDim.x)
    tab[i] = aes_ror8(aes_t0_entry(c_sbox[(i >> 5) & 255]), i >> 13);
}

// Tk[x] from this lane's copy; T points at word `lane` of T0.
template <int K>
__device__ __forceinline__ uint32_t aes_tl(const uint32_t* T, uint32_t x) {
  return T[(256 * K + x) << 5];
}

// S[a] << 24 | S[b] << 16 | S[c] << 8 | S[d], the S-box being byte 1 of T0.
__device__ __forceinline__ uint32_t aes_sbox4(const uint32_t* T, uint32_t a,
                                              uint32_t b, uint32_t c,
                                              uint32_t d) {
  const uint32_t lo = __byte_perm(aes_tl<0>(T, d), aes_tl<0>(T, c), 0x0051);
  const uint32_t hi = __byte_perm(aes_tl<0>(T, b), aes_tl<0>(T, a), 0x0051);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint32_t aes_sub_word(const uint32_t* T,
                                                 uint32_t x) {
  return aes_sbox4(T, x >> 24, (x >> 16) & 0xff, (x >> 8) & 0xff, x & 0xff);
}

// AES-256 key schedule of a 32-byte key (16-byte aligned), into registers.
__device__ __forceinline__ void aes_expand_key(const uint32_t* T,
                                               const uint8_t* key,
                                               uint32_t (&rk)[60]) {
  const uint4 k0 = reinterpret_cast<const uint4*>(key)[0];
  const uint4 k1 = reinterpret_cast<const uint4*>(key)[1];
  rk[0] = aes_bswap32(k0.x);
  rk[1] = aes_bswap32(k0.y);
  rk[2] = aes_bswap32(k0.z);
  rk[3] = aes_bswap32(k0.w);
  rk[4] = aes_bswap32(k1.x);
  rk[5] = aes_bswap32(k1.y);
  rk[6] = aes_bswap32(k1.z);
  rk[7] = aes_bswap32(k1.w);
#pragma unroll
  for (int i = 8; i < 60; ++i) {
    uint32_t t = rk[i - 1];
    if (i % 8 == 0)
      t = aes_sub_word(T, (t << 8) | (t >> 24)) ^ ((1u << (i / 8 - 1)) << 24);
    else if (i % 8 == 4)
      t = aes_sub_word(T, t);
    rk[i] = rk[i - 8] ^ t;
  }
}

// One keystream block: the counter block (clo, chi) under rk; o[0..3] are
// the little-endian u32 words of the ciphertext.
__device__ __forceinline__ void aes_block(const uint32_t* T,
                                          const uint32_t (&rk)[60],
                                          uint32_t clo, uint32_t chi,
                                          uint32_t (&o)[4]) {
  uint32_t s0 = aes_bswap32(clo) ^ rk[0];
  uint32_t s1 = aes_bswap32(chi) ^ rk[1];
  uint32_t s2 = rk[2];
  uint32_t s3 = rk[3];
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    const uint32_t t0 = aes_tl<0>(T, s0 >> 24) ^ aes_tl<1>(T, (s1 >> 16) & 0xff) ^
                        aes_tl<2>(T, (s2 >> 8) & 0xff) ^ aes_tl<3>(T, s3 & 0xff) ^ rk[4 * r];
    const uint32_t t1 = aes_tl<0>(T, s1 >> 24) ^ aes_tl<1>(T, (s2 >> 16) & 0xff) ^
                        aes_tl<2>(T, (s3 >> 8) & 0xff) ^ aes_tl<3>(T, s0 & 0xff) ^ rk[4 * r + 1];
    const uint32_t t2 = aes_tl<0>(T, s2 >> 24) ^ aes_tl<1>(T, (s3 >> 16) & 0xff) ^
                        aes_tl<2>(T, (s0 >> 8) & 0xff) ^ aes_tl<3>(T, s1 & 0xff) ^ rk[4 * r + 2];
    const uint32_t t3 = aes_tl<0>(T, s3 >> 24) ^ aes_tl<1>(T, (s0 >> 16) & 0xff) ^
                        aes_tl<2>(T, (s1 >> 8) & 0xff) ^ aes_tl<3>(T, s2 & 0xff) ^ rk[4 * r + 3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  o[0] = aes_bswap32(aes_sbox4(T, s0 >> 24, (s1 >> 16) & 0xff, (s2 >> 8) & 0xff,
                               s3 & 0xff) ^ rk[56]);
  o[1] = aes_bswap32(aes_sbox4(T, s1 >> 24, (s2 >> 16) & 0xff, (s3 >> 8) & 0xff,
                               s0 & 0xff) ^ rk[57]);
  o[2] = aes_bswap32(aes_sbox4(T, s2 >> 24, (s3 >> 16) & 0xff, (s0 >> 8) & 0xff,
                               s1 & 0xff) ^ rk[58]);
  o[3] = aes_bswap32(aes_sbox4(T, s3 >> 24, (s0 >> 16) & 0xff, (s1 >> 8) & 0xff,
                               s2 & 0xff) ^ rk[59]);
}

}  // namespace
