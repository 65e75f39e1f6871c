// Kernel A: the LPN sample bits of many prf_R cores, from raw AES-256 keys
// to 127 bits per core in one pass; the keystream never leaves the SM.
//
// Replaces the fused bitsliced Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/aes_fused.py: _kernel, launched by _run) with
// its XLA key-schedule companions, and the parity and noise half of
// lpn.cores_from_streams that reads the keystream it writes.
//
// Core n runs AES-256-CTR under keys[n] from the nonce (nhi:nlo); counter
// block b is le64(nonce + b) || 0^8 and its ciphertext read as two
// little-endian u64s is stream words 2b and 2b+1 (the reference's
// AesCtr256.fill_u64).  With stride t = s_words64 + 1, word w belongs to
// LPN row r = w / t at position j = w % t; rows r >= `rows` are skipped.
// For j < s_words64 the parity of (word & s[j]) flips bit r of y; word
// j = s_words64 is the row's noise draw: bit r flips when
// (lo & (den - 1)) < num, and the core is flagged when the draw would be
// rejected by bounded(den) (hi == 2^32 - 1 and lo >= 2^32 - den), the
// formulas of crypto/lpn_ybits.parity_noise_rows.  Output: y [N, 4] u32
// (bit r at word r / 32, bit r % 32) and rej [N] u8.
//
// Design for Hopper:
// - Persistent CTAs, one per SM, sixteen warps each; one warp per core, the
//   warps striding over the cores, so no CTA-wide barrier sits between
//   cores.
// - Every lane expands its warp's key itself, into registers: the 32
//   lanes run the 52 schedule steps in lockstep, which costs what one
//   lane alone would and needs neither shared round keys nor a barrier.
// - The four T-tables, each replicated across the 32 banks: entry x of
//   copy l of table k is word 32 (256 k + x) + l (128 KB), and lane l
//   reads only copy l, so every table load is one shared-memory cycle
//   whatever the index.  The S-box is byte 1 of T0.  (One table with
//   byte rotations for T1..T3 fits twice in an SM but measured slower in
//   one call: three rotations a round-word add to the integer work.)
// - Lane l encrypts blocks l, l + 32, ... (129 per lane at default
//   Params) and folds each word straight into a private 128-bit
//   accumulator; four __reduce_xor_sync give the warp's y.
//
// NOT BITSLICED: table indices are secret bytes, as in kernel E and unlike
// the TPU kernel.  With each lane on its own table copies the loads meet no
// bank conflicts, so their time no longer varies with the data through
// conflicts; no other data-dependent timing of shared memory is known on
// this card, but the design does not rule one out by construction.
//
// What bounds it: integer work.  An AES-256 block is 224 table loads and
// about 560 integer operations, and a core at default Params needs 4128
// blocks; the inputs are 40 B and the outputs 17 B per core.
#include <cuda_runtime.h>
#include <cstdint>

#include "aes.cuh"
#include "pvac_kernels.h"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTableWords = 4 * 256 * 32;

__device__ __forceinline__ uint32_t t0_entry(uint32_t s) {
  const uint32_t s2 = ((s << 1) ^ ((s & 0x80) ? 0x1b : 0)) & 0xff;
  return (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
}

// Tk[x] from this lane's copy; T points at word `lane` of T0.
template <int K>
__device__ __forceinline__ uint32_t tl(const uint32_t* T, uint32_t x) {
  return T[(256 * K + x) << 5];
}

__device__ __forceinline__ uint32_t ror(uint32_t v, int k) {
  return k == 0 ? v : __funnelshift_r(v, v, 8 * k);
}

// S[a] << 24 | S[b] << 16 | S[c] << 8 | S[d], the S-box being byte 1 of T0.
__device__ __forceinline__ uint32_t sbox4(const uint32_t* T, uint32_t a,
                                          uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t lo = __byte_perm(tl<0>(T, d), tl<0>(T, c), 0x0051);
  const uint32_t hi = __byte_perm(tl<0>(T, b), tl<0>(T, a), 0x0051);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint32_t sub_word(const uint32_t* T, uint32_t x) {
  return sbox4(T, x >> 24, (x >> 16) & 0xff, (x >> 8) & 0xff, x & 0xff);
}

// AES-256 key schedule in the big-endian word convention of crypto/aes.py
// expand_key_256, into registers.
__device__ __forceinline__ void expand_key(const uint32_t* T,
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
      t = sub_word(T, (t << 8) | (t >> 24)) ^ ((1u << (i / 8 - 1)) << 24);
    else if (i % 8 == 4)
      t = sub_word(T, t);
    rk[i] = rk[i - 8] ^ t;
  }
}

// One keystream block: the counter block (clo, chi) under rk; o[0..3] are
// the little-endian u32 words of the ciphertext, as kernel E writes them.
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
    const uint32_t t0 = tl<0>(T, s0 >> 24) ^ tl<1>(T, (s1 >> 16) & 0xff) ^
                        tl<2>(T, (s2 >> 8) & 0xff) ^ tl<3>(T, s3 & 0xff) ^ rk[4 * r];
    const uint32_t t1 = tl<0>(T, s1 >> 24) ^ tl<1>(T, (s2 >> 16) & 0xff) ^
                        tl<2>(T, (s3 >> 8) & 0xff) ^ tl<3>(T, s0 & 0xff) ^ rk[4 * r + 1];
    const uint32_t t2 = tl<0>(T, s2 >> 24) ^ tl<1>(T, (s3 >> 16) & 0xff) ^
                        tl<2>(T, (s0 >> 8) & 0xff) ^ tl<3>(T, s1 & 0xff) ^ rk[4 * r + 2];
    const uint32_t t3 = tl<0>(T, s3 >> 24) ^ tl<1>(T, (s0 >> 16) & 0xff) ^
                        tl<2>(T, (s1 >> 8) & 0xff) ^ tl<3>(T, s2 & 0xff) ^ rk[4 * r + 3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  o[0] = aes_bswap32(sbox4(T, s0 >> 24, (s1 >> 16) & 0xff, (s2 >> 8) & 0xff,
                           s3 & 0xff) ^ rk[56]);
  o[1] = aes_bswap32(sbox4(T, s1 >> 24, (s2 >> 16) & 0xff, (s3 >> 8) & 0xff,
                           s0 & 0xff) ^ rk[57]);
  o[2] = aes_bswap32(sbox4(T, s2 >> 24, (s3 >> 16) & 0xff, (s0 >> 8) & 0xff,
                           s1 & 0xff) ^ rk[58]);
  o[3] = aes_bswap32(sbox4(T, s3 >> 24, (s0 >> 16) & 0xff, (s1 >> 8) & 0xff,
                           s2 & 0xff) ^ rk[59]);
}

struct RowAcc {
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  bool rej = false;

  // Fold stream word (lo, hi) at row r, position j into the accumulator.
  __device__ __forceinline__ void add(uint32_t lo, uint32_t hi, int r, int j,
                                      const uint32_t* s, int sw, int rows,
                                      uint32_t num, uint32_t den) {
    if (r >= rows) return;
    uint32_t bit;
    if (j < sw) {
      bit = (__popc(lo & s[2 * j]) ^ __popc(hi & s[2 * j + 1])) & 1u;
    } else {
      bit = (lo & (den - 1u)) < num ? 1u : 0u;
      rej |= (hi == 0xFFFFFFFFu) && (lo >= 0u - den);
    }
    const uint32_t m = bit << (r & 31);
    const int k = r >> 5;
    a0 ^= k == 0 ? m : 0u;
    a1 ^= k == 1 ? m : 0u;
    a2 ^= k == 2 ? m : 0u;
    a3 ^= k == 3 ? m : 0u;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
lpn_ybits_kernel(const uint8_t* __restrict__ keys,
                 const uint32_t* __restrict__ nlo,
                 const uint32_t* __restrict__ nhi,
                 const uint32_t* __restrict__ s32, int sw, int rows,
                 uint32_t num, uint32_t den, int n_blocks, int n_cores,
                 uint4* __restrict__ y, uint8_t* __restrict__ rej) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;
  uint32_t* s = smem + kTableWords;
  // word 32 (256 k + x) + l: table k = i >> 13, entry x = (i >> 5) & 255
  for (int i = threadIdx.x; i < kTableWords; i += kThreads)
    tab[i] = ror(t0_entry(c_sbox[(i >> 5) & 255]), i >> 13);
  for (int i = threadIdx.x; i < 2 * sw; i += kThreads) s[i] = s32[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const uint32_t* T = tab + lane;
  const int t = sw + 1;
  // a lane's step of 32 blocks is 64 stream words: q rows and rem places
  const int q = 64 / t, rem = 64 % t;
  for (int core = blockIdx.x * kWarps + (threadIdx.x >> 5); core < n_cores;
       core += gridDim.x * kWarps) {
    uint32_t rk[60];
    expand_key(T, keys + (size_t)core * 32, rk);
    const uint32_t lo0 = nlo[core];
    const uint32_t hi0 = nhi[core];
    RowAcc acc;
    int r = (2 * lane) / t, j = (2 * lane) % t;  // place of word 2 * lane
    for (int b = lane; b < n_blocks; b += 32) {
      const uint32_t clo = lo0 + (uint32_t)b;
      const uint32_t chi = hi0 + (clo < lo0 ? 1u : 0u);
      uint32_t o[4];
      aes_block(T, rk, clo, chi, o);
      int r1 = r, j1 = j + 1;
      if (j1 == t) {
        j1 = 0;
        ++r1;
      }
      acc.add(o[0], o[1], r, j, s, sw, rows, num, den);
      acc.add(o[2], o[3], r1, j1, s, sw, rows, num, den);
      r += q;
      j += rem;
      if (j >= t) {
        j -= t;
        ++r;
      }
    }
    const uint32_t y0 = __reduce_xor_sync(0xFFFFFFFFu, acc.a0);
    const uint32_t y1 = __reduce_xor_sync(0xFFFFFFFFu, acc.a1);
    const uint32_t y2 = __reduce_xor_sync(0xFFFFFFFFu, acc.a2);
    const uint32_t y3 = __reduce_xor_sync(0xFFFFFFFFu, acc.a3);
    const bool bad = __any_sync(0xFFFFFFFFu, acc.rej);
    if (lane == 0) {
      y[core] = make_uint4(y0, y1, y2, y3);
      rej[core] = bad ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int pvk_lpn_ybits(int device, void* stream, const uint8_t* keys,
                             const uint32_t* nlo, const uint32_t* nhi,
                             const uint32_t* s32, int s_words64, int rows,
                             int tau_num, int tau_den, int n_cores,
                             uint32_t* y, uint8_t* rej) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_cores == 0) return 0;
  if (rows < 1 || rows > 128 || s_words64 < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = (rows * (s_words64 + 1) + 1) / 2;
  const int want = (n_cores + kWarps - 1) / kWarps;
  const int grid = want < sms ? want : sms;
  const size_t smem = (size_t)(kTableWords + 2 * s_words64) * sizeof(uint32_t);
  err = cudaFuncSetAttribute(lpn_ybits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lpn_ybits_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      keys, nlo, nhi, s32, s_words64, rows, (uint32_t)tau_num,
      (uint32_t)tau_den, n_blocks, n_cores, reinterpret_cast<uint4*>(y), rej);
  return (int)cudaGetLastError();
}
