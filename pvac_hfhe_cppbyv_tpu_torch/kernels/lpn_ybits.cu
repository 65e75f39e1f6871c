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
// A word window [w_lo, w_hi) of every row (the counterpart of
// lpn.cores_from_streams_tp, crypto/lpn.py:320-357, for one tp rank) folds
// only positions w_lo <= j < w_hi against the secret words s32[2 (j - w_lo)
// ..], and the noise word only where the rank owns it (then w_hi =
// s_words64, so the window stays one run of words).  The ranks' y XOR to
// the whole row's.
//
// Design for Hopper:
// - Persistent CTAs, one per SM, sixteen warps each; one warp per core, the
//   warps striding over the cores, so no CTA-wide barrier sits between
//   cores.
// - Every lane expands its warp's key itself, into registers: the 32
//   lanes run the 52 schedule steps in lockstep, which costs what one
//   lane alone would and needs neither shared round keys nor a barrier.
// - The four T-tables, each replicated across the 32 banks (aes.cuh,
//   shared with kernel E), so every table load is one shared-memory
//   cycle whatever the index.  (One table with byte rotations for T1..T3
//   fits twice in an SM but measured slower in one call: three rotations
//   a round-word add to the integer work.)
// - Lane l encrypts blocks l, l + 32, ... (129 per lane at default
//   Params) and folds each word straight into a private 128-bit
//   accumulator; four __reduce_xor_sync give the warp's y.
// - A window encrypts only the blocks that hold its words: the lanes
//   stride over the (row, block) pairs of the window instead.  The stride t
//   is odd at default Params, so a row starts mid-block every other row and
//   the rows alternate between c0 and c1 blocks; a block that straddles two
//   rows' windows is encrypted once per row, and each pair folds only the
//   words of its own row's window.  The whole row (no window) keeps the
//   walk over all blocks above.
//
// NOT BITSLICED: table indices are secret bytes, as in kernel E and unlike
// the TPU kernel (aes.cuh says what the replicated tables do about it).
//
// What bounds it: integer work.  An AES-256 block is 224 table loads and
// about 560 integer operations, and a core at default Params needs 4128
// blocks; the inputs are 40 B and the outputs 17 B per core.  A window
// needs only the (row, block) pairs that hold its words: 2095 and 2159 at
// tp = 2 (crypto/lpn_ybits.window_blocks).
#include <cuda_runtime.h>
#include <cstdint>

#include "aes.cuh"
#include "pvac_kernels.h"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

struct RowAcc {
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  bool rej = false;

  // Fold stream word (lo, hi) at row r, position j into the accumulator;
  // the secret word of position j is s[2 (j - w_lo)].
  __device__ __forceinline__ void add(uint32_t lo, uint32_t hi, int r, int j,
                                      const uint32_t* s, int w_lo, int sw, int rows,
                                      uint32_t num, uint32_t den) {
    if (r >= rows) return;
    uint32_t bit;
    if (j < sw) {
      const int i = 2 * (j - w_lo);
      bit = (__popc(lo & s[i]) ^ __popc(hi & s[i + 1])) & 1u;
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

// The whole row of every core: lane l walks blocks l, l + 32, ...
__device__ __forceinline__ void fold_all(const uint32_t* T, const uint32_t (&rk)[60],
                                         uint32_t lo0, uint32_t hi0, int lane,
                                         const uint32_t* s, int sw, int rows,
                                         uint32_t num, uint32_t den, int n_blocks,
                                         RowAcc& acc) {
  const int t = sw + 1;
  // a lane's step of 32 blocks is 64 stream words: q rows and rem places
  const int q = 64 / t, rem = 64 % t;
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
    acc.add(o[0], o[1], r, j, s, 0, sw, rows, num, den);
    acc.add(o[2], o[3], r1, j1, s, 0, sw, rows, num, den);
    r += q;
    j += rem;
    if (j >= t) {
      j -= t;
      ++r;
    }
  }
}

// Positions [w_lo, w_end) of every row (w_end = sw + 1 with the noise
// word): lane l walks the window's (row, block) pairs l, l + 32, ...  Row
// r's window starts at word r t + w_lo; it spans c0 blocks where r t is
// even and c1 where it is odd, so pairs come in periods of one row (t
// even) or two rows (t odd).
__device__ __forceinline__ void fold_window(const uint32_t* T, const uint32_t (&rk)[60],
                                            uint32_t lo0, uint32_t hi0, int lane,
                                            const uint32_t* s, int sw, int w_lo,
                                            int w_end, int rows, uint32_t num,
                                            uint32_t den, RowAcc& acc) {
  const int t = sw + 1;
  const int c0 = ((w_end - 1) >> 1) - (w_lo >> 1) + 1;
  const int c1 = (w_end >> 1) - ((w_lo + 1) >> 1) + 1;
  const bool two = t & 1;
  const int period = two ? c0 + c1 : c0;
  const int n_pairs = two ? (rows >> 1) * period + ((rows & 1) ? c0 : 0) : rows * c0;
  // pair p is place m of period q; a lane's step of 32 pairs is dq periods
  // and dm places
  const int dq = 32 / period, dm = 32 % period;
  int q = lane / period, m = lane % period;
  for (int p = lane; p < n_pairs; p += 32) {
    int r = two ? 2 * q : q, off = m;
    if (two && m >= c0) {
      ++r;
      off -= c0;
    }
    const int base = r * t;
    const int b = ((base + w_lo) >> 1) + off;
    const uint32_t clo = lo0 + (uint32_t)b;
    const uint32_t chi = hi0 + (clo < lo0 ? 1u : 0u);
    uint32_t o[4];
    aes_block(T, rk, clo, chi, o);
    const int j = 2 * b - base;  // place of word 2b in row r
    if (j >= w_lo && j < w_end) acc.add(o[0], o[1], r, j, s, w_lo, sw, rows, num, den);
    if (j + 1 >= w_lo && j + 1 < w_end)
      acc.add(o[2], o[3], r, j + 1, s, w_lo, sw, rows, num, den);
    q += dq;
    m += dm;
    if (m >= period) {
      m -= period;
      ++q;
    }
  }
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
lpn_ybits_kernel(const uint8_t* __restrict__ keys,
                 const uint32_t* __restrict__ nlo,
                 const uint32_t* __restrict__ nhi,
                 const uint32_t* __restrict__ s32, int sw, int w_lo, int w_end,
                 int rows, uint32_t num, uint32_t den, int n_blocks, int n_cores,
                 uint4* __restrict__ y, uint8_t* __restrict__ rej) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;
  uint32_t* s = smem + kAesTableWords;
  aes_fill_lane_tables(tab);
  const int n_s = 2 * ((w_end < sw ? w_end : sw) - w_lo);
  for (int i = threadIdx.x; i < n_s; i += kThreads) s[i] = s32[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const uint32_t* T = tab + lane;
  for (int core = blockIdx.x * kWarps + (threadIdx.x >> 5); core < n_cores;
       core += gridDim.x * kWarps) {
    uint32_t rk[60];
    aes_expand_key(T, keys + (size_t)core * 32, rk);
    RowAcc acc;
    if constexpr (kWindow)
      fold_window(T, rk, nlo[core], nhi[core], lane, s, sw, w_lo, w_end, rows, num,
                  den, acc);
    else
      fold_all(T, rk, nlo[core], nhi[core], lane, s, sw, rows, num, den, n_blocks,
               acc);
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
                             const uint32_t* s32, int s_words64, int w_lo, int w_hi,
                             int noise, int rows, int tau_num, int tau_den,
                             int n_cores, uint32_t* y, uint8_t* rej) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_cores == 0) return 0;
  if (rows < 1 || rows > 128 || s_words64 < 1 || w_lo < 0 || w_lo >= w_hi ||
      w_hi > s_words64 || (noise && w_hi != s_words64))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = (rows * (s_words64 + 1) + 1) / 2;
  const int w_end = noise ? s_words64 + 1 : w_hi;
  const bool whole = w_lo == 0 && noise;
  const int want = (n_cores + kWarps - 1) / kWarps;
  const int grid = want < sms ? want : sms;
  const size_t smem = (size_t)(kAesTableWords + 2 * (w_hi - w_lo)) * sizeof(uint32_t);
  auto kernel = whole ? lpn_ybits_kernel<false> : lpn_ybits_kernel<true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      keys, nlo, nhi, s32, s_words64, w_lo, w_end, rows, (uint32_t)tau_num,
      (uint32_t)tau_den, n_blocks, n_cores, reinterpret_cast<uint4*>(y), rej);
  return (int)cudaGetLastError();
}
