// Kernel D: both AES-256 keys and both nonces of many prf_R cores, from
// each core's raw seed, in one pass.
//
// Replaces the Pallas kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py: _kernel, launched by
// _sha256_fixed_blocks, public sha256_many) together with the XLA message
// build and nonce XORs around it (crypto/lpn.py: derive_keys_xp and the
// engine's prf_program).  Core i with seed (ztag, nonce_lo, nonce_hi) and
// domain hash d has two keys:
//   key   = SHA-256(prefix || le64(ztag) || le64(nonce_lo) || le64(nonce_hi) || le64(d))
//   tkey  = the same message with TOEP (the Toeplitz domain's hash) for d
// where prefix = prf_k || canon_tag || H_digest is fixed per key pair, and
// two nonces, nonce = d ^ nonce_lo and tnonce = TOEP ^ nonce_lo ^ d.
//
// The prefix's whole 64-byte blocks are the same for every message of a
// key pair, so the host compresses them once (crypto/prf_keys.key_msg)
// and passes the state after them, the midstate, in the kernel's
// parameters with the template words of the remaining tail blocks (the
// prefix's last bytes, the 0x80 pad byte and the bit length).  At the
// scheme's 72-byte prefix that is one tail block: one compression per key,
// not two.
//
// Inputs: seeds [n, 4] u64 (ztag, nonce_lo, nonce_hi, d), little-endian.
// Outputs: keys [2, n, 32] bytes (row 0 the main keys, row 1 the Toeplitz
// keys; digest bytes BE(h0) .. BE(h7), the layout kernels A and E read);
// nonces [4, n] u32: nonce's low and high halves, then tnonce's.
//
// Design: one thread per message, grid.y picking the main key (0) or the
// Toeplitz key (1).  A core's two messages share nothing but their seed,
// and at the 16384 cores of a pass one thread per core would fill only
// half the card's 132 SMs with 128-thread CTAs; one per message gives 256
// CTAs.  A thread reads its 32-byte seed (coalesced across the warp),
// copies the tail template from the parameters, writes its four fields as
// big-endian words at the tail's field offset (word-aligned, checked at
// launch) into a per-thread array the compiler keeps in local memory
// (the offset is a launch parameter), compresses from the midstate, and
// writes its 32 key bytes as two 16-byte stores and its two nonce halves.
//
// What bounds it: integer work, one compression of about 1450 operations
// per message (2 n messages); a core moves 32 B in and 64 + 16 B out.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"
#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTail = 2;  // tail blocks after the midstate

// The derivation message of one key pair after its prefix-only blocks.
struct KeyMsg {
  uint32_t mid[8];                 // state after the hoisted blocks
  uint32_t tail[kMaxTail * 16];    // big-endian template words, nt * 16 used
  int nt;                          // tail blocks
  int fw;                          // tail word where the four fields start
  unsigned long long toep;         // the Toeplitz domain's hash
};

__global__ void __launch_bounds__(kThreads)
prf_keys_kernel(const ulonglong2* __restrict__ seeds, int n, KeyMsg P,
                uint8_t* __restrict__ keys, uint32_t* __restrict__ nonces) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;  // 0: the main key, 1: the Toeplitz key
  if (i >= n) return;
  const ulonglong2 s01 = seeds[2 * i], s23 = seeds[2 * i + 1];
  const unsigned long long d = w ? P.toep : s23.y;
  const unsigned long long f[4] = {s01.x, s01.y, s23.x, d};

  uint32_t m[kMaxTail * 16];
#pragma unroll
  for (int j = 0; j < kMaxTail * 16; ++j) m[j] = P.tail[j];
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // le64 at a word-aligned byte: bswap(lo), bswap(hi)
    m[P.fw + 2 * q] = bswap32((uint32_t)f[q]);
    m[P.fw + 2 * q + 1] = bswap32((uint32_t)(f[q] >> 32));
  }
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = P.mid[k];
  for (int b = 0; b < P.nt; ++b) sha256_compress(st, m + 16 * b);

  // byte 4k + j of the key is byte 3 - j of h_k: a little-endian store of bswap(h_k)
  uint4* dst = reinterpret_cast<uint4*>(keys + ((size_t)w * n + i) * 32);
  dst[0] = make_uint4(bswap32(st[0]), bswap32(st[1]), bswap32(st[2]), bswap32(st[3]));
  dst[1] = make_uint4(bswap32(st[4]), bswap32(st[5]), bswap32(st[6]), bswap32(st[7]));
  const unsigned long long nonce = (w ? P.toep ^ s23.y : s23.y) ^ s01.y;
  nonces[(size_t)(2 * w) * n + i] = (uint32_t)nonce;
  nonces[(size_t)(2 * w + 1) * n + i] = (uint32_t)(nonce >> 32);
}

}  // namespace

extern "C" int pvk_prf_keys(int device, void* stream, const int64_t* seeds, int n,
                            const uint32_t* mid, const uint32_t* tail, int nt, int fpos,
                            uint64_t toep, uint8_t* keys, uint32_t* nonces) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the four fields lie in the tail, word-aligned, before the pad byte
  // and the 8-byte length
  if (nt < 1 || nt > kMaxTail || fpos < 0 || fpos % 4 || fpos + 32 + 9 > 64 * nt || n < 0 ||
      reinterpret_cast<uintptr_t>(seeds) % 16 || reinterpret_cast<uintptr_t>(keys) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  KeyMsg P;
  for (int k = 0; k < 8; ++k) P.mid[k] = mid[k];
  for (int j = 0; j < kMaxTail * 16; ++j) P.tail[j] = j < nt * 16 ? tail[j] : 0u;
  P.nt = nt;
  P.fw = fpos / 4;
  P.toep = toep;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), 2);
  prf_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const ulonglong2*>(seeds), n, P, keys, nonces);
  return (int)cudaGetLastError();
}
