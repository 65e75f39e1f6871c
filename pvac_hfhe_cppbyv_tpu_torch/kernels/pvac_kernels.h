// C interface of the port's hand-written CUDA kernels (sm_90a).
//
// Each entry point launches its kernel on the given stream (a cudaStream_t
// passed as void*), does not synchronise and allocates nothing: the Python
// wrappers (crypto/lpn_ybits.py, crypto/sigma_draws.py, crypto/sigma_xor.py,
// crypto/prf_keys.py, crypto/toep_core.py) allocate every buffer with
// torch and pass raw device pointers.  The return value is cudaGetLastError() right after the
// launch (0 = success).
#pragma once
#include <cstdint>

extern "C" {

// Kernel A: LPN sample bits of prf_R cores.  keys [n_cores, 32] bytes,
// nonce halves nlo/nhi [n_cores], s32 [2 * s_words64] LPN secret words;
// y [n_cores, 4] u32: bit r (r < rows <= 128) is row r's parity of
// AES-256-CTR stream words (r * (s_words64 + 1) + j, j < s_words64) with
// the secret, XOR its Bernoulli(tau_num / tau_den) noise bit; rej
// [n_cores] u8: 1 where a noise draw hit the bounded rejection.  Only
// positions w_lo <= j < w_hi of each row fold, against s32 [2 (w_hi - w_lo)]
// (the secret's words of the window), and the noise word only where noise
// is set, which needs w_hi = s_words64; the whole row is w_lo = 0, w_hi =
// s_words64, noise = 1.
int pvk_lpn_ybits(int device, void* stream, const uint8_t* keys,
                  const uint32_t* nlo, const uint32_t* nhi, const uint32_t* s32,
                  int s_words64, int w_lo, int w_hi, int noise, int rows,
                  int tau_num, int tau_den, int n_cores, uint32_t* y, uint8_t* rej);

// Kernel B: the sigma draws of n_edges edges.  lanes [n_edges, n_words, 2]
// u32 (lo, hi) of the u64 stream words; tmpl, in host memory, the
// big-endian message templates of stream 0 (nb0 <= 4 blocks, label of
// prefix0 bytes) then stream 1 (nb1, prefix1), each for n_words + 1 u64
// fields; the launch copies them into the kernel's parameters.  Stream a draws
// k_a + overshoot values mod N_a (N_a < 2^16) from SHA-256(label_a ||
// le64(words) || le64(ctr)) and takes the first k_a first occurrences.
// ridx [n_edges, k0] (ridx_bytes 2 or 4): stream 0's taken draws in
// order, padded with N0; nbit [n_edges, k1 + overshoot] (nbit_bytes):
// stream 1's taken draws at their positions, -1 elsewhere; fb [n_edges]
// u8: 1 where a draw fails the bounded test or a stream has fewer than
// k_a first occurrences.
int pvk_sigma_draws(int device, void* stream, const uint32_t* lanes,
                    int n_edges, int n_words, const uint32_t* tmpl, int nb0,
                    int prefix0, int k0, int N0, int nb1, int prefix1, int k1,
                    int N1, int overshoot, void* ridx, int ridx_bytes,
                    void* nbit, int nbit_bytes, uint8_t* fb);

// Kernel C: sigma rows.  Hx [n_rows, mw] u32 (H plus a zero row last);
// ridx [n_edges, kp] row indices (int16 or int32: ridx_bytes 2 or 4; kp *
// ridx_bytes a multiple of 16); nbit [n_edges, dn] noise bit positions
// (int16 or int32: nbit_bytes; < 0 for draws not taken); out [n_edges,
// mw] u32: XOR of the indexed rows with the noise bits flipped.  Hx may be
// a block of columns of the whole table, whose first bit is bit_lo of a
// row: a noise bit b flips bit b - bit_lo of the output, and only where
// that lies in [0, 32 mw).  Two launches on the stream: the row XOR, then
// the noise bits.
int pvk_sigma(int device, void* stream, const uint32_t* Hx, int n_rows, int mw,
              const void* ridx, int kp, int ridx_bytes, const void* nbit,
              int dn, int nbit_bytes, int bit_lo, int n_edges, uint32_t* out);

// Kernel D: both AES keys and nonces of n prf_R cores.  seeds [n, 4] u64
// (ztag, nonce_lo, nonce_hi, dom_hash; 16-byte aligned); mid [8] and tail
// [nt * 16] u32, in host memory: the SHA-256 state after the derivation
// message's prefix-only blocks and the big-endian template words of its
// nt <= 2 remaining blocks, whose four u64 fields start at byte fpos
// (a multiple of 4); the launch copies them into the kernel's parameters.
// keys [2, n, 32] bytes (16-byte aligned): SHA-256 of the message with
// fields (ztag, nonce_lo, nonce_hi, dom_hash), then with toep for
// dom_hash; nonces [4, n] u32: the low and high halves of dom_hash ^
// nonce_lo, then of toep ^ dom_hash ^ nonce_lo.
int pvk_prf_keys(int device, void* stream, const int64_t* seeds, int n,
                 const uint32_t* mid, const uint32_t* tail, int nt, int fpos,
                 uint64_t toep, uint8_t* keys, uint32_t* nonces);

// Kernel E: PRF cores from Toeplitz keys and LPN bits.  tkeys
// [n_cores, 32] bytes (16-byte aligned), nonce halves nlo/nhi [n_cores],
// y [n_cores, 4] u32 LPN bits (kernel A); r [n_cores, 4] int64 limbs of
// the nonzero field element: bits 0..126 of the GF(2) product of y with
// the AES-256 block of counter le64(nhi:nlo) || 0^8, canonicalised mod
// 2^127 - 1, 0 mapped to 1.
int pvk_toep_core(int device, void* stream, const uint8_t* tkeys,
                  const uint32_t* nlo, const uint32_t* nhi, const uint32_t* y,
                  int n_cores, int64_t* r);

}  // extern "C"
