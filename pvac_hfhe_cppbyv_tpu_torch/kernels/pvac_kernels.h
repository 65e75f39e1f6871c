// C interface of the port's hand-written CUDA kernels (sm_90a).
//
// Each entry point launches its kernel on the given stream (a cudaStream_t
// passed as void*), does not synchronise and allocates nothing: the Python
// wrappers (crypto/lpn_ybits.py, crypto/aes_ctr.py, crypto/sha256_ctr.py,
// crypto/sigma_xor.py, crypto/sha256_blocks.py) allocate every buffer with
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
// [n_cores] u8: 1 where a noise draw hit the bounded rejection.
int pvk_lpn_ybits(int device, void* stream, const uint8_t* keys,
                  const uint32_t* nlo, const uint32_t* nhi, const uint32_t* s32,
                  int s_words64, int rows, int tau_num, int tau_den,
                  int n_cores, uint32_t* y, uint8_t* rej);

// Kernel B: SHA-256-CTR states.  tmpl [n_msg_blocks * 16] big-endian
// message template (label, padding, length); lanes [n_lanes, n_words, 2]
// u32 (lo, hi) of the u64 stream words; out [n_lanes, n_refills, 8] u32:
// the final state of SHA-256(label || le64(words) || le64(ctr)).
int pvk_sha256_ctr(int device, void* stream, const uint32_t* tmpl,
                   int n_msg_blocks, int prefix_len, const uint32_t* lanes,
                   int n_lanes, int n_words, int n_refills, uint32_t* out);

// Kernel C: sigma rows.  Hx [n_rows, mw] u32 (H plus a zero row last);
// ridx [n_edges, kp] row indices (int16 or int32: ridx_bytes 2 or 4; kp *
// ridx_bytes a multiple of 16); nbit [n_edges, dn] noise bit positions
// (int16 or int32: nbit_bytes; < 0 for draws not taken); out [n_edges,
// mw] u32: XOR of the indexed rows with the noise bits flipped.  Two
// launches on the stream: the row XOR, then the noise bits.
int pvk_sigma(int device, void* stream, const uint32_t* Hx, int n_rows, int mw,
              const void* ridx, int kp, int ridx_bytes, const void* nbit,
              int dn, int nbit_bytes, int n_edges, uint32_t* out);

// Kernel D: SHA-256 of pre-padded messages.  blocks [n_msgs, nb, 16]
// big-endian u32 words (padding and length in place); out [n_msgs, 8] u32:
// the final state h0..h7.
int pvk_sha256_blocks(int device, void* stream, const uint32_t* blocks,
                      int n_msgs, int nb, uint32_t* out);

// Kernel E: AES-256-CTR keystream from expanded keys.  rk [n_lanes, 60]
// round-key words (big-endian word convention), nonce halves nlo/nhi
// [n_lanes]; out [n_lanes, n_blocks, 4] u32: word w of block b is the
// little-endian u32 of ciphertext bytes 4w..4w+3 of counter block
// le64(nonce + b) || 0^8.
int pvk_aes_ctr_rk(int device, void* stream, const uint32_t* rk,
                   const uint32_t* nlo, const uint32_t* nhi, uint32_t* out,
                   int n_lanes, int n_blocks);

}  // extern "C"
