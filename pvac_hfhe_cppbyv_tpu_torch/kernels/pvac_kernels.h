// C interface of the port's hand-written CUDA kernels (sm_90a).
//
// Each entry point launches one kernel on the given stream (a cudaStream_t
// passed as void*), does not synchronise and allocates nothing: the Python
// wrappers (crypto/aes_ctr.py, crypto/sha256_ctr.py, crypto/sigma_xor.py,
// crypto/sha256_blocks.py) allocate every buffer with torch and pass raw
// device pointers.  The return value is cudaGetLastError() right after the
// launch (0 = success).
#pragma once
#include <cstdint>

extern "C" {

// Kernel A: AES-256-CTR keystream.  keys [n_lanes, 32] bytes, nonce halves
// nlo/nhi [n_lanes]; out [n_lanes, n_blocks, 4] u32 (word w of block b is
// the little-endian u32 of ciphertext bytes 4w..4w+3 of counter block
// le64(nonce + b) || 0^8).
int pvk_aes_ctr(int device, void* stream, const uint8_t* keys,
                const uint32_t* nlo, const uint32_t* nhi, uint32_t* out,
                int n_lanes, int n_blocks);

// Kernel B: SHA-256-CTR states.  tmpl [n_msg_blocks * 16] big-endian
// message template (label, padding, length); lanes [n_lanes, n_words, 2]
// u32 (lo, hi) of the u64 stream words; out [n_lanes, n_refills, 8] u32:
// the final state of SHA-256(label || le64(words) || le64(ctr)).
int pvk_sha256_ctr(int device, void* stream, const uint32_t* tmpl,
                   int n_msg_blocks, int prefix_len, const uint32_t* lanes,
                   int n_lanes, int n_words, int n_refills, uint32_t* out);

// Kernel C: sigma rows.  Hx [n_rows, mw] u32 (H plus a zero row); cidx
// [n_edges, dc] row indices; nword/nmask [n_edges, dn] noise word index and
// bit mask (0 for draws not taken); out [n_edges, mw] u32.
int pvk_sigma(int device, void* stream, const uint32_t* Hx, int mw,
              const int32_t* cidx, int dc, const int32_t* nword,
              const uint32_t* nmask, int dn, int n_edges, uint32_t* out);

// Kernel D: SHA-256 of pre-padded messages.  blocks [n_msgs, nb, 16]
// big-endian u32 words (padding and length in place); out [n_msgs, 8] u32:
// the final state h0..h7.
int pvk_sha256_blocks(int device, void* stream, const uint32_t* blocks,
                      int n_msgs, int nb, uint32_t* out);

// Kernel E: AES-256-CTR keystream from expanded keys.  rk [n_lanes, 60]
// round-key words (big-endian word convention), nonce halves nlo/nhi
// [n_lanes]; out [n_lanes, n_blocks, 4] u32, the same words as kernel A.
int pvk_aes_ctr_rk(int device, void* stream, const uint32_t* rk,
                   const uint32_t* nlo, const uint32_t* nhi, uint32_t* out,
                   int n_lanes, int n_blocks);

}  // extern "C"
