// The σ draws of a CTA's edges, shared by kernel B (sigma_draws.cu) and the
// producer warps of the fused launch (sigma_fused.cu): the two draw streams
// of each edge, from its stream words to its first occurrences, every
// intermediate in shared memory.
//
// Edge e holds n_words u64 stream words and two streams: a = 0 (label
// X_SEED: k0 rows of N0 = n_bits) and a = 1 (label NOISE: k1 bits of
// N1 = m_bits).  Refill c of stream a is the final state of
// SHA-256(label_a || le64(w_0) .. le64(w_{n-1}) || le64(c)), read as four
// little-endian u64 draws (core/hash.digest_words_to_le_u64_pairs); the
// stream has D_a = k_a + overshoot draws in R_a = ceil(D_a / 4) refills.
// Draw x keeps x mod N_a and fails the bounded test when
// x > 2^64 - 1 - ((2^64 - 1) mod N_a).  A draw is taken when its value
// occurs in no earlier draw of its stream and fewer than k_a draws were
// taken before it; a draw that fails the test still takes part, as in the
// twin (crypto/sigma_draws.taken_indices_plain).
//
// Three phases, each a function run by the THREADS threads that draw for a
// CTA's EDGES edges; the caller places its barrier between them.
// 1. draw_midstates: one thread per stream copies the host-built message
//    template (label, 0x80 pad, bit length: core/hash.MsgLayout.template_words,
//    passed in the kernel's parameters) to its message in shared memory,
//    overlays the edge's words and compresses the blocks before the one that
//    holds the counter once: the midstate, hoisted as the TPU kernel hoists
//    it (sha256_pallas.py:197-214).  A stream costs 1 + R compressions, not
//    2 R.
// 2. draw_counters: the n_here (R0 + R1) counter compressions spread evenly
//    over the threads.  Each ORs its counter into the stream's counter
//    block, compresses from the midstate, and keeps its four draws as
//    x mod N (2 B each, N < 2^16) in shared memory, flagging the edge where
//    one fails the bounded test.
// 3. draw_firsts: one warp per stream walks its D draws 32 at a time, in
//    order.  A bitmap of N bits per warp (2 KB at n_bits 16384) answers
//    "seen in an earlier chunk", __match_any_sync "an earlier lane of this
//    chunk holds the same value", and __ballot_sync with __popc gives each
//    first occurrence its rank; the sink takes each stream-0 row at its rank
//    and each stream-1 draw at its position, and the warp then clears the
//    bitmap words its draws touched.  No sort runs, and no SHA state or draw
//    reaches device memory.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "sha256.cuh"

namespace {

constexpr int kMaxBlocks = 4;  // message blocks of a stream

// One of an edge's two draw streams; the same for every edge.
struct Stream {
  uint32_t tmpl[kMaxBlocks * 16];  // big-endian template words, nb * 16 used
  int nb;                   // message blocks
  int fcb;                  // first block that holds the counter
  int prefix;               // label bytes
  int cpos;                 // byte offset of the counter field
  int k, D, R;              // draws taken, drawn, refills
  uint32_t N;               // modulus, < 2^16
  uint32_t lim_lo, lim_hi;  // the largest accepted draw
};

struct Streams {
  Stream s[2];
};

bool make_stream(const uint32_t* tmpl, int nb, int prefix, int n_words, int k, int N,
                 int overshoot, Stream* s) {
  if (nb < 1 || nb > kMaxBlocks || k < 1 || overshoot < 0 || N < 1 || N >= (1 << 16) ||
      prefix < 0)
    return false;
  for (int i = 0; i < nb * 16; ++i) s->tmpl[i] = tmpl[i];
  s->nb = nb;
  s->prefix = prefix;
  s->cpos = prefix + 8 * n_words;
  if (s->cpos + 8 > nb * 64) return false;
  s->fcb = s->cpos / 64;
  s->k = k;
  s->D = k + overshoot;
  s->R = (s->D + 3) / 4;
  s->N = (uint32_t)N;
  const unsigned long long all = ~0ull, lim = all - all % (unsigned long long)N;
  s->lim_lo = (uint32_t)lim;
  s->lim_hi = (uint32_t)(lim >> 32);
  return true;
}

// Both streams of the launch from the host entry point's arguments; false
// where they are out of range.
bool make_streams(const uint32_t* tmpl, int n_words, int nb0, int prefix0, int k0, int N0,
                  int nb1, int prefix1, int k1, int N1, int overshoot, Streams* P) {
  return n_words >= 1 && make_stream(tmpl, nb0, prefix0, n_words, k0, N0, overshoot, &P->s[0]) &&
         make_stream(tmpl + nb0 * 16, nb1, prefix1, n_words, k1, N1, overshoot, &P->s[1]);
}

// 1. messages and midstates of edges [e0, e0 + n_here), one thread per
// stream; stream t = a * EDGES + e.
template <int EDGES, int THREADS>
__device__ __forceinline__ void draw_midstates(const Stream* S, int tid,
                                               const uint32_t* __restrict__ lanes, int e0,
                                               int n_here, int n_words, uint32_t* msg,
                                               int msg_words, uint32_t* mid) {
  for (int t = tid; t < 2 * EDGES; t += THREADS) {
    const int a = t / EDGES, e = t % EDGES;
    if (e >= n_here) continue;
    const Stream& s = S[a];
    uint32_t* m = msg + t * msg_words;
    for (int i = 0; i < s.nb * 16; ++i) m[i] = s.tmpl[i];
    uint8_t* mb = reinterpret_cast<uint8_t*>(m);
    const uint32_t* w = lanes + (size_t)(e0 + e) * n_words * 2;
    for (int f = 0; f < n_words; ++f) {
      const uint32_t lo = w[2 * f], hi = w[2 * f + 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = s.prefix + 8 * f + j;  // message byte, big-endian words
        mb[(q & ~3) | (3 - (q & 3))] = (uint8_t)((j < 4 ? lo : hi) >> (8 * (j & 3)));
      }
    }
    uint32_t st[8];
    sha256_init(st);
    for (int b = 0; b < s.fcb; ++b) sha256_compress(st, m + 16 * b);
#pragma unroll
    for (int i = 0; i < 8; ++i) mid[t * 8 + i] = st[i];
  }
}

// 2. the counter compressions of n_here edges, spread over the threads:
// each stream's draws x mod N to vals[t][j], flag[e] set where a draw fails
// the bounded test.
template <int EDGES, int THREADS>
__device__ __forceinline__ void draw_counters(const Stream* S, int tid, int n_here,
                                              const uint32_t* msg, int msg_words,
                                              const uint32_t* mid, uint16_t* vals, int dstride,
                                              uint32_t* flag) {
  const int tasks0 = n_here * S[0].R;
  const int tasks = tasks0 + n_here * S[1].R;
  for (int t = tid; t < tasks; t += THREADS) {
    const int a = t >= tasks0 ? 1 : 0;
    const Stream& s = S[a];
    const int u = t - a * tasks0;
    const int e = u / s.R, r = u % s.R;
    const int sid = a * EDGES + e;
    uint32_t st[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = mid[sid * 8 + i];
    // le64(r) at byte cpos: bytes r0 r1 r2 r3 0 0 0 0 in big-endian words
    const uint32_t c = bswap32((uint32_t)r);
    const int w0 = s.cpos >> 2, sh = 8 * (s.cpos & 3);
    const uint32_t c0 = c >> sh, c1 = sh ? c << (32 - sh) : 0u;
    const uint32_t* m = msg + sid * msg_words;
    for (int b = s.fcb; b < s.nb; ++b) {
      uint32_t blk[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int wi = 16 * b + i;
        blk[i] = m[wi] | (wi == w0 ? c0 : 0u) | (wi == w0 + 1 ? c1 : 0u);
      }
      sha256_compress(st, blk);
    }
    const bool pow2 = (s.N & (s.N - 1)) == 0;
    uint16_t* v = vals + sid * dstride;
    bool bad = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * r + q;
      if (j < s.D) {
        const uint32_t lo = bswap32(st[2 * q]), hi = bswap32(st[2 * q + 1]);
        const unsigned long long x = ((unsigned long long)hi << 32) | lo;
        v[j] = (uint16_t)(pow2 ? lo & (s.N - 1) : (uint32_t)(x % s.N));
        bad |= hi > s.lim_hi || (hi == s.lim_hi && lo > s.lim_lo);
      }
    }
    if (bad) flag[e] = 1;
  }
}

// 3. first occurrences in stream order, one warp per stream, flag[e] set
// where a stream holds fewer than k.  Where the sink takes them:
//   sink.row(e, k, rank, x)      stream 0's taken draw of the given rank;
//   sink.rows_end(e, k, n, N, lane)  after the walk, by every lane, with the
//                                    n = min(first occurrences, k) rows taken;
//   sink.noise(e, D, j, v)       stream 1's draw j: its value if taken, else -1.
template <int EDGES, int THREADS, typename Sink>
__device__ __forceinline__ void draw_firsts(const Stream* S, int tid, int n_here,
                                            const uint16_t* vals, int dstride, uint32_t* bitmap,
                                            int bm_words, uint32_t* flag, Sink& sink) {
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t* bm = bitmap + warp * bm_words;
  for (int sid = warp; sid < 2 * EDGES; sid += THREADS / 32) {
    const int a = sid / EDGES, e = sid % EDGES;
    if (e >= n_here) continue;
    const int k = S[a].k, D = S[a].D;
    const uint32_t N = S[a].N;
    const uint16_t* v = vals + sid * dstride;
    int count = 0;
    for (int c = 0; c < D; c += 32) {
      const int j = c + lane;
      const bool valid = j < D;
      const uint32_t x = valid ? v[j] : 0x10000u;
      const bool seen = valid && ((bm[x >> 5] >> (x & 31)) & 1u);
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, x);
      const bool first = valid && !seen && (peers & below) == 0;
      __syncwarp();
      if (first) atomicOr(&bm[x >> 5], 1u << (x & 31));
      const uint32_t firsts = __ballot_sync(0xFFFFFFFFu, first);
      const int rank = count + __popc(firsts & below);
      const bool take = first && rank < k;
      if (a == 0) {
        if (take) sink.row(e, k, rank, (int)x);
      } else if (valid) {
        sink.noise(e, D, j, take ? (int)x : -1);
      }
      count += __popc(firsts);
      __syncwarp();
    }
    if (a == 0) sink.rows_end(e, k, min(count, k), N, lane);
    if (lane == 0 && count < k) flag[e] = 1;
    for (int j = lane; j < D; j += 32) bm[v[j] >> 5] = 0;
    __syncwarp();
  }
}

}  // namespace
