// Kernel B: the σ draws of many edges, from their stream words to the
// taken indices in one pass.
//
// Replaces the Pallas SHA-256-CTR kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py: _ctr_kernel, launched at
// :261 by _shactr_stream_states) together with the XLA draw selection
// around it (crypto/shactr.py:178-219, draws_and_take: bounded test,
// x mod N, first-occurrence dedup, take mask) and the port's compaction of
// the taken draws (crypto/sigma_draws.taken_indices_plain).
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
// twin.  Outputs, and nothing else: ridx [E, k0] (the j-th taken draw of
// stream 0 in column j, the zero row N0 after the last), nbit [E, D1]
// (stream 1's taken draws at their stream positions, -1 elsewhere), both
// int16 or int32; fb [E] u8, 1 where a draw of either stream fails the
// bounded test or a stream holds fewer than k_a first occurrences.
//
// Design for Hopper: one CTA of 8 warps per kEdges = 32 edges, in three
// phases separated by barriers, every intermediate in shared memory.
// 1. One thread per stream copies the host-built message template (label,
//    0x80 pad, bit length: core/hash.MsgLayout.template_words, passed in
//    the kernel's parameters) to its message in shared memory, overlays
//    the edge's words and compresses the blocks before the one that holds
//    the counter once: the midstate, hoisted as the TPU kernel hoists it
//    (sha256_pallas.py:197-214).  A stream costs 1 + R compressions, not
//    2 R.
// 2. The CTA's kEdges (R0 + R1) counter compressions spread evenly over
//    its 256 threads.  Each ORs its counter into the stream's counter
//    block, compresses from the midstate, and keeps its four draws as
//    x mod N (2 B each, N < 2^16) in shared memory, flagging the edge
//    where one fails the bounded test.
// 3. One warp per stream walks its D draws 32 at a time, in order.  A
//    bitmap of N bits per warp (2 KB at n_bits 16384) answers "seen in an
//    earlier chunk", __match_any_sync "an earlier lane of this chunk holds
//    the same value", and __ballot_sync with __popc gives each first
//    occurrence its rank; taken values go straight to their column.  The
//    warp then clears the bitmap words its draws touched.
// No sort runs, and no SHA state or draw reaches device memory: an edge
// reads its 56 B of words, and the kernel writes 2 k0 + 2 D1 + 1 B per
// edge (int16 indices).
//
// What bounds it: integer work, 2 (1 + R) compressions of about 1450
// operations per edge (2 x 37 at default Params); the dedup adds a few
// tens of operations a draw.  A CTA takes about 45 KB of shared memory at
// default Params, so several share an SM.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"
#include "sha256.cuh"

namespace {

constexpr int kEdges = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStreams = 2 * kEdges;
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

__device__ __forceinline__ void put_index(void* p, int bytes, size_t i, int v) {
  if (bytes == 2)
    static_cast<int16_t*>(p)[i] = (int16_t)v;
  else
    static_cast<int32_t*>(p)[i] = v;
}

__global__ void __launch_bounds__(kThreads)
sigma_draws_kernel(const uint32_t* __restrict__ lanes, int n_edges,
                   int n_words, Streams P, int msg_words, int dstride,
                   int bm_words, void* __restrict__ ridx, int ridx_bytes,
                   void* __restrict__ nbit, int nbit_bytes,
                   uint8_t* __restrict__ fb) {
  extern __shared__ uint32_t smem[];
  __shared__ Stream S[2];
  uint32_t* msg = smem;                         // [kStreams][msg_words]
  uint32_t* mid = msg + kStreams * msg_words;   // [kStreams][8]
  uint32_t* bitmap = mid + kStreams * 8;        // [kWarps][bm_words]
  uint32_t* flag = bitmap + kWarps * bm_words;  // [kEdges]
  uint16_t* vals = reinterpret_cast<uint16_t*>(flag + kEdges);  // [kStreams][dstride]

  const int e0 = blockIdx.x * kEdges;
  const int n_here = min(kEdges, n_edges - e0);
  if (threadIdx.x == 0) {
    S[0] = P.s[0];
    S[1] = P.s[1];
  }
  for (int i = threadIdx.x; i < kWarps * bm_words; i += kThreads) bitmap[i] = 0;
  for (int i = threadIdx.x; i < kEdges; i += kThreads) flag[i] = 0;
  __syncthreads();

  // 1. messages and midstates, one thread per stream
  for (int t = threadIdx.x; t < kStreams; t += kThreads) {
    const int a = t / kEdges, e = t % kEdges;
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
  __syncthreads();

  // 2. the counter compressions, spread over all threads
  const int tasks0 = kEdges * S[0].R;
  const int tasks = tasks0 + kEdges * S[1].R;
  for (int t = threadIdx.x; t < tasks; t += kThreads) {
    const int a = t >= tasks0 ? 1 : 0;
    const Stream& s = S[a];
    const int u = t - a * tasks0;
    const int e = u / s.R, r = u % s.R;
    if (e >= n_here) continue;
    const int sid = a * kEdges + e;
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
  __syncthreads();

  // 3. first occurrences in stream order, one warp per stream
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t* bm = bitmap + warp * bm_words;
  for (int sid = warp; sid < kStreams; sid += kWarps) {
    const int a = sid / kEdges, e = sid % kEdges;
    if (e >= n_here) continue;
    const int k = S[a].k, D = S[a].D;
    const uint32_t N = S[a].N;
    const uint16_t* v = vals + sid * dstride;
    const size_t ge = (size_t)(e0 + e);
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
        if (take) put_index(ridx, ridx_bytes, ge * k + rank, (int)x);
      } else if (valid) {
        put_index(nbit, nbit_bytes, ge * D + j, take ? (int)x : -1);
      }
      count += __popc(firsts);
      __syncwarp();
    }
    if (a == 0)
      for (int col = min(count, k) + lane; col < k; col += 32)
        put_index(ridx, ridx_bytes, ge * k + col, (int)N);
    if (lane == 0 && count < k) flag[e] = 1;
    for (int j = lane; j < D; j += 32) bm[v[j] >> 5] = 0;
    __syncwarp();
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_here; e += kThreads) fb[e0 + e] = flag[e] ? 1 : 0;
}

bool make_stream(const uint32_t* tmpl, int nb, int prefix, int n_words, int k,
                 int N, int overshoot, Stream* s) {
  if (nb < 1 || nb > kMaxBlocks || k < 1 || overshoot < 0 || N < 1 ||
      N >= (1 << 16) || prefix < 0)
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

}  // namespace

extern "C" int pvk_sigma_draws(int device, void* stream, const uint32_t* lanes,
                               int n_edges, int n_words, const uint32_t* tmpl,
                               int nb0, int prefix0, int k0, int N0, int nb1,
                               int prefix1, int k1, int N1, int overshoot,
                               void* ridx, int ridx_bytes, void* nbit,
                               int nbit_bytes, uint8_t* fb) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Streams P;
  if (n_words < 1 || (ridx_bytes != 2 && ridx_bytes != 4) ||
      (nbit_bytes != 2 && nbit_bytes != 4) ||
      !make_stream(tmpl, nb0, prefix0, n_words, k0, N0, overshoot, &P.s[0]) ||
      !make_stream(tmpl + nb0 * 16, nb1, prefix1, n_words, k1, N1, overshoot, &P.s[1]))
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int msg_words = 16 * (nb0 > nb1 ? nb0 : nb1);
  const int dmax = P.s[0].D > P.s[1].D ? P.s[0].D : P.s[1].D;
  const int dstride = (dmax + 1) & ~1;
  const int nmax = N0 > N1 ? N0 : N1;
  const int bm_words = (nmax + 31) / 32;
  const size_t smem = 4 * (size_t)(kStreams * (msg_words + 8) + kWarps * bm_words + kEdges) +
                      2 * (size_t)kStreams * dstride;
  err = cudaFuncSetAttribute(sigma_draws_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_edges + kEdges - 1) / kEdges);
  sigma_draws_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      lanes, n_edges, n_words, P, msg_words, dstride, bm_words, ridx, ridx_bytes,
      nbit, nbit_bytes, fb);
  return (int)cudaGetLastError();
}
