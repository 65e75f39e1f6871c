// Kernels B and C fused: σ rows from the edges' stream words in one
// persistent, warp-specialised launch, then the noise bits.
//
// Replaces, on the single-card σ path, the two TPU kernels that kernels B
// and C replace one after the other: the Pallas SHA-256-CTR kernel
// (pvac_hfhe_cppbyv_tpu/crypto/sha256_pallas.py: _ctr_kernel) with the XLA
// draw selection around it (crypto/shactr.py:178-219, draws_and_take), and
// the Pallas one-hot noise kernel (crypto/onehot_pallas.py: _kernel) with
// the H gather-XOR that the JAX engine runs in XLA (parallel/engine.py
// _sigma_from_lanes).  It computes what sigma_draws.cu and then sigma.cu
// compute, bit for bit (crypto/sigma_draws.py and crypto/sigma_xor.py state
// the contract); those two stay for a tp rank's block of H's columns.
//
// Why one launch.  The halves are bound by different parts of the SM.  The
// draws are integer work: 2 (1 + 36) = 74 SHA-256 compressions an edge at
// default Params, on the integer pipes.  The row XOR is bound by shared
// memory: each of the 128 slice CTAs gathers 128 random 8-byte slice
// entries an edge, while most of the integer pipes idle.  Run one after the other,
// each leaves the other's pipes idle; here both run at once on every SM.
//
// Bank order.  Slice entry r lies in bank key r mod kKeys, kKeys = 32 / SW
// (16 bank pairs at SW = 2, 32 banks at SW = 1); a lookup instruction of
// kKeys lanes (a half-warp at SW = 2, a warp at SW = 1: kGroup = kKeys / 2
// edges) costs as many wavefronts as the most distinct entries any one key
// holds among its lanes: about three at random rows.  So the producers
// write each edge's taken rows to the ring grouped by bank key, ascending
// (bank_order: a stable warp counting sort by ballots, the zero row after
// the taken ones), and the consumers walk them staggered: of an edge's nq
// = kp / 4 quads of indices, thread h of edge j (j = edge mod kGroup)
// starts at quad (j * max(2, nq / kKeys) + h * off) mod nq and steps 2
// quads mod nq, off = (nq / 2) | 1 for even nq (so thread 1 walks the
// other parity) and 1 for odd nq (the rest of thread 0's cycle).  At
// default Params (kp = 128, nq = 32, SW = 2, 8 rows a key on average) the
// 16 lanes of a half-warp start at keys j and j + 8, j = 0 .. 7, and step
// one key each two quads together; at SW = 1 they start at keys 2j and 2j
// + 17 (mod 32), j = 0 .. 15, and step two keys together.  They meet in
// one key only where an edge's count in some key runs above or below the
// mean.  The index loads stay conflict-free too: rows of kp * 2 = 256
// bytes put thread (j, h) at quad address 2j + h + 2t (mod 16).  The
// order changes when a row is XORed, never which: σ is bit for bit what
// B then C give.  It costs the producers two ballot passes over an edge's
// taken rows beside 74 compressions, inside the launch and ahead of the
// consumers; as a sort pass of its own between B and C it cost a launch,
// a read and a write of every index, more than the gathers saved.
//
// What bounds it: both roles, each close to the other's pace.  On an H100
// at default Params (device ms at 65536 edges): with a quarter of the
// lookups the 8/8 kernel took 1.488 against 1.494, with each counter
// compression replaced by a few integer mixes 0.907, so the draws set its
// pace then.  The draws run in three phases a super-tile, each behind a
// barrier of the producer warps; timed with clock64 at 10/6 they took 15.7%
// (phase 1: the 32 messages and midstates, on one warp while the others
// wait), 51.8% (phase 2: the counters) and 29.7% (phase 3: dedup and bank
// order) of the producers' time, and a super-tile took 42.4 us while the
// consumers, 3.8 us behind, kept pace.  So phase 1 now runs one super-tile
// ahead, on a warp of its own, beside phase 3 on the others (Layout), which
// takes no round of phase 3, and the warp that frees pays for a seventh
// consumer: 1.422 -> 1.316 at 65536 edges, 0.396 -> 0.372 at 16384.  The
// consumers still wait on `ready` (96 ms a launch summed over warps, 107 us
// a warp, 43 of them for the first super-tile), the producers hardly on
// `freed` (0.8 ms).  The gathers are not far behind: producer warps that
// each drew whole edges alone, with no barrier among them, drew a
// super-tile every 37.5 us, the consumers gathered one every 40 and the
// producers waited 314-556 ms on `freed`; the kernel did not get faster
// (1.391-1.430 at 9/7 and 10/6), because the draws run ahead and slow the
// gathers as much, and the first super-tile took 66 us instead of 48.  The
// index stream, 256 B an edge that every slice CTA reads from L2, is
// 2.1 GB at 65536 edges, 1.6 TB/s over the launch.
//
// Layout.  One CTA per H column slice (SW words), as in sigma.cu, or slices
// x groups when the slices are fewer than the SMs.  The grid is launched
// cooperatively, so every CTA is resident and the CTAs may wait on each
// other.  Each CTA holds its slice (128 KB at default Params) and has two
// roles, kPWarps = 9 and kCWarps = 7 warps:
// - producers (warps 0-8) run the three draw phases of sigma_draw.cuh
//   (midstates, counter compressions, warp dedup), as kernel B does, for
//   `chunk` edges of each super-tile (at most kChunk): CTA c of a group
//   draws the super-tile's edges [c chunk, c chunk + chunk), so a
//   super-tile is chunk x slices edges.  Phase 2 of super-tile s runs on
//   all of them; then phase 3 of s on warps 0-7 (32 streams, 4 a warp, as
//   many rounds as on 9 warps) while warp 8 runs phase 1 of s + 1 into the
//   messages and midstates that phase 2 of s no longer reads.  The taken
//   row indices go in bank order to a ring of kRing super-tiles in device
//   memory (2 MB at default Params, so it stays in L2); the noise positions
//   and fallback flags go to device memory whole, as kernel B writes them.
// - consumers (warps 9-15) run kernel C's gather (sigma_gather.cuh), two
//   threads an edge, but each warp walks its own steps of kStep edges of
//   the ring, with its own double buffer of index rows (cp.async) and no
//   barrier among the warps: with a CTA barrier per tile, the warps that
//   met fewer bank conflicts waited for the rest at every tile.
// Each ring slot has two counters per group: producers add one to `ready`
// when their chunk of the slot's super-tile is written; the last consumer
// warp of a CTA to have its share of the super-tile in shared memory adds
// one to `freed`.  Consumers of super-tile s wait until every producer of
// the group is done with it; the producers of super-tile s + kRing wait
// until every CTA is done with s.  So the producers draw ahead while the
// consumers gather, and only the first super-tile's draws are exposed; the
// host halves `chunk` for short launches to keep that fill short.  The
// producers synchronise on a named barrier of their own, three times a
// super-tile; no __syncthreads.  Each launch also sums, over warps, the
// nanoseconds (%globaltimer) that consumers waited on `ready` and
// producers on `freed` into two u64 words after the counters, which only
// crypto/sigma_fused.sigma_rows_fused_waits reads.
// Then sigma_noise_kernel (sigma_gather.cuh) flips the noise bits, bit_lo 0.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"
#include "sigma_draw.cuh"
#include "sigma_gather.cuh"

namespace {

constexpr int kChunk = 16;                    // most edges a CTA draws per super-tile
// The split of the 16 warps between the roles.  Nine producers run phase 2
// in 4 full rounds (1152 counter compressions of 16 edges) and phase 3 on
// eight of them in 4 (32 streams), as ten did, so the seventh consumer
// warp costs the draws nothing.  Device ms of the kernel at 16384 / 65536
// edges of default Params on an H100 (700 W), split as producers/consumers:
// 8/8 0.388 / 1.405, 9/7 0.372 / 1.316, 10/6 0.389 / 1.379, 11/5 0.423 /
// 1.524; phase 1 inline, 10/6, as before: 0.396 / 1.422.
constexpr int kPWarps = 9;                    // producer warps
constexpr int kPThreads = 32 * kPWarps;
constexpr int kWalkWarps = kPWarps - 1;       // phase 3's; the last warp builds messages
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kStreams = 2 * kChunk;
constexpr int kCWarps = 7;                    // consumer warps
constexpr int kCThreads = 32 * kCWarps;
constexpr int kPerEdge = 2;                   // consumer threads per edge
constexpr int kStep = 32 / kPerEdge;          // edges a consumer warp takes at once
constexpr int kThreads = kPThreads + kCThreads;
constexpr int kRing = 4;                      // super-tiles of indices in flight
constexpr int kBarP = 1, kBarC = 2;           // named barriers of the two roles

__device__ __forceinline__ void bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Spins until *p >= want.  A launch waits a few super-tiles at most; a wait
// of seconds means the grid is not all resident, and the kernel traps
// rather than hang the card.
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned want) {
  unsigned v;
  for (long long spins = 0;; ++spins) {
    asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    if (v >= want) return;
    if (spins > (1ll << 26)) __trap();
    __nanosleep(32);
  }
}
__device__ __forceinline__ void signal_count(unsigned* p) {
  __threadfence();
  atomicAdd(p, 1u);
}
// wait_count, its nanoseconds (%globaltimer) added to ns.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void timed_wait(const unsigned* p, unsigned want,
                                           unsigned long long& ns) {
  const unsigned long long t0 = global_ns();
  wait_count(p, want);
  ns += global_ns() - t0;
}

// The producers' shared memory (kernel B's CTA) after the slice and
// the consumers' index rows.
struct DrawSmem {
  uint32_t* msg;     // [kStreams][msg_words]
  uint32_t* mid;     // [kStreams][8]
  uint32_t* bitmap;  // [kWalkWarps][bm_words]
  uint32_t* flag;    // [kChunk]
  uint16_t* vals;    // [kStreams][dstride]
  uint16_t* taken;   // [kWalkWarps][kp]: a warp's taken rows, in draw order
};

// The n taken rows tk (draw order) of one edge to its ring row, by the 32
// lanes of a warp: grouped by bank key x mod kKeys (kKeys = 32 / SW, the
// banks a row's slice entry may lie in) in ascending order, in draw order
// within a key, then the zero row N up to kp.  A stable counting sort: the
// key's bits by ballot give every lane the mask of lanes that share any
// key; lane k < kKeys counts key k's rows, a warp scan turns the counts
// into first columns, and each row goes to its key's column plus the rows
// of its key in lanes below it.
template <int SW, typename IDX>
__device__ void bank_order(const uint16_t* tk, int n, IDX* __restrict__ row, int kp,
                           uint32_t N, int lane) {
  constexpr int kBits = SW == 2 ? 4 : 5, kKeys = 1 << kBits;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t bits[kBits], live;
  auto ballots = [&](int c) {
    const bool valid = c + lane < n;
    const uint32_t key = valid ? tk[c + lane] & (kKeys - 1) : 0u;
    live = __ballot_sync(0xFFFFFFFFu, valid);
#pragma unroll
    for (int b = 0; b < kBits; ++b) bits[b] = __ballot_sync(0xFFFFFFFFu, (key >> b) & 1u);
    return key;
  };
  auto with_key = [&](uint32_t key) {  // the live lanes whose row has this key
    uint32_t m = live;
#pragma unroll
    for (int b = 0; b < kBits; ++b) m &= (key >> b) & 1u ? bits[b] : ~bits[b];
    return m;
  };
  __syncwarp();
  int n_key = 0;  // lane k < kKeys: rows of key k
  for (int c = 0; c < n; c += 32) {
    ballots(c);
    n_key += __popc(with_key((uint32_t)lane & (kKeys - 1)));
  }
  if (lane >= kKeys) n_key = 0;
  int col = n_key;  // then the first column of key `lane`, by an exclusive scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, col, d);
    if (lane >= d) col += v;
  }
  col -= n_key;
  for (int c = 0; c < n; c += 32) {
    const uint32_t key = ballots(c);
    const int at = __shfl_sync(0xFFFFFFFFu, col, (int)key) + __popc(with_key(key) & below);
    if (c + lane < n) row[at] = (IDX)tk[c + lane];
    col += __popc(with_key((uint32_t)lane & (kKeys - 1)));
  }
  for (int i = n + lane; i < kp; i += 32) row[i] = (IDX)N;
}

// Where draw_firsts puts a producer warp's first occurrences: the taken
// rows wait in the warp's shared memory (tk) for bank_order, which writes
// them to the edge's ring row; the noise positions go to nbit whole.
template <int SW, typename IDX, typename NIDX>
struct RingSink {
  uint16_t* tk;
  IDX* ring_rows;
  int kp;
  NIDX* nbit;
  int e0;
  __device__ __forceinline__ void row(int e, int k, int rank, int x) { tk[rank] = (uint16_t)x; }
  __device__ __forceinline__ void rows_end(int e, int k, int n, uint32_t N, int lane) {
    bank_order<SW>(tk, n, ring_rows + (size_t)e * kp, kp, N, lane);
  }
  __device__ __forceinline__ void noise(int e, int D, int j, int v) {
    nbit[(size_t)(e0 + e) * D + j] = (NIDX)v;
  }
};

template <typename IDX, typename NIDX, int SW>
__global__ void __launch_bounds__(kThreads, 1)
sigma_slices_kernel(const uint32_t* __restrict__ Hx, int n_rows, int mw,
                    const uint32_t* __restrict__ lanes, int n_edges, int n_words,
                    Streams P, int msg_words, int dstride, int bm_words,
                    IDX* __restrict__ ring, int kp, int chunk, int per_group,
                    NIDX* __restrict__ nbit, uint8_t* __restrict__ fb,
                    unsigned* __restrict__ sync, uint32_t* __restrict__ out) {
  using Sl = Slice<SW>;
  using Q = Quad<IDX>;
  constexpr int kKeys = 32 / SW;             // banks a slice entry may lie in
  constexpr int kGroup = kKeys / kPerEdge;   // edges whose lookups share a wavefront
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Stream S[2];
  __shared__ unsigned done[kRing];  // consumer warps done with a slot's super-tiles

  const int n_slices = gridDim.x, c = blockIdx.x, g = blockIdx.y;
  const int g_begin = g * per_group;
  const int g_end = min(n_edges, g_begin + per_group);
  if (g_begin >= g_end) return;  // the whole group: no CTA of it waits
  const int st_edges = chunk * n_slices;
  const int n_super = (g_end - g_begin + st_edges - 1) / st_edges;
  unsigned* ready = sync + (size_t)g * 2 * kRing;
  unsigned* freed = ready + kRing;
  IDX* gring = ring + (size_t)g * kRing * st_edges * kp;
  unsigned long long* waits =
      reinterpret_cast<unsigned long long*>(sync + (size_t)gridDim.y * 2 * kRing);

  const size_t slice_bytes = ((size_t)n_rows * SW * 4 + 15) & ~(size_t)15;
  const int row_bytes = kp * (int)sizeof(IDX);
  unsigned char* cbufs = smem + slice_bytes;  // the consumer warps' index rows
  uint32_t* dsm = reinterpret_cast<uint32_t*>(cbufs + (size_t)kCWarps * 2 * kStep * row_bytes);

  if (threadIdx.x < kPThreads) {
    // ---- producers: the draws of this CTA's chunk of every super-tile
    const int pt = threadIdx.x;
    DrawSmem sm;
    sm.msg = dsm;
    sm.mid = sm.msg + kStreams * msg_words;
    sm.bitmap = sm.mid + kStreams * 8;
    sm.flag = sm.bitmap + kWalkWarps * bm_words;
    sm.vals = reinterpret_cast<uint16_t*>(sm.flag + kChunk);
    sm.taken = sm.vals + kStreams * dstride;
    if (pt == 0) {
      S[0] = P.s[0];
      S[1] = P.s[1];
    }
    for (int i = pt; i < kWalkWarps * bm_words; i += kPThreads) sm.bitmap[i] = 0;
    for (int i = pt; i < kChunk; i += kPThreads) sm.flag[i] = 0;
    // this CTA's chunk of super-tile s: its first edge and its edges
    auto e0_of = [&](int s) { return g_begin + s * st_edges + c * chunk; };
    auto n_of = [&](int s) { return max(0, min(chunk, g_end - e0_of(s))); };
    bar(kBarP, kPThreads);
    draw_midstates<kChunk, kPThreads>(S, pt, lanes, e0_of(0), n_of(0), n_words, sm.msg,
                                      msg_words, sm.mid);
    bar(kBarP, kPThreads);
    unsigned long long freed_ns = 0;
    for (int s = 0; s < n_super; ++s) {
      const int slot = s % kRing, e0 = e0_of(s), n_here = n_of(s);
      draw_counters<kChunk, kPThreads>(S, pt, n_here, sm.msg, msg_words, sm.mid, sm.vals,
                                       dstride, sm.flag);
      if (s >= kRing && pt == 0)  // the slot's last super-tile, gathered by every CTA
        timed_wait(freed + slot, (unsigned)(n_slices * (s / kRing)), freed_ns);
      bar(kBarP, kPThreads);
      if (pt < kWalkThreads) {  // phase 3 of s, the rows to the ring
        RingSink<SW, IDX, NIDX> sink{sm.taken + (pt >> 5) * kp,
                                     gring + ((size_t)slot * st_edges + (size_t)c * chunk) * kp,
                                     kp, nbit, e0};
        draw_firsts<kChunk, kWalkThreads>(S, pt, n_here, sm.vals, dstride, sm.bitmap, bm_words,
                                          sm.flag, sink);
      } else if (s + 1 < n_super) {  // phase 1 of s + 1
        draw_midstates<kChunk, 32>(S, pt - kWalkThreads, lanes, e0_of(s + 1), n_of(s + 1),
                                   n_words, sm.msg, msg_words, sm.mid);
      }
      bar(kBarP, kPThreads);
      if (pt == 0) signal_count(ready + slot);
      for (int e = pt; e < kChunk; e += kPThreads) {
        if (e < n_here) fb[e0 + e] = sm.flag[e] ? 1 : 0;
        sm.flag[e] = 0;
      }
      bar(kBarP, kPThreads);  // the flags are clear before phase 2 sets them
    }
    if (pt == 0 && freed_ns) atomicAdd(waits + 1, freed_ns);
    return;
  }

  // ---- consumers: each warp walks its own steps of kStep edges, with no
  // barrier among the warps after the slice is in
  const int ct = threadIdx.x - kPThreads, cw = ct >> 5, lane = ct & 31;
  typename Sl::T* sl = reinterpret_cast<typename Sl::T*>(smem);
  for (int r = ct; r < n_rows; r += kCThreads)
    cp_async(sl + r, Hx + (size_t)r * mw + (size_t)c * SW, SW * 4);
  if (ct < kRing) done[ct] = 0;
  cp_async_commit();
  cp_async_wait<0>();
  bar(kBarC, kCThreads);

  // step j of super-tile s is its edges [kStep j, kStep j + kStep); warp
  // cw takes the steps j = cw (mod kCWarps)
  auto steps = [&](int s) {
    return (min(st_edges, g_end - g_begin - s * st_edges) + kStep - 1) / kStep;
  };
  auto mine = [&](int s) {  // this warp's steps in super-tile s
    const int n = steps(s);
    return n > cw ? (n - cw + kCWarps - 1) / kCWarps : 0;
  };
  auto next = [&](int& s, int& k) {
    for (++k; s < n_super && k >= mine(s); k = 0) ++s;
  };
  // warps done with each slot's super-tiles; the last of a super-tile's
  // warps to finish frees the slot for every CTA of the group.  A full
  // super-tile has warps_full warps with steps; only the last can be short.
  const int warps_full = min(kCWarps, st_edges / kStep);
  const int chunks_per_row = kp * (int)sizeof(IDX) / 16;
  unsigned char* bufs = cbufs + (size_t)cw * 2 * kStep * row_bytes;
  auto load = [&](int s, int k, int b) {
    const int j = cw + kCWarps * k;
    const int ne = min(kStep, g_end - (g_begin + s * st_edges + j * kStep));
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        gring + ((size_t)(s % kRing) * st_edges + (size_t)j * kStep) * kp);
    unsigned char* buf = bufs + (size_t)b * kStep * row_bytes;
    for (int i = lane; i < ne * chunks_per_row; i += 32) {
      const int e = i / chunks_per_row, p = i % chunks_per_row;
      cp_async(buf + (size_t)e * row_bytes + p * 16, src + (size_t)i * 16, 16);
    }
    cp_async_commit();
  };
  int acquired = -1;
  unsigned long long ready_ns = 0;
  auto acquire = [&](int s) {
    if (s > acquired) {
      if (lane == 0)
        timed_wait(ready + s % kRing, (unsigned)(n_slices * (s / kRing + 1)), ready_ns);
      __syncwarp();
      acquired = s;
    }
  };

  int s = 0, k = -1;
  next(s, k);
  if (s < n_super) {
    acquire(s);
    load(s, k, 0);
  }
  const int el = lane / kPerEdge, h = lane % kPerEdge;
  // the staggered walk (header note): the quad this thread starts at
  const int nq = kp / 4;
  const int off = (nq & 1) ? 1 : (nq / 2) | 1;
  const int q0 = ((el % kGroup) * max(2, nq / kKeys) + h * off) % nq;
  for (int b = 0; s < n_super; b ^= 1) {
    int s2 = s, k2 = k;
    next(s2, k2);
    cp_async_wait<0>();
    __syncwarp();
    if (s2 != s && lane == 0) {
      // this warp's last step of super-tile s is in shared memory
      const int want = (s / kRing) * warps_full + min(kCWarps, steps(s));
      if ((int)atomicAdd(done + s % kRing, 1u) == want - 1) signal_count(freed + s % kRing);
    }
    if (s2 < n_super) {
      acquire(s2);
      load(s2, k2, b ^ 1);
    }
    const int e0 = g_begin + s * st_edges + (cw + kCWarps * k) * kStep;
    const int ne = min(kStep, g_end - e0);
    typename Sl::T acc = Sl::zero();
    if (el < ne) {
      const typename Q::T* row = reinterpret_cast<const typename Q::T*>(
          bufs + ((size_t)b * kStep + el) * row_bytes);
      int q = q0;
#pragma unroll 4
      for (int t = h; t < nq; t += kPerEdge) {
        const typename Q::T v = row[q];
        Sl::x(acc, sl[Q::get(v, 0)]);
        Sl::x(acc, sl[Q::get(v, 1)]);
        Sl::x(acc, sl[Q::get(v, 2)]);
        Sl::x(acc, sl[Q::get(v, 3)]);
        q += 2;
        if (q >= nq) q -= nq;
      }
    }
    for (int m = 1; m < kPerEdge; m <<= 1) acc = Sl::shfl(acc, m);
    if (h == 0 && el < ne)
      *reinterpret_cast<typename Sl::T*>(out + (size_t)(e0 + el) * mw + (size_t)c * SW) = acc;
    __syncwarp();
    s = s2;
    k = k2;
  }
  if (lane == 0 && ready_ns) atomicAdd(waits, ready_ns);
}

// What a launch needs: the kernel instance, its shared memory, and how
// many of its CTAs the card holds at once.
struct Plan {
  const void* fn;
  size_t smem;
  int sw, n_slices, capacity;
  int msg_words, dstride, bm_words;
};

template <typename IDX, typename NIDX>
const void* instance(int sw) {
  return sw == 2 ? (const void*)&sigma_slices_kernel<IDX, NIDX, 2>
                 : (const void*)&sigma_slices_kernel<IDX, NIDX, 1>;
}

cudaError_t make_plan(int device, int n_rows, int mw, int kp, int ridx_bytes, int nbit_bytes,
                      const Streams& P, Plan* pl) {
  int sms = 0, smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int nb = P.s[0].nb > P.s[1].nb ? P.s[0].nb : P.s[1].nb;
  const int dmax = P.s[0].D > P.s[1].D ? P.s[0].D : P.s[1].D;
  const int nmax = (int)(P.s[0].N > P.s[1].N ? P.s[0].N : P.s[1].N);
  pl->msg_words = 16 * nb;
  pl->dstride = (dmax + 1) & ~1;
  pl->bm_words = (nmax + 31) / 32;
  const size_t fixed = (size_t)kCWarps * 2 * kStep * kp * ridx_bytes +
                       4 * (size_t)(kStreams * (pl->msg_words + 8) + kWalkWarps * pl->bm_words +
                                    kChunk) +
                       2 * ((size_t)kStreams * pl->dstride + (size_t)kWalkWarps * kp);
  auto smem_for = [&](int sw) { return (((size_t)n_rows * sw * 4 + 15) & ~(size_t)15) + fixed; };
  pl->sw = (mw % 2 == 0 && smem_for(2) <= (size_t)smem_max) ? 2 : 1;
  pl->smem = smem_for(pl->sw);
  pl->n_slices = mw / pl->sw;
  pl->capacity = 0;
  if (pl->smem > (size_t)smem_max) return cudaSuccess;
  if (ridx_bytes == 2)
    pl->fn = nbit_bytes == 2 ? instance<int16_t, int16_t>(pl->sw) : instance<int16_t, int32_t>(pl->sw);
  else
    pl->fn = nbit_bytes == 2 ? instance<int32_t, int16_t>(pl->sw) : instance<int32_t, int32_t>(pl->sw);
  err = cudaFuncSetAttribute(pl->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl->smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl->fn, kThreads, pl->smem);
  if (err != cudaSuccess) return err;
  pl->capacity = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int pvk_sigma_fused_plan(int device, int n_rows, int mw, int kp, int ridx_bytes,
                                    int nbit_bytes, int n_words, const uint32_t* tmpl, int nb0,
                                    int prefix0, int k0, int N0, int nb1, int prefix1, int k1,
                                    int N1, int overshoot, int* plan) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Streams P;
  if ((ridx_bytes != 2 && ridx_bytes != 4) || (nbit_bytes != 2 && nbit_bytes != 4) ||
      kp < k0 || (kp * ridx_bytes) % 16 != 0 || mw < 1 ||
      !make_streams(tmpl, n_words, nb0, prefix0, k0, N0, nb1, prefix1, k1, N1, overshoot, &P))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  err = make_plan(device, n_rows, mw, kp, ridx_bytes, nbit_bytes, P, &pl);
  if (err != cudaSuccess) return (int)err;
  plan[0] = pl.capacity;
  plan[1] = pl.n_slices;
  plan[2] = kChunk * pl.n_slices;  // edges a super-tile
  plan[3] = kRing;
  return 0;
}

extern "C" int pvk_sigma_fused(int device, void* stream, const uint32_t* Hx, int n_rows, int mw,
                               const uint32_t* lanes, int n_edges, int n_words,
                               const uint32_t* tmpl, int nb0, int prefix0, int k0, int N0,
                               int nb1, int prefix1, int k1, int N1, int overshoot, void* ring,
                               int kp, int ridx_bytes, void* nbit, int nbit_bytes, uint8_t* fb,
                               unsigned* sync, int chunk, int groups, uint32_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Streams P;
  if ((ridx_bytes != 2 && ridx_bytes != 4) || (nbit_bytes != 2 && nbit_bytes != 4) ||
      kp < k0 || (kp * ridx_bytes) % 16 != 0 || mw < 1 || groups < 1 || N0 != n_rows - 1 ||
      chunk < 1 || chunk > kChunk ||
      !make_streams(tmpl, n_words, nb0, prefix0, k0, N0, nb1, prefix1, k1, N1, overshoot, &P))
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  Plan pl;
  err = make_plan(device, n_rows, mw, kp, ridx_bytes, nbit_bytes, P, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.n_slices * groups > pl.capacity) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int st_edges = chunk * pl.n_slices;
  const int n_super = (n_edges + st_edges - 1) / st_edges;
  int per_group = ((n_super + groups - 1) / groups) * st_edges;
  const dim3 grid(pl.n_slices, groups), block(kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {(void*)&Hx,  (void*)&n_rows, (void*)&mw,          (void*)&lanes,
                  (void*)&n_edges, (void*)&n_words, (void*)&P,     (void*)&pl.msg_words,
                  (void*)&pl.dstride, (void*)&pl.bm_words, (void*)&ring, (void*)&kp,
                  (void*)&chunk,      (void*)&per_group, (void*)&nbit, (void*)&fb,     (void*)&sync,
                  (void*)&out};
  err = cudaLaunchCooperativeKernel(pl.fn, grid, block, args, pl.smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_noise(st, nbit, nbit_bytes, P.s[1].D, mw, 0, n_edges, out);
}
