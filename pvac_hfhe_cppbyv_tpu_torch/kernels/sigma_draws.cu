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
// The streams, the draws and the three phases that take them are in
// sigma_draw.cuh.  Outputs, and nothing else: ridx [E, k0] (the j-th taken
// draw of stream 0 in column j, the zero row N0 after the last), nbit
// [E, D1] (stream 1's taken draws at their stream positions, -1 elsewhere),
// both int16 or int32; fb [E] u8, 1 where a draw of either stream fails the
// bounded test or a stream holds fewer than k_a first occurrences.
//
// Design for Hopper: one CTA of 8 warps per kEdges = 32 edges, the three
// phases separated by barriers, every intermediate in shared memory; taken
// values go straight to their column.  An edge reads its 56 B of words, and
// the kernel writes 2 k0 + 2 D1 + 1 B per edge (int16 indices).
//
// What bounds it: integer work, 2 (1 + R) compressions of about 1450
// operations per edge (2 x 37 at default Params); the dedup adds a few
// tens of operations a draw.  A CTA takes about 45 KB of shared memory at
// default Params, so several share an SM.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"
#include "sigma_draw.cuh"

namespace {

constexpr int kEdges = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStreams = 2 * kEdges;

__device__ __forceinline__ void put_index(void* p, int bytes, size_t i, int v) {
  if (bytes == 2)
    static_cast<int16_t*>(p)[i] = (int16_t)v;
  else
    static_cast<int32_t*>(p)[i] = v;
}

// Where draw_firsts puts the first occurrences: straight to their columns.
struct IndexSink {
  void* ridx;
  int ridx_bytes;
  void* nbit;
  int nbit_bytes;
  int e0;
  __device__ __forceinline__ void row(int e, int k, int rank, int x) {
    put_index(ridx, ridx_bytes, (size_t)(e0 + e) * k + rank, x);
  }
  __device__ __forceinline__ void rows_end(int e, int k, int n, uint32_t N, int lane) {
    for (int col = n + lane; col < k; col += 32)
      put_index(ridx, ridx_bytes, (size_t)(e0 + e) * k + col, (int)N);
  }
  __device__ __forceinline__ void noise(int e, int D, int j, int v) {
    put_index(nbit, nbit_bytes, (size_t)(e0 + e) * D + j, v);
  }
};

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
  draw_midstates<kEdges, kThreads>(S, threadIdx.x, lanes, e0, n_here, n_words, msg, msg_words,
                                   mid);
  __syncthreads();
  draw_counters<kEdges, kThreads>(S, threadIdx.x, n_here, msg, msg_words, mid, vals, dstride,
                                  flag);
  __syncthreads();
  IndexSink sink{ridx, ridx_bytes, nbit, nbit_bytes, e0};
  draw_firsts<kEdges, kThreads>(S, threadIdx.x, n_here, vals, dstride, bitmap, bm_words, flag,
                                sink);
  __syncthreads();
  for (int e = threadIdx.x; e < n_here; e += kThreads) fb[e0 + e] = flag[e] ? 1 : 0;
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
  if ((ridx_bytes != 2 && ridx_bytes != 4) || (nbit_bytes != 2 && nbit_bytes != 4) ||
      !make_streams(tmpl, n_words, nb0, prefix0, k0, N0, nb1, prefix1, k1, N1, overshoot, &P))
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
