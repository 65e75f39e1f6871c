// The σ row gather from H column slices in shared memory, shared by kernel
// C (sigma.cu) and the consumer warps of the fused launch (sigma_fused.cu),
// and the noise launch both run after it.
//
// Edge e's row is the XOR of the rows Hx[ridx[e, 0..k)] (the k taken
// draws; a lane with fewer, flagged for the scalar fallback, is padded
// with the all-zero last row of Hx), then bit nbit[e, j] of the row is
// flipped for every noise draw j with nbit[e, j] >= 0.  Taken noise draws
// are unique per edge, so XOR equals OR there, as in the TPU kernel.
//
// Column slice c (SW = 2 words, 8 B, or 1 word where 2 do not fit) of
// every row of Hx fits in one SM's shared memory: 16385 rows x 8 B = 128 KB
// at default Params.  A CTA loads its slice once with cp.async, then its
// threads XOR each edge's slice entries (Slice<SW>), reading the edge's
// indices four to a shared-memory load (Quad<IDX>).
//
// sigma_noise_kernel: one thread per noise draw, one atomicXor into its
// output word.  A tp rank holds a block of H's columns, Hx[:, c0:c1] (the
// JAX engine's P(None, "tp") placement of H), and flips only the noise bits
// that fall into the block's words, bit b at b - bit_lo with bit_lo = 32 c0;
// a bit outside [0, 32 mw) of the block is skipped, so no draw can write
// past a row.  The whole row has bit_lo = 0.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// cp.async of 16, 8 or 4 bytes from device to shared memory (16 bypasses L1).
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An SW-word slice entry: zero, XOR, and the XOR with the lane at distance m.
template <int SW> struct Slice;
template <> struct Slice<1> {
  using T = uint32_t;
  __device__ static T zero() { return 0u; }
  __device__ static void x(T& a, T b) { a ^= b; }
  __device__ static T shfl(T a, int m) { return a ^ __shfl_xor_sync(0xFFFFFFFFu, a, m); }
};
template <> struct Slice<2> {
  using T = uint2;
  __device__ static T zero() { return make_uint2(0u, 0u); }
  __device__ static void x(T& a, T b) {
    a.x ^= b.x;
    a.y ^= b.y;
  }
  __device__ static T shfl(T a, int m) {
    return make_uint2(a.x ^ __shfl_xor_sync(0xFFFFFFFFu, a.x, m),
                      a.y ^ __shfl_xor_sync(0xFFFFFFFFu, a.y, m));
  }
};

// Four indices of one edge in one shared-memory load.
template <typename IDX> struct Quad;
template <> struct Quad<int16_t> {
  using T = uint2;
  __device__ static int get(T q, int i) {
    const uint32_t w = i < 2 ? q.x : q.y;
    return (int)(uint16_t)(w >> (16 * (i & 1)));
  }
};
template <> struct Quad<int32_t> {
  using T = uint4;
  __device__ static int get(T q, int i) {
    return (int)(i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w);
  }
};

template <typename IDX>
__global__ void sigma_noise_kernel(const IDX* __restrict__ nbit, long long total, int dn,
                                   int mw, int bit_lo, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = (int)nbit[i];
  if (b < 0) return;  // a draw not taken
  const int k = b - bit_lo;
  if (k < 0 || k >= 32 * mw) return;  // outside this block of columns
  atomicXor(out + (i / dn) * mw + (k >> 5), 1u << (k & 31));
}

// The noise bits of n_edges rows of mw words, dn draws an edge of
// nbit_bytes each (2 or 4).
cudaError_t launch_noise(cudaStream_t st, const void* nbit, int nbit_bytes, int dn, int mw,
                         int bit_lo, int n_edges, uint32_t* out) {
  const long long total = (long long)n_edges * dn;
  if (total == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((total + 255) / 256);
  if (nbit_bytes == 2)
    sigma_noise_kernel<int16_t><<<grid, 256, 0, st>>>(static_cast<const int16_t*>(nbit),
                                                      total, dn, mw, bit_lo, out);
  else
    sigma_noise_kernel<int32_t><<<grid, 256, 0, st>>>(static_cast<const int32_t*>(nbit),
                                                      total, dn, mw, bit_lo, out);
  return cudaGetLastError();
}

}  // namespace
