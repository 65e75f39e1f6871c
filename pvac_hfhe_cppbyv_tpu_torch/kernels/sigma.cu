// Kernel C: σ rows from H column slices held in shared memory, then the
// one-hot noise bits.
//
// Replaces the Pallas one-hot noise kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/onehot_pallas.py: _kernel, via _call and
// onehot_noise_words) and also does the H gather-XOR that the JAX engine
// runs in XLA (parallel/engine.py _sigma_from_lanes).
//
// The row, the slice entries and the noise launch are in sigma_gather.cuh.
//
// Phase 1, sigma_slices_kernel.  One CTA per column slice (128 at default
// Params; the edges split into groups when the slices are fewer than the
// SMs) loads its slice once with cp.async, then walks the launch's edges in
// tiles of kTile: a tile's indices are copied to shared memory with
// cp.async, double-buffered, in rows padded by 16 B so that the lanes of
// a warp, each on its own edge, read their indices from distinct banks.
// Two threads per edge XOR the edge's k slice entries, four indices per
// load, and one of them writes the edge's 8 B of output.
// Phase 2, sigma_noise_kernel (launch_noise).
//
// A tp rank's block of H's columns, Hx[:, c0:c1]: phase 1 runs on the
// narrower table as it is, and phase 2 takes bit_lo = 32 c0.
//
// What bounds it: shared memory and L2, not the 0.5 G XORs.  The gathers
// are E * k random slice entries per CTA, and the 16 lanes of a half-warp
// reading 8 B at random rows meet bank conflicts; every slice CTA also
// reads all E * k * 2 B of indices from L2 (512 MB in all at 16384
// edges).  H (16 MB) is read from device memory once.  Sharing each index
// tile across a thread-block cluster by multicast does not pay here: at
// one 200 KB CTA per SM, clusters wider than 2 cannot all be resident at
// once, and the mbarrier hand-offs of a pair cost more than half the
// index reads save.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"
#include "sigma_gather.cuh"

namespace {

constexpr int kTile = 128;              // edges per index tile
constexpr int kThreads = 2 * kTile;     // two threads per edge
constexpr int kPad = 16;                // bytes after each tile row

template <typename IDX, int SW>
__global__ void __launch_bounds__(kThreads)
sigma_slices_kernel(const uint32_t* __restrict__ Hx, int n_rows, int mw,
                    const IDX* __restrict__ ridx, int kp, int n_edges,
                    int edges_per_group, uint32_t* __restrict__ out) {
  using S = Slice<SW>;
  using Q = Quad<IDX>;
  extern __shared__ __align__(16) unsigned char sm[];
  const size_t slice_bytes = ((size_t)n_rows * SW * 4 + 15) & ~(size_t)15;
  typename S::T* sl = reinterpret_cast<typename S::T*>(sm);
  const int row_bytes = kp * (int)sizeof(IDX) + kPad;
  unsigned char* tiles = sm + slice_bytes;

  const int c = blockIdx.x;
  const int e_begin = blockIdx.y * edges_per_group;
  const int e_end = min(n_edges, e_begin + edges_per_group);
  if (e_begin >= e_end) return;
  const int n_tiles = (e_end - e_begin + kTile - 1) / kTile;

  for (int r = threadIdx.x; r < n_rows; r += kThreads)
    cp_async(sl + r, Hx + (size_t)r * mw + (size_t)c * SW, SW * 4);

  const int chunks_per_row = kp * (int)sizeof(IDX) / 16;
  auto load_tile = [&](int it) {
    unsigned char* buf = tiles + (size_t)(it & 1) * kTile * row_bytes;
    const int e0 = e_begin + it * kTile;
    const int ne = min(kTile, e_end - e0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(ridx + (size_t)e0 * kp);
    for (int i = threadIdx.x; i < ne * chunks_per_row; i += kThreads) {
      const int e = i / chunks_per_row, p = i % chunks_per_row;
      cp_async(buf + (size_t)e * row_bytes + p * 16, src + (size_t)i * 16, 16);
    }
  };
  load_tile(0);
  cp_async_commit();

  const int el = threadIdx.x >> 1, h = threadIdx.x & 1;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int e = e_begin + it * kTile + el;
    typename S::T acc = S::zero();
    if (e < e_end) {
      // thread h takes quads h, h + 2, ...: with rows padded by 16 B the
      // 16 lanes of a half-warp read 16 distinct bank pairs
      const typename Q::T* row = reinterpret_cast<const typename Q::T*>(
          tiles + (size_t)(it & 1) * kTile * row_bytes + (size_t)el * row_bytes);
#pragma unroll 4
      for (int g = h; g < kp / 4; g += 2) {
        const typename Q::T q = row[g];
        S::x(acc, sl[Q::get(q, 0)]);
        S::x(acc, sl[Q::get(q, 1)]);
        S::x(acc, sl[Q::get(q, 2)]);
        S::x(acc, sl[Q::get(q, 3)]);
      }
    }
    acc = S::shfl(acc, 1);
    if (h == 0 && e < e_end)
      *reinterpret_cast<typename S::T*>(out + (size_t)e * mw + (size_t)c * SW) = acc;
    __syncthreads();
  }
}

template <typename IDX, int SW>
cudaError_t launch_slices(cudaStream_t st, const uint32_t* Hx, int n_rows,
                          int mw, const void* ridx, int kp, int n_edges,
                          int sms, size_t smem, uint32_t* out) {
  cudaError_t err = cudaFuncSetAttribute(
      sigma_slices_kernel<IDX, SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_slices = mw / SW;
  const int n_tiles = (n_edges + kTile - 1) / kTile;
  int groups = sms / n_slices;
  groups = groups < 1 ? 1 : groups > n_tiles ? n_tiles : groups;
  const int per_group = ((n_tiles + groups - 1) / groups) * kTile;
  const dim3 grid(n_slices, groups);
  sigma_slices_kernel<IDX, SW><<<grid, kThreads, smem, st>>>(
      Hx, n_rows, mw, static_cast<const IDX*>(ridx), kp, n_edges, per_group, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pvk_sigma(int device, void* stream, const uint32_t* Hx,
                         int n_rows, int mw, const void* ridx, int kp,
                         int ridx_bytes, const void* nbit, int dn,
                         int nbit_bytes, int bit_lo, int n_edges, uint32_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_edges == 0) return 0;
  if ((ridx_bytes != 2 && ridx_bytes != 4) || (nbit_bytes != 2 && nbit_bytes != 4) ||
      kp <= 0 || (kp * ridx_bytes) % 16 != 0 || bit_lo < 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0, smem_max = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t tile_bytes = 2 * (size_t)kTile * (kp * ridx_bytes + kPad);
  auto smem_for = [&](int sw) {
    return (((size_t)n_rows * sw * 4 + 15) & ~(size_t)15) + tile_bytes;
  };
  const int sw = (mw % 2 == 0 && smem_for(2) <= (size_t)smem_max) ? 2 : 1;
  if (smem_for(sw) > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ridx_bytes == 2)
    err = sw == 2 ? launch_slices<int16_t, 2>(st, Hx, n_rows, mw, ridx, kp, n_edges,
                                             sms, smem_for(2), out)
                  : launch_slices<int16_t, 1>(st, Hx, n_rows, mw, ridx, kp, n_edges,
                                             sms, smem_for(1), out);
  else
    err = sw == 2 ? launch_slices<int32_t, 2>(st, Hx, n_rows, mw, ridx, kp, n_edges,
                                             sms, smem_for(2), out)
                  : launch_slices<int32_t, 1>(st, Hx, n_rows, mw, ridx, kp, n_edges,
                                             sms, smem_for(1), out);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_noise(st, nbit, nbit_bytes, dn, mw, bit_lo, n_edges, out);
}
