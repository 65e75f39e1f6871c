// Kernel C: sigma rows, one CTA per edge, one thread per output word.
//
// Replaces the Pallas one-hot noise kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/onehot_pallas.py: _kernel, via _call and
// onehot_noise_words) and also does the H gather-XOR that the JAX engine
// runs in XLA (parallel/engine.py _sigma_from_lanes).
//
// Edge e's row is the XOR of the H rows cidx[e, 0..dc) (draws that were
// not taken point at the all-zero row appended to H) plus the one-hot
// noise bits: draw j sets nmask[e, j] in word nword[e, j].  Taken noise
// draws are unique per edge, so XOR equals OR there, as in the TPU kernel.
//
// What bounds it: memory traffic, dc rows of mw words read per edge (144 KB
// per edge at default Params against a 16 MB H that stays in the 50 MB L2).
// Neighbouring threads read neighbouring words of one H row, so each row
// read is coalesced; the edge's indices sit in shared memory.
#include <cuda_runtime.h>
#include <cstdint>

#include "pvac_kernels.h"

namespace {

__global__ void sigma_kernel(const uint32_t* __restrict__ Hx, int mw,
                             const int32_t* __restrict__ cidx, int dc,
                             const int32_t* __restrict__ nword,
                             const uint32_t* __restrict__ nmask, int dn,
                             uint32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  int32_t* s_c = sm;
  int32_t* s_w = sm + dc;
  uint32_t* s_m = reinterpret_cast<uint32_t*>(sm + dc + dn);
  const size_t e = blockIdx.x;
  for (int i = threadIdx.x; i < dc; i += blockDim.x) s_c[i] = cidx[e * dc + i];
  for (int i = threadIdx.x; i < dn; i += blockDim.x) {
    s_w[i] = nword[e * dn + i];
    s_m[i] = nmask[e * dn + i];
  }
  __syncthreads();
  for (int w = threadIdx.x; w < mw; w += blockDim.x) {
    uint32_t acc = 0;
    for (int j = 0; j < dc; ++j) acc ^= Hx[(size_t)s_c[j] * mw + w];
    for (int j = 0; j < dn; ++j)
      if (s_w[j] == w) acc ^= s_m[j];
    out[e * mw + w] = acc;
  }
}

}  // namespace

extern "C" int pvk_sigma(int device, void* stream, const uint32_t* Hx, int mw,
                         const int32_t* cidx, int dc, const int32_t* nword,
                         const uint32_t* nmask, int dn, int n_edges,
                         uint32_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_edges == 0) return 0;
  const int threads = mw < 256 ? ((mw + 31) / 32) * 32 : 256;
  const size_t smem = (size_t)(dc + 2 * dn) * sizeof(int32_t);
  sigma_kernel<<<n_edges, threads, smem, (cudaStream_t)stream>>>(
      Hx, mw, cidx, dc, nword, nmask, dn, out);
  return (int)cudaGetLastError();
}
