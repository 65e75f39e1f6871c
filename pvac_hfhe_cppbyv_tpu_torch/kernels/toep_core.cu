// Kernel E: the PRF core of many prf_R evaluations, from the Toeplitz key
// and the LPN bits to the field element in one pass.
//
// Replaces the per-lane Pallas AES kernel of the JAX package
// (pvac_hfhe_cppbyv_tpu/crypto/aes_pallas.py: _kernel, launched at :194 by
// aes_ctr_keystream_pallas), which the JAX engine sends the one-block
// Toeplitz stream of every core to, together with the XLA tail after it
// (crypto/lpn.py:384-409: toeplitz.conv127, FV.canon and the nonzero
// select) and the port's torch key expansion in front of it.
//
// Core n: expand the AES-256 key tkeys[n] in registers (aes.cuh, as kernel
// A does); encrypt the one counter block le64(tnhi:tnlo) || 0^8, the top
// row of the Toeplitz matrix; take bits 0..126 of the GF(2) product of
// y[n] (kernel A's 127 LPN bits) with it, 127 masked shift-XORs of a
// 4-word value whose shifts are constants once unrolled; canonicalise
// mod p = 2^127 - 1 (FV.canon: only p itself changes); map 0 to 1
// (lpn.hash_to_fp_nonzero, reference lpn.hpp:25-37).  Output: r [N, 4]
// int64 limbs, the value of crypto/toep_core.toep_core_plain, so no cast
// follows.
//
// Design for Hopper: one thread per core, in CTAs of 256 threads, at most
// one per SM, striding over the cores.  Each CTA fills the conflict-free
// replicated T-tables of aes.cuh (128 KB) once; lane l reads copy l, so
// no table load meets a bank conflict (E's earlier tables did).
//
// What bounds it: at 16384 cores, the launch.  A core is one AES block
// with its 52-word key schedule (about 300 table loads and 700 integer
// operations) and about 1,500 integer operations of convolution; it reads
// 56 B and writes 32 B.
#include <cuda_runtime.h>
#include <cstdint>

#include "aes.cuh"
#include "pvac_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 1)
toep_core_kernel(const uint8_t* __restrict__ tkeys,
                 const uint32_t* __restrict__ nlo,
                 const uint32_t* __restrict__ nhi,
                 const uint4* __restrict__ y, longlong2* __restrict__ r,
                 int n) {
  extern __shared__ uint32_t tab[];
  aes_fill_lane_tables(tab);
  __syncthreads();
  const uint32_t* T = tab + (threadIdx.x & 31);

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    uint32_t rk[60];
    aes_expand_key(T, tkeys + (size_t)i * 32, rk);
    uint32_t top[4];
    aes_block(T, rk, nlo[i], nhi[i], top);
    const uint4 yv = y[i];
    const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};

    // bits 0..126 of conv(y, top): top << a under the mask of y's bit a
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int a = 0; a < 127; ++a) {
      const int w = a >> 5, s = a & 31;
      const uint32_t m = 0u - ((yw[w] >> s) & 1u);
#pragma unroll
      for (int k = w; k < 4; ++k) {
        const uint32_t prev = k > w ? top[k > w ? k - w - 1 : 0] : 0u;
        const uint32_t sh = s == 0 ? top[k - w] : __funnelshift_l(prev, top[k - w], s);
        acc[k] ^= sh & m;
      }
    }
    acc[3] &= 0x7FFFFFFFu;

    // FV.canon and the nonzero map: with bit 127 clear the fold adds
    // nothing and the subtract of p = 2^127 - 1 turns only p into 0, which
    // the map turns into 1
    const bool is_p = (acc[0] & acc[1] & acc[2]) == 0xFFFFFFFFu && acc[3] == 0x7FFFFFFFu;
    if (is_p || (acc[0] | acc[1] | acc[2] | acc[3]) == 0) {
      acc[0] = 1u;
      acc[1] = acc[2] = acc[3] = 0u;
    }
    r[2 * (size_t)i] = make_longlong2(acc[0], acc[1]);
    r[2 * (size_t)i + 1] = make_longlong2(acc[2], acc[3]);
  }
}

}  // namespace

extern "C" int pvk_toep_core(int device, void* stream, const uint8_t* tkeys,
                             const uint32_t* nlo, const uint32_t* nhi,
                             const uint32_t* y, int n_cores, int64_t* r) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_cores == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int want = (n_cores + kThreads - 1) / kThreads;
  const int grid = want < sms ? want : sms;
  const size_t smem = (size_t)kAesTableWords * sizeof(uint32_t);
  err = cudaFuncSetAttribute(toep_core_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  toep_core_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      tkeys, nlo, nhi, reinterpret_cast<const uint4*>(y),
      reinterpret_cast<longlong2*>(r), n_cores);
  return (int)cudaGetLastError();
}
