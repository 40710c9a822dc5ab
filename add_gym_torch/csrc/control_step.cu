// CUDA kernel for one physics control step over N envs (Hopper, sm_90a).
//
// Replaces add_gym_tpu/physics/pallas_step.py::_control_step_kernel; the
// math, the buffer layout and the team design are described in
// control_step.cuh.  A warp steps one env (lane i owns body i), AGT_WARPS
// envs a block, each warp with its AgtEnvScratch in dynamic shared memory;
// grid ceil(N / AGT_WARPS).  The kernel has no __syncthreads, so a warp
// past N returns at once.  Two entry points, one per variant of the
// per-env function: agt_control_step (shared gains) and
// agt_control_step_dr (per-env gains, friction and mass scale in the input
// block).  Both take n_np, the count of bodies with held narrowphase rows
// at the end of the input block (0: none).
//
// Built by hand with nvcc into a shared library with a plain C interface
// and loaded with ctypes (add_gym_torch/physics/cuda_step.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libagt_control_step.so control_step.cu
// No fast-math: parity of tanh, sqrt and division with the plain version
// matters more here than their speed.
#include <cuda_runtime.h>

#include "control_step.cuh"

#define AGT_WARPS 4

// 4 envs of ~10.6 KB stay under the 48 KB a block may take without
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize, ...)
static_assert(AGT_WARPS * sizeof(AgtEnvScratch) <= 48 * 1024,
              "more shared memory a block than a launch takes without opting in");

// The card's team: one warp.  (Host-callable in name only, so that the
// __host__ __device__ step may call it; only the kernel does.)
struct AgtWarp {
  AGT_HD int lane() const {
#if defined(__CUDA_ARCH__)
    return threadIdx.x & 31;
#else
    return 0;
#endif
  }
  AGT_HD static constexpr int size() { return 32; }
  AGT_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
  template <class F>
  AGT_HD void each(int count, const F& f) const {
    for (int t = lane(); t < count; t += size()) f(t);
    sync();
  }
};

template <bool kPerEnv>
__global__ void __launch_bounds__(AGT_WARPS * 32)
agt_control_step_kernel(AgtModel m, const float* __restrict__ in, float* __restrict__ out, int n) {
  extern __shared__ float4 agt_smem[];
  const int w = threadIdx.x >> 5;
  const int e = blockIdx.x * AGT_WARPS + w;
  if (e >= n) return;
  AgtEnvScratch& s = reinterpret_cast<AgtEnvScratch*>(agt_smem)[w];
  agt_control_step_env<kPerEnv>(AgtWarp(), m, s, in, out, n, e);
}

extern "C" int agt_max_bodies() { return AGT_MAX_BODIES; }

// The launch shape of a variant on the current device: info = {envs a
// block, dynamic shared bytes a block, blocks resident per SM, registers a
// thread}.  Returns a CUDA error code (0 = ok).
extern "C" int agt_kernel_info(int per_env, int* info) {
  const void* fn = per_env ? (const void*)agt_control_step_kernel<true>
                           : (const void*)agt_control_step_kernel<false>;
  const int smem = AGT_WARPS * sizeof(AgtEnvScratch);
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, AGT_WARPS * 32, smem);
  if (rc != cudaSuccess) return (int)rc;
  info[0] = AGT_WARPS;
  info[1] = smem;
  info[2] = blocks;
  info[3] = attr.numRegs;
  return 0;
}

template <bool kPerEnv>
static int agt_launch(const float* fbuf, const int* ibuf, int nb, int nd, int ncp, int nsph,
                      int npair, int substeps, int n_np, const float* in, float* out, int n,
                      void* stream) {
  if (n <= 0) return 0;
  AgtModel m;
  m.f = fbuf;
  m.ib = ibuf;
  m.nb = nb;
  m.nd = nd;
  m.ncp = ncp;
  m.nsph = nsph;
  m.npair = npair;
  m.substeps = substeps;
  m.n_np = n_np;
  dim3 grid((n + AGT_WARPS - 1) / AGT_WARPS);
  agt_control_step_kernel<kPerEnv><<<grid, AGT_WARPS * 32, AGT_WARPS * sizeof(AgtEnvScratch),
                                     (cudaStream_t)stream>>>(m, in, out, n);
  return (int)cudaGetLastError();
}

// Launch on `stream` (a cudaStream_t), allocate nothing, do not
// synchronise.  Return cudaGetLastError() after the launch (0 = ok).
// `in` has 13 + 4*nd rows (main) or 15 + 6*nd rows (per-env variant), plus
// 6*n_np narrowphase rows.
extern "C" int agt_control_step(const float* fbuf, const int* ibuf, int nb, int nd, int ncp,
                                int nsph, int npair, int substeps, int n_np, const float* in,
                                float* out, int n, void* stream) {
  return agt_launch<false>(fbuf, ibuf, nb, nd, ncp, nsph, npair, substeps, n_np, in, out, n,
                           stream);
}

extern "C" int agt_control_step_dr(const float* fbuf, const int* ibuf, int nb, int nd, int ncp,
                                   int nsph, int npair, int substeps, int n_np, const float* in,
                                   float* out, int n, void* stream) {
  return agt_launch<true>(fbuf, ibuf, nb, nd, ncp, nsph, npair, substeps, n_np, in, out, n,
                          stream);
}
