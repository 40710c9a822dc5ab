// CUDA kernel for one physics control step over N envs (Hopper, sm_90a).
//
// Replaces add_gym_tpu/physics/pallas_step.py::_control_step_kernel; the
// math, the buffer layout and the team design are described in
// control_step.cuh.  A warp steps one env (lane i owns body i, and body
// i + 32 past 32 bodies), AgtShape<kCap>::kWarps envs a block, each warp
// with its AgtEnvScratch<kCap> in dynamic shared memory; grid
// ceil(N / kWarps).  The kernel has no __syncthreads, so a warp past N
// returns at once.  One instance per body capacity kCap, each in both
// variants (agt_control_step_kernel<kPerEnv, kCap>):
//   * 32: 4 envs a block, 43,264 B of shared memory (the G1's 30 bodies);
//   * 48: 2 envs a block, 32,384 B (up to 48 bodies: the G1 with Dex3-1
//     hands has 44).  48 slots rather than 64 because shared memory sets
//     how many envs an SM holds: 12 at 16,192 B an env against 10 at 64
//     slots' 21,568 B (228 KB an SM, 1 KB more a block); two envs a block
//     stay under the 48 KB a launch takes without opting in, and hold as
//     many envs an SM as four would with it.
// Two entry points, one per variant: agt_control_step (shared gains) and
// agt_control_step_dr (per-env gains, friction and mass scale in the input
// block).  Both take the instance's capacity and n_np, the count of bodies
// with held narrowphase rows at the end of the input block (0: none).
//
// Built by hand with nvcc into a shared library with a plain C interface
// and loaded with ctypes (add_gym_torch/physics/cuda_step.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libagt_control_step.so control_step.cu
// No fast-math: parity of tanh, sqrt and division with the plain version
// matters more here than their speed.
#include <cuda_runtime.h>

#include "control_step.cuh"

// The launch shape of each instance: envs (warps) a block.
template <int kCap>
struct AgtShape;
template <>
struct AgtShape<32> {
  static constexpr int kWarps = 4;
};
template <>
struct AgtShape<48> {
  static constexpr int kWarps = 2;
};

// each instance's block stays under the 48 KB a launch may take without
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize, ...)
static_assert(AgtShape<32>::kWarps * sizeof(AgtEnvScratch<32>) <= 48 * 1024,
              "more shared memory a block than a launch takes without opting in");
static_assert(AgtShape<48>::kWarps * sizeof(AgtEnvScratch<48>) <= 48 * 1024,
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

template <bool kPerEnv, int kCap>
__global__ void __launch_bounds__(AgtShape<kCap>::kWarps * 32)
agt_control_step_kernel(AgtModel m, const float* __restrict__ in, float* __restrict__ out, int n) {
  constexpr int kWarps = AgtShape<kCap>::kWarps;
  extern __shared__ float4 agt_smem[];
  const int w = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + w;
  if (e >= n) return;
  AgtEnvScratch<kCap>& s = reinterpret_cast<AgtEnvScratch<kCap>*>(agt_smem)[w];
  agt_control_step_env<kPerEnv>(AgtWarp(), m, s, in, out, n, e);
}

template <int kCap>
static int agt_info(int per_env, int* info) {
  constexpr int kWarps = AgtShape<kCap>::kWarps;
  const void* fn = per_env ? (const void*)agt_control_step_kernel<true, kCap>
                           : (const void*)agt_control_step_kernel<false, kCap>;
  const int smem = kWarps * sizeof(AgtEnvScratch<kCap>);
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kWarps * 32, smem);
  if (rc != cudaSuccess) return (int)rc;
  info[0] = kWarps;
  info[1] = smem;
  info[2] = blocks;
  info[3] = attr.numRegs;
  return 0;
}

// The launch shape of a variant of the instance of capacity `cap` on the
// current device: info = {envs a block, dynamic shared bytes a block,
// blocks resident per SM, registers a thread}.  Returns a CUDA error code
// (0 = ok; cudaErrorInvalidValue for a capacity with no instance).
extern "C" int agt_kernel_info(int cap, int per_env, int* info) {
  if (cap == 32) return agt_info<32>(per_env, info);
  if (cap == 48) return agt_info<48>(per_env, info);
  return (int)cudaErrorInvalidValue;
}

template <bool kPerEnv, int kCap>
static int agt_launch_instance(const AgtModel& m, const float* in, float* out, int n,
                               void* stream) {
  constexpr int kWarps = AgtShape<kCap>::kWarps;
  dim3 grid((n + kWarps - 1) / kWarps);
  agt_control_step_kernel<kPerEnv, kCap><<<grid, kWarps * 32, kWarps * sizeof(AgtEnvScratch<kCap>),
                                           (cudaStream_t)stream>>>(m, in, out, n);
  return (int)cudaGetLastError();
}

template <bool kPerEnv>
static int agt_launch(int cap, const float* fbuf, const int* ibuf, int nb, int nd, int ncp,
                      int nsph, int npair, int substeps, int n_np, const float* in, float* out,
                      int n, void* stream) {
  if (nb > cap) return (int)cudaErrorInvalidValue;
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
  if (cap == 32) return agt_launch_instance<kPerEnv, 32>(m, in, out, n, stream);
  if (cap == 48) return agt_launch_instance<kPerEnv, 48>(m, in, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

// Launch the instance of capacity `cap` (32 or 48, at least nb) on
// `stream` (a cudaStream_t), allocate nothing, do not synchronise.  Return
// cudaGetLastError() after the launch (0 = ok), or cudaErrorInvalidValue
// without launching for a capacity with no instance or under nb.  `in` has
// 13 + 4*nd rows (main) or 15 + 6*nd rows (per-env variant), plus 6*n_np
// narrowphase rows.
extern "C" int agt_control_step(int cap, const float* fbuf, const int* ibuf, int nb, int nd,
                                int ncp, int nsph, int npair, int substeps, int n_np,
                                const float* in, float* out, int n, void* stream) {
  return agt_launch<false>(cap, fbuf, ibuf, nb, nd, ncp, nsph, npair, substeps, n_np, in, out,
                           n, stream);
}

extern "C" int agt_control_step_dr(int cap, const float* fbuf, const int* ibuf, int nb, int nd,
                                   int ncp, int nsph, int npair, int substeps, int n_np,
                                   const float* in, float* out, int n, void* stream) {
  return agt_launch<true>(cap, fbuf, ibuf, nb, nd, ncp, nsph, npair, substeps, n_np, in, out,
                          n, stream);
}
