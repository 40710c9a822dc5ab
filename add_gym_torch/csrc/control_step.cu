// CUDA kernel for one physics control step over N envs (Hopper, sm_90a).
//
// Replaces add_gym_tpu/physics/pallas_step.py::_control_step_kernel; the
// math, the buffer layout and what bounds this design are described in
// control_step.cuh.  One thread per env, 128 threads a block, grid
// ceil(N / 128); threads past N return at once.  Two entry points, one per
// variant of the per-env function: agt_control_step (shared gains) and
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

#define AGT_THREADS 128

template <bool kPerEnv>
__global__ void __launch_bounds__(AGT_THREADS)
agt_control_step_kernel(AgtModel m, const float* __restrict__ in, float* __restrict__ out, int n) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  AgtEnvScratch s;
  agt_control_step_env<kPerEnv>(m, s, in, out, n, e);
}

extern "C" int agt_max_bodies() { return AGT_MAX_BODIES; }

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
  dim3 grid((n + AGT_THREADS - 1) / AGT_THREADS);
  agt_control_step_kernel<kPerEnv><<<grid, AGT_THREADS, 0, (cudaStream_t)stream>>>(m, in, out, n);
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
