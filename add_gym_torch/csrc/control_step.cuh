// One physics control step for one env, stepped by a team of threads: the
// per-env body of the CUDA kernel in control_step.cu.
//
// Replaces add_gym_tpu/physics/pallas_step.py::_control_step_kernel in two
// variants, each with or without the held narrowphase rows:
//   * main: shared PD gains and friction from the model buffer, no mass
//     scale;
//   * per-env (domain randomization, the Pallas kernel's per-env kp/kv/mu
//     blocks with `use_ms`): kp[nd], kv[nd], mu and the mass scale ms come
//     from env-minor rows after the state in the input block.  ms
//     multiplies the ground contact (reported and applied), the summed
//     ground + held wrenches, the articulated-inertia blocks and the bias
//     forces, as fused_step._substep_core does.
//   * narrowphase rows (the Pallas kernel's `np_bodies` input): n_np > 0
//     touched bodies, listed in the i32 buffer, each with 6 env-minor rows
//     (torque 3, force 3; world frame, about the body origin) after the
//     state and per-env rows.  They are computed outside the kernel
//     (fused_step.compute_np_ext) and added to the held self-collision
//     wrenches of their bodies, so they are held across the substeps and
//     scaled by ms with the rest.  n_np = 0 is the kernel without them.
// Both variants are one template (AgtEnvParams<kPerEnv>); the main one
// reads its gains and friction from the model buffer and scales nothing.
// Its plain version is add_gym_torch/physics/fused_step.py::fused_step;
// the two compute the same function:
//   1. PD target: clamp to the joint limits +- position_limit_margin, then
//      slew-limit by +- max_target_delta against the previous target.
//   2. Held wrenches: FK of the INPUT state, sphere-pair penalty forces,
//      plus the narrowphase rows; held constant across the substeps.
//   3. `substeps` x substep: FK and body velocities; per-point ground
//      contact (spring-damper normal, Coulomb friction with an impulse
//      clamp); joint torques with limit springs; a three-pass articulated-
//      body algorithm (ABA) with dt*(damping+kv) folded into the joint
//      denominator and a 6x6 Cholesky solve for the free root;
//      semi-implicit Euler, quaternion update, +-100 velocity clip and the
//      joint-limit clamp.
//   4. `contact` is the last substep's per-body normal force.
//
// Design.  A team of threads steps one env together: on the card the team
// is one warp, lane i owning body i and dof i - 1 (the joint of body i),
// and bodies i + 32, ... too where a model has more than 32.  The per-env
// working set (AgtEnvScratch<kCap>: FK frames, articulated-inertia blocks,
// bias forces and the state, 84 rows of kCap body slots) lives in shared
// memory, body-minor: element k of body i's field at field[k][i], so 32
// lanes on one field touch 32 banks.  The body capacity kCap is a template
// parameter: the kernel has one instance per capacity (control_step.cu:
// 32 slots, 10,816 B an env, for the G1's 30 bodies; 48 slots, 16,192 B,
// for up to 48, such as the G1 with Dex3-1 hands' 44), and a model takes
// the narrowest that holds its bodies.  Past 32 bodies lanes 0..nb-33
// carry two bodies in each phase, one after the other.
// The step is a sequence of phases.  In each, the team spreads independent
// items over its lanes (team.each, below: bodies, dofs, sphere pairs,
// narrowphase rows) and syncs after it; an item writes only its own slots
// and reads only what earlier phases wrote.  Work that is independent per
// body (joint rotations, ground contact over the body's points in CSR
// order, ABA pass 1, the joint torque) is one phase.  The tree passes go
// level by level, one phase per level of the depth table packed with the
// model: FK and ABA pass 3 root to leaves, ABA pass 2 leaves to root.  Every
// sum across lanes is a loop of the owner lane in a fixed order, never an
// atomic: ABA pass 2 adds a body's children in decreasing index (the
// order of a serial loop from the last body down), and the held
// self-collision sums each body's pairs in pair order.  So the result does
// not depend on the team's size or on which lane ran which item: the host
// build at team size 1 and 32 agree bit for bit (the CPU tests check it),
// and two launches on one input give the same bits.  What is left serial
// is the tree's depth (10 levels for the G1: waist 3 + arm 7; 13 with
// the Dex3-1 hands' thumb 3) times a
// body's ABA work, the root's 6x6 solve and integration on lane 0, and
// each body's contact points.  The model constants live in one packed f32
// buffer and one i32 buffer (layout below, written by
// add_gym_torch/physics/cuda_step.py::pack_model), field-major so that
// lanes reading one constant of 32 bodies read 32 neighbouring floats.
// The I/O stays env-minor ([rows, N] f32, row r of env e at r*N + e):
// 13 + 4*nd floats in, plus 2*nd + 2 in the per-env variant and 6*n_np
// narrowphase rows, 13 + 3*nd + nb out per env, each a 4-byte access of
// its lane.
//
// AGT_HD marks the functions for both compilers: nvcc builds them into
// the kernel; a host compiler builds them too, with AgtHostTeam, which lets
// the CPU tests check this arithmetic against the plain version.
#pragma once

#include <math.h>

#include <type_traits>

#if defined(__CUDACC__)
#define AGT_HD __host__ __device__ __forceinline__
#else
#define AGT_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define AGT_LDG(p) __ldg(p)
#else
#define AGT_LDG(p) (*(p))
#endif

#define AGT_PAIR_CHUNK 32  // sphere pairs per round of the held self-collision

// f32 buffer layout (offsets in floats; each section field-major: element k
// of item i at section + k * count + i):
//   header   [AGT_HDR]:         dt, max_torque, position_limit_margin,
//                               max_target_delta, friction_mu, gravity, 0, 0
//   bodies   [AGT_BODY][nb]:    C0[9] C1[9] C2[9] r[3] axis[3] IA_A[9]
//                               IA_B[9] mass  (M_i = C0 + cos C1 + sin C2)
//   dofs     [AGT_DOF][nd]:     armature damping frictionloss lo hi kp kv
//   points   [AGT_PT][ncp]:     pos[3] radius k b stick_mass (CSR by body)
//   spheres  [AGT_SPH][nsph]:   pos[3] radius
//   pairs    [AGT_PAIR][npair]: radius_sum k_sc b_sc
// i32 buffer: parent[nb] (parent[i] < i), depth[nb + 1] (each body's depth
//             in the tree, then the tree's depth), children[nb] (bits 0-31
//             of body i's 64-bit child mask, bit c set when parent[c] = i),
//             cp_start[nb + 1], sph_body[nsph], pair[npair][2],
//             children_hi[nb] (bits 32-63 of the masks), np_body[n_np]
//             (sorted, distinct bodies of the narrowphase rows).  The high
//             words come after the sections a step reads at every substep,
//             so that those keep the offsets they had before models of
//             more than 32 bodies: moving cp_start and the sphere tables
//             by nb slowed the G1's step by ~1% on the H100.
#define AGT_HDR 8
#define AGT_BODY 52
#define AGT_DOF 7
#define AGT_PT 7
#define AGT_SPH 4
#define AGT_PAIR 3

struct AgtModel {
  const float* f;
  const int* ib;
  int nb, nd, ncp, nsph, npair, substeps, n_np;

  AGT_HD float hdr(int k) const { return AGT_LDG(f + k); }
  AGT_HD const float* dofs() const { return f + AGT_HDR + nb * AGT_BODY; }
  AGT_HD float body(int k, int i) const { return AGT_LDG(f + AGT_HDR + k * nb + i); }
  AGT_HD float dof(int k, int j) const { return AGT_LDG(dofs() + k * nd + j); }
  AGT_HD float point(int k, int p) const { return AGT_LDG(dofs() + nd * AGT_DOF + k * ncp + p); }
  AGT_HD float sphere(int k, int s) const {
    return AGT_LDG(dofs() + nd * AGT_DOF + ncp * AGT_PT + k * nsph + s);
  }
  AGT_HD float pair(int k, int q) const {
    return AGT_LDG(dofs() + nd * AGT_DOF + ncp * AGT_PT + nsph * AGT_SPH + k * npair + q);
  }
  AGT_HD int parent(int i) const { return AGT_LDG(ib + i); }
  AGT_HD int depth(int i) const { return AGT_LDG(ib + nb + i); }
  AGT_HD int levels() const { return depth(nb); }
  // body i's child mask as a Mask (unsigned: bits 0-31; unsigned long long: 0-63)
  template <class Mask>
  AGT_HD Mask children(int i) const {
    Mask mask = (unsigned)AGT_LDG(ib + 2 * nb + 1 + i);
    if constexpr (sizeof(Mask) > 4)
      mask |= (Mask)(unsigned)AGT_LDG(ib + 4 * nb + 2 + nsph + 2 * npair + i) << 32;
    return mask;
  }
  AGT_HD int cp_start(int i) const { return AGT_LDG(ib + 3 * nb + 1 + i); }
  AGT_HD int sph_body(int s) const { return AGT_LDG(ib + 4 * nb + 2 + s); }
  AGT_HD int pair_sphere(int q, int side) const {
    return AGT_LDG(ib + 4 * nb + 2 + nsph + 2 * q + side);
  }
  AGT_HD int np_body(int j) const { return AGT_LDG(ib + 5 * nb + 2 + nsph + 2 * npair + j); }
};

// ------------------------------------------------------------------ team
// A team steps one env.  team.each(count, f) calls f(t) once for every t in
// [0, count), spread over the team's lanes, and syncs the team after it.
// On the card the team is a warp (AgtWarp in control_step.cu: lane() is the
// lane id, size() 32, sync() __syncwarp).  On the host AgtHostTeam runs
// kSize lanes one after another, each phase for every lane in turn before
// the next phase begins.  kSize = 1 is a plain serial step, items in
// increasing order; larger teams run their lanes last to first, so that
// an item reading a slot that a lower item of the same phase writes (a
// child reading its parent) would see it unwritten and change the bits.
#if !defined(__CUDACC__)
template <int kSize>
struct AgtHostTeam {
  static constexpr int size() { return kSize; }
  template <class F>
  void each(int count, const F& f) const {
    for (int lane = kSize - 1; lane >= 0; --lane)
      for (int t = lane; t < count; t += kSize) f(t);
  }
};
#endif

// highest set bit of a non-zero mask
AGT_HD int agt_msb(unsigned x) {
#if defined(__CUDA_ARCH__)
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}

AGT_HD int agt_msb(unsigned long long x) {
#if defined(__CUDA_ARCH__)
  return 63 - __clzll(x);
#else
  return 63 - __builtin_clzll(x);
#endif
}

// ------------------------------------------------------------ 3x3 helpers
// matrices row-major m[r*3+c]

AGT_HD void mm33(const float* a, const float* b, float* o) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      o[r * 3 + c] = a[r * 3] * b[c] + a[r * 3 + 1] * b[3 + c] + a[r * 3 + 2] * b[6 + c];
}

// o = a * b^T
AGT_HD void mm33_bt(const float* a, const float* b, float* o) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      o[r * 3 + c] = a[r * 3] * b[c * 3] + a[r * 3 + 1] * b[c * 3 + 1] + a[r * 3 + 2] * b[c * 3 + 2];
}

AGT_HD void mv33(const float* a, const float* v, float* o) {
  for (int r = 0; r < 3; ++r) o[r] = a[r * 3] * v[0] + a[r * 3 + 1] * v[1] + a[r * 3 + 2] * v[2];
}

// o = a^T v
AGT_HD void mtv33(const float* a, const float* v, float* o) {
  for (int c = 0; c < 3; ++c) o[c] = a[c] * v[0] + a[3 + c] * v[1] + a[6 + c] * v[2];
}

AGT_HD void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

AGT_HD float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

AGT_HD float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// ------------------------------------------------------------- per-env work

// Gains, friction and mass scale of one env.  kPerEnv = false: kp/kv are
// the shared values in the model buffer's kp/kv dof rows and mu the
// header's; nothing is scaled by mass.  kPerEnv = true: kp/kv are env-minor
// input rows (stride n) and mu, ms this env's values.
template <bool kPerEnv>
struct AgtEnvParams {
  const float* kp;  // kp of dof j at kp[j * stride]
  const float* kv;
  int n;            // env count: the row stride of the per-env variant
  float mu, ms;
  AGT_HD float kp_of(int j) const { return AGT_LDG(kp + j * (kPerEnv ? n : 1)); }
  AGT_HD float kv_of(int j) const { return AGT_LDG(kv + j * (kPerEnv ? n : 1)); }
  AGT_HD float scale(float x) const { return kPerEnv ? x * ms : x; }
};

// One env's working set, body-minor (element k of body i at field[k][i]),
// for models of up to kCap bodies; Mask holds a body's child mask.
template <int kCap>
struct AgtEnvScratch {
  static_assert(kCap >= AGT_PAIR_CHUNK && kCap <= 64,
                "a pair chunk fills one row; child masks hold 64 bodies");
  typedef float AgtRow[kCap];
  typedef typename std::conditional<(kCap <= 32), unsigned, unsigned long long>::type Mask;
  AgtRow W[9];    // body -> world rotation
  AgtRow M[9];    // parent -> body joint rotation
  AgtRow o[3];    // world origin
  AgtRow om[3];   // world angular velocity
  AgtRow vel[3];  // world origin linear velocity
  // articulated inertia [[A, B], [B^T, D]]: A rows 0-8, B 9-17, D 18-26.
  // ABA pass 2 leaves there what a body adds to its parent's blocks; the
  // held self-collision uses the rows as its buffer of pair wrenches.
  AgtRow ABD[27];
  AgtRow pn[3];   // bias force (angular, linear); ABA pass 2 leaves there
  AgtRow pf[3];   // what a body adds to its parent's, pass 3 the spatial acceleration
  AgtRow cn[3];   // velocity-product accelerations
  AgtRow cf[3];
  AgtRow Ut[3];   // U = Ia S (angular, linear)
  AgtRow Ub[3];
  AgtRow dinv, u;
  AgtRow scn[3];  // held self-collision + narrowphase torque / force (world)
  AgtRow scf[3];
  AgtRow q, qd, tgt, tau;  // by dof
  float root[16];          // root pos 0-2, quat 3-6 (w x y z), vel 7-9, ang vel 10-12
};

template <int K, class Row>
AGT_HD void agt_ld(const Row* rows, int i, float* v) {
  for (int k = 0; k < K; ++k) v[k] = rows[k][i];
}

template <int K, class Row>
AGT_HD void agt_st(Row* rows, int i, const float* v) {
  for (int k = 0; k < K; ++k) rows[k][i] = v[k];
}

// FK and body velocities of the state in s (root, q, qd) into W, M, o, om,
// vel: the joint rotations and the root frame in one phase, then one phase
// per level of the tree.
template <class Team, class Scratch>
AGT_HD void agt_fk(const Team& team, const AgtModel& m, Scratch& s) {
  team.each(m.nb, [&](int i) {
    if (i == 0) {
      const float* r = s.root;
      float w = r[3], x = r[4], y = r[5], z = r[6];
      float sc = 2.0f / (w * w + x * x + y * y + z * z);
      float W0[9] = {1 - sc * (y * y + z * z), sc * (x * y - z * w), sc * (x * z + y * w),
                     sc * (x * y + z * w), 1 - sc * (x * x + z * z), sc * (y * z - x * w),
                     sc * (x * z - y * w), sc * (y * z + x * w), 1 - sc * (x * x + y * y)};
      agt_st<9>(s.W, 0, W0);
      for (int k = 0; k < 3; ++k) {
        s.o[k][0] = r[k];
        s.om[k][0] = r[10 + k];
        s.vel[k][0] = r[7 + k];
      }
    } else {
      float c = cosf(s.q[i - 1]), sn = sinf(s.q[i - 1]);
      for (int k = 0; k < 9; ++k) s.M[k][i] = m.body(k, i) + c * m.body(9 + k, i) + sn * m.body(18 + k, i);
    }
  });
  for (int lev = 1; lev <= m.levels(); ++lev)
    team.each(m.nb, [&](int i) {
      if (m.depth(i) != lev) return;
      const int p = m.parent(i);
      float Wp[9], Mi[9], Wi[9], omp[3], rb[3], ax[3], rw[3], axw[3], t[3];
      agt_ld<9>(s.W, p, Wp);
      agt_ld<9>(s.M, i, Mi);
      mm33(Wp, Mi, Wi);
      agt_st<9>(s.W, i, Wi);
      for (int k = 0; k < 3; ++k) {
        rb[k] = m.body(27 + k, i);
        ax[k] = m.body(30 + k, i);
      }
      mv33(Wp, rb, rw);
      mv33(Wi, ax, axw);
      agt_ld<3>(s.om, p, omp);
      cross3(omp, rw, t);
      const float qd = s.qd[i - 1];
      for (int k = 0; k < 3; ++k) {
        s.o[k][i] = s.o[k][p] + rw[k];
        s.om[k][i] = omp[k] + axw[k] * qd;
        s.vel[k][i] = s.vel[k][p] + t[k];
      }
    });
}

// Held wrenches into scn/scf: the sphere-pair penalty forces of the current
// FK frames, then the narrowphase rows (`rows`: 6 per touched body,
// env-minor, env offset applied; torque rows 0-2, force rows 3-5).  Pairs go
// AGT_PAIR_CHUNK at a time: a lane per pair writes its force and the two
// torques to the pair buffer, then each body's lane adds the pairs that
// touch it in pair order.
template <class Team, class Scratch>
AGT_HD void agt_held_wrenches(const Team& team, const AgtModel& m, Scratch& s,
                              const float* rows, int n) {
  team.each(m.nb, [&](int i) {
    for (int k = 0; k < 3; ++k) s.scn[k][i] = s.scf[k][i] = 0.0f;
  });
  // pair c0 + t: f 0-2, torque on a 3-5, on b 6-8, bodies 9-10
  typename Scratch::AgtRow* buf = s.ABD;
  for (int c0 = 0; c0 < m.npair; c0 += AGT_PAIR_CHUNK) {
    const int cnt = m.npair - c0 < AGT_PAIR_CHUNK ? m.npair - c0 : AGT_PAIR_CHUNK;
    team.each(cnt, [&](int t) {
      const int qq = c0 + t;
      const int sa = m.pair_sphere(qq, 0), sb = m.pair_sphere(qq, 1);
      const int ba = m.sph_body(sa), bb = m.sph_body(sb);
      float Wa[9], Wb[9], pa[3], pb[3], oma[3], omb[3];
      agt_ld<9>(s.W, ba, Wa);
      agt_ld<9>(s.W, bb, Wb);
      agt_ld<3>(s.om, ba, oma);
      agt_ld<3>(s.om, bb, omb);
      for (int k = 0; k < 3; ++k) {
        pa[k] = m.sphere(k, sa);
        pb[k] = m.sphere(k, sb);
      }
      float ra_[3], rb_[3], xa[3], xb[3], va[3], vb[3], t3[3];
      mv33(Wa, pa, ra_);
      mv33(Wb, pb, rb_);
      cross3(oma, ra_, t3);
      for (int k = 0; k < 3; ++k) { xa[k] = s.o[k][ba] + ra_[k]; va[k] = s.vel[k][ba] + t3[k]; }
      cross3(omb, rb_, t3);
      for (int k = 0; k < 3; ++k) { xb[k] = s.o[k][bb] + rb_[k]; vb[k] = s.vel[k][bb] + t3[k]; }
      float d[3], dv[3], nrm[3];
      for (int k = 0; k < 3; ++k) { d[k] = xa[k] - xb[k]; dv[k] = va[k] - vb[k]; }
      float dist = sqrtf(dot3(d, d) + 1e-12f);
      float pen = m.pair(0, qq) - dist;
      for (int k = 0; k < 3; ++k) nrm[k] = d[k] / dist;
      float vn = dot3(dv, nrm);
      float fmag = pen > 0.0f ? fmaxf(m.pair(1, qq) * pen - m.pair(2, qq) * vn, 0.0f) : 0.0f;
      float f[3], ta[3], tb[3];
      for (int k = 0; k < 3; ++k) f[k] = nrm[k] * fmag;
      cross3(ra_, f, ta);
      cross3(rb_, f, tb);
      for (int k = 0; k < 3; ++k) {
        buf[k][t] = f[k];
        buf[3 + k][t] = ta[k];
        buf[6 + k][t] = tb[k];
      }
      buf[9][t] = (float)ba;
      buf[10][t] = (float)bb;
    });
    team.each(m.nb, [&](int i) {
      for (int t = 0; t < cnt; ++t) {
        if ((int)buf[9][t] == i)
          for (int k = 0; k < 3; ++k) { s.scn[k][i] += buf[3 + k][t]; s.scf[k][i] += buf[k][t]; }
        if ((int)buf[10][t] == i)
          for (int k = 0; k < 3; ++k) { s.scn[k][i] -= buf[6 + k][t]; s.scf[k][i] -= buf[k][t]; }
      }
    });
  }
  team.each(m.n_np, [&](int j) {
    const int b = m.np_body(j);
    const float* r = rows + 6 * j * n;
    for (int k = 0; k < 3; ++k) {
      s.scn[k][b] += r[k * n];
      s.scf[k][b] += r[(3 + k) * n];
    }
  });
}

// Solve [[A, B], [B^T, D]] x = rhs by an unrolled Cholesky (pivot >= 1e-9).
AGT_HD void agt_solve6(const float* A, const float* B, const float* D, const float* rhs, float* x) {
  float Mf[6][6];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      Mf[r][c] = A[r * 3 + c];
      Mf[r][3 + c] = B[r * 3 + c];
      Mf[3 + r][c] = B[c * 3 + r];
      Mf[3 + r][3 + c] = D[r * 3 + c];
    }
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float ssum = Mf[j][j];
    for (int k = 0; k < j; ++k) ssum = ssum - L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(ssum, 1e-9f));
    float inv_ljj = 1.0f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      ssum = Mf[i][j];
      for (int k = 0; k < j; ++k) ssum = ssum - L[i][k] * L[j][k];
      L[i][j] = ssum * inv_ljj;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float ssum = rhs[i];
    for (int k = 0; k < i; ++k) ssum = ssum - L[i][k] * y[k];
    y[i] = ssum / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float ssum = y[i];
    for (int k = i + 1; k < 6; ++k) ssum = ssum - L[k][i] * x[k];
    x[i] = ssum / L[i][i];
  }
}

// Body p's articulated inertia abd[27] (A, B, D) and bias force pn, pf
// with its children's contributions of ABA pass 2 (left in their ABD, pn
// and pf slots) added in decreasing child index.
template <class Scratch>
AGT_HD void agt_articulated(const AgtModel& m, const Scratch& s, int p, float* abd,
                            float* pn, float* pf) {
  typedef typename Scratch::Mask Mask;
  agt_ld<27>(s.ABD, p, abd);
  agt_ld<3>(s.pn, p, pn);
  agt_ld<3>(s.pf, p, pf);
  for (Mask kids = m.children<Mask>(p); kids; ) {
    const int c = agt_msb(kids);
    kids &= ~((Mask)1 << c);
    for (int k = 0; k < 27; ++k) abd[k] += s.ABD[k][c];
    for (int k = 0; k < 3; ++k) {
      pn[k] += s.pn[k][c];
      pf[k] += s.pf[k][c];
    }
  }
}

// One substep; writes the per-body contact force to `contact` when non-null.
template <bool kPerEnv, class Team, class Scratch>
AGT_HD void agt_substep(const Team& team, const AgtModel& m, const AgtEnvParams<kPerEnv>& P,
                        Scratch& s, float* contact, int n) {
  const float dt = m.hdr(0), max_torque = m.hdr(1), mu = P.mu, gravity = m.hdr(5);

  agt_fk(team, m, s);

  // ------------- contacts, ABA pass 1 and the joint torque (one body each)
  team.each(m.nb, [&](int i) {
    float W[9], om[3], vel[3];
    agt_ld<9>(s.W, i, W);
    agt_ld<3>(s.om, i, om);
    agt_ld<3>(s.vel, i, vel);
    const float oz = s.o[2][i];
    float fw[3] = {0.0f, 0.0f, 0.0f}, nw[3] = {0.0f, 0.0f, 0.0f}, csum = 0.0f;
    for (int pt = m.cp_start(i); pt < m.cp_start(i + 1); ++pt) {
      const float pc[3] = {m.point(0, pt), m.point(1, pt), m.point(2, pt)};
      float r[3], t[3], v[3];
      mv33(W, pc, r);
      cross3(om, r, t);
      for (int k = 0; k < 3; ++k) v[k] = vel[k] + t[k];
      float phi = (oz + r[2]) - m.point(3, pt);
      float pen = fmaxf(-phi, 0.0f);
      float fn = phi < 0.0f ? fmaxf(m.point(4, pt) * pen - m.point(5, pt) * v[2], 0.0f) : 0.0f;
      float speed = sqrtf(v[0] * v[0] + v[1] * v[1] + 1e-10f);
      float ftm = fminf(mu * fn, m.point(6, pt) * speed / dt);
      float scale = -ftm / speed;
      float f[3] = {scale * v[0], scale * v[1], fn}, nn[3];
      cross3(r, f, nn);
      for (int k = 0; k < 3; ++k) { fw[k] += f[k]; nw[k] += nn[k]; }
      csum += fn;
    }
    if (contact) contact[i * n] = P.scale(csum);
    for (int k = 0; k < 3; ++k) {
      nw[k] = P.scale(nw[k] + s.scn[k][i]);
      fw[k] = P.scale(fw[k] + s.scf[k][i]);
    }

    float wb[3], vb[3], cn[3] = {0.0f, 0.0f, 0.0f}, cf[3] = {0.0f, 0.0f, 0.0f};
    mtv33(W, om, wb);
    mtv33(W, vel, vb);
    if (i > 0) {
      float wJ[3];
      for (int k = 0; k < 3; ++k) wJ[k] = m.body(30 + k, i) * s.qd[i - 1];
      cross3(wb, wJ, cn);
      cross3(vb, wJ, cf);
    }
    agt_st<3>(s.cn, i, cn);
    agt_st<3>(s.cf, i, cf);
    float IA[9], IB[9];
    for (int k = 0; k < 9; ++k) {
      IA[k] = m.body(33 + k, i);
      IB[k] = m.body(42 + k, i);
    }
    const float mass = m.body(51, i);
    for (int k = 0; k < 9; ++k) {
      s.ABD[k][i] = P.scale(IA[k]);
      s.ABD[9 + k][i] = P.scale(IB[k]);
      s.ABD[18 + k][i] = (k % 4 == 0) ? P.scale(mass) : 0.0f;
    }
    float ivn[3], ivf[3], t1[3], t2[3], en[3], ef[3];
    mv33(IA, wb, t1);
    mv33(IB, vb, t2);
    for (int k = 0; k < 3; ++k) ivn[k] = t1[k] + t2[k];
    mtv33(IB, wb, t1);
    for (int k = 0; k < 3; ++k) ivf[k] = t1[k] + mass * vb[k];
    float bn[3], bf[3];
    cross3(wb, ivn, t1);
    cross3(vb, ivf, t2);
    for (int k = 0; k < 3; ++k) bn[k] = P.scale(t1[k] + t2[k]);
    cross3(wb, ivf, bf);
    for (int k = 0; k < 3; ++k) bf[k] = P.scale(bf[k]);
    mtv33(W, nw, en);
    mtv33(W, fw, ef);
    for (int k = 0; k < 3; ++k) { s.pn[k][i] = bn[k] - en[k]; s.pf[k][i] = bf[k] - ef[k]; }

    if (i > 0) {  // joint torque of dof j, the joint of body i
      const int j = i - 1;
      float q = s.q[j], qd = s.qd[j];
      float tpd = clampf(P.kp_of(j) * (s.tgt[j] - q) - P.kv_of(j) * qd, -max_torque, max_torque);
      s.tau[j] = tpd - m.dof(1, j) * qd - m.dof(2, j) * tanhf(qd / 0.05f)
                 + 400.0f * fmaxf(m.dof(3, j) - q, 0.0f) - 400.0f * fmaxf(q - m.dof(4, j), 0.0f);
    }
  });

  // ------------------------------------ ABA pass 2, deepest level first
  for (int lev = m.levels(); lev >= 1; --lev)
    team.each(m.nb, [&](int i) {
      if (m.depth(i) != lev) return;
      const int j = i - 1;
      float abd[27], Mi[9], pn[3], pf[3], cn[3], cf[3], ax[3], r[3];
      agt_articulated(m, s, i, abd, pn, pf);
      const float *A = abd, *B = abd + 9, *D = abd + 18;
      agt_ld<9>(s.M, i, Mi);
      agt_ld<3>(s.cn, i, cn);
      agt_ld<3>(s.cf, i, cf);
      for (int k = 0; k < 3; ++k) {
        r[k] = m.body(27 + k, i);
        ax[k] = m.body(30 + k, i);
      }
      float Ut[3], Ub[3];
      mv33(A, ax, Ut);
      mtv33(B, ax, Ub);
      float d = dot3(Ut, ax) + m.dof(0, j) + dt * (m.dof(1, j) + P.kv_of(j));
      float dinv = 1.0f / d;
      float u = s.tau[j] - dot3(ax, pn);
      agt_st<3>(s.Ut, i, Ut);
      agt_st<3>(s.Ub, i, Ub);
      s.dinv[i] = dinv;
      s.u[i] = u;

      float Ap[9], Bp[9], Dp[9];
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) {
          Ap[a * 3 + b] = A[a * 3 + b] - Ut[a] * Ut[b] * dinv;
          Bp[a * 3 + b] = B[a * 3 + b] - Ut[a] * Ub[b] * dinv;
          Dp[a * 3 + b] = D[a * 3 + b] - Ub[a] * Ub[b] * dinv;
        }
      float ud = u * dinv;
      float t1[3], t2[3], pan[3], paf[3];
      mv33(Ap, cn, t1);
      mv33(Bp, cf, t2);
      for (int k = 0; k < 3; ++k) pan[k] = pn[k] + t1[k] + t2[k] + Ut[k] * ud;
      mtv33(Bp, cn, t1);
      mv33(Dp, cf, t2);
      for (int k = 0; k < 3; ++k) paf[k] = pf[k] + t1[k] + t2[k] + Ub[k] * ud;

      // to parent coords: n_p = M pan + r x (M paf); f_p = M paf
      float mpan[3], mpaf[3], rxm[3];
      mv33(Mi, pan, mpan);
      mv33(Mi, paf, mpaf);
      cross3(r, mpaf, rxm);
      for (int k = 0; k < 3; ++k) {
        s.pn[k][i] = mpan[k] + rxm[k];
        s.pf[k][i] = mpaf[k];
      }

      // inertia: sandwich with X = [[E,0],[F,E]], E = Mi^T, F = -E r~
      float tmp[9], Ah[9], Bh[9], Dh[9];
      mm33(Mi, Ap, tmp);
      mm33_bt(tmp, Mi, Ah);
      mm33(Mi, Bp, tmp);
      mm33_bt(tmp, Mi, Bh);
      mm33(Mi, Dp, tmp);
      mm33_bt(tmp, Mi, Dh);
      const float rx[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0], -r[1], r[0], 0.0f};
      float Bh_rx[9], rx_Dh[9], rx_Dh_rx[9];
      mm33(Bh, rx, Bh_rx);
      mm33(rx, Dh, rx_Dh);
      mm33(rx_Dh, rx, rx_Dh_rx);
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) {
          int k = a * 3 + b;
          s.ABD[k][i] = ((Ah[k] - Bh_rx[k]) - Bh_rx[b * 3 + a]) - rx_Dh_rx[k];
          s.ABD[9 + k][i] = Bh[k] + rx_Dh[k];
          s.ABD[18 + k][i] = Dh[k];
        }
    });

  // ------------------- root: 6x6 solve, then its integration (lane 0)
  // the spatial accelerations overwrite the bias rows: pn/pf hold a_n/a_f
  const float vmax = 100.0f;
  team.each(1, [&](int) {
    float abd[27], pn[3], pf[3], rhs[6], a0[6];
    agt_articulated(m, s, 0, abd, pn, pf);
    for (int k = 0; k < 3; ++k) { rhs[k] = -pn[k]; rhs[3 + k] = -pf[k]; }
    agt_solve6(abd, abd + 9, abd + 18, rhs, a0);
    for (int k = 0; k < 3; ++k) { s.pn[k][0] = a0[k]; s.pf[k][0] = a0[3 + k]; }

    float* rp = s.root;
    float* rq = s.root + 3;
    float* rv = s.root + 7;
    float* ra = s.root + 10;
    float W0[9], wdot[3], alin[3], t[3];
    agt_ld<9>(s.W, 0, W0);
    mv33(W0, a0, wdot);
    mv33(W0, a0 + 3, alin);
    cross3(ra, rv, t);
    for (int k = 0; k < 3; ++k) alin[k] += t[k];
    alin[2] = alin[2] - gravity;
    for (int k = 0; k < 3; ++k) {
      ra[k] = clampf(ra[k] + dt * wdot[k], -vmax, vmax);
      rv[k] = clampf(rv[k] + dt * alin[k], -vmax, vmax);
      rp[k] = rp[k] + dt * rv[k];
    }

    // q' = normalize(exp(dt * w) * q), positive hemisphere
    float ex = dt * ra[0], ey = dt * ra[1], ez = dt * ra[2];
    float angle = sqrtf(ex * ex + ey * ey + ez * ez);
    float inv = 1.0f / fmaxf(angle, 1e-8f);
    bool small = angle <= 1e-5f;
    float half = 0.5f * (small ? 0.0f : angle);
    float sh = sinf(half) * inv;
    float dw = cosf(half);
    float dx = small ? 0.0f : ex * sh, dy = small ? 0.0f : ey * sh, dz = small ? 0.0f : ez * sh;
    float w2 = rq[0], x2 = rq[1], y2 = rq[2], z2 = rq[3];
    float w = dw * w2 - dx * x2 - dy * y2 - dz * z2;
    float x = dw * x2 + dx * w2 + dy * z2 - dz * y2;
    float y = dw * y2 - dx * z2 + dy * w2 + dz * x2;
    float z = dw * z2 + dx * y2 - dy * x2 + dz * w2;
    float sign = w < 0.0f ? -1.0f : 1.0f;
    float nrm = 1.0f / sqrtf(fmaxf(w * w + x * x + y * y + z * z, 1e-12f));
    rq[0] = w * sign * nrm;
    rq[1] = x * sign * nrm;
    rq[2] = y * sign * nrm;
    rq[3] = z * sign * nrm;
  });

  // ------------- ABA pass 3 and joint integration, shallowest level first
  for (int lev = 1; lev <= m.levels(); ++lev)
    team.each(m.nb, [&](int i) {
      if (m.depth(i) != lev) return;
      const int p = m.parent(i), j = i - 1;
      float Mi[9], an[3], af[3], r[3], ax[3], Ut[3], Ub[3];
      agt_ld<9>(s.M, i, Mi);
      agt_ld<3>(s.pn, p, an);
      agt_ld<3>(s.pf, p, af);
      agt_ld<3>(s.Ut, i, Ut);
      agt_ld<3>(s.Ub, i, Ub);
      for (int k = 0; k < 3; ++k) {
        r[k] = m.body(27 + k, i);
        ax[k] = m.body(30 + k, i);
      }
      float wl[3], vl[3], t[3], dvv[3];
      mtv33(Mi, an, wl);
      for (int k = 0; k < 3; ++k) wl[k] += s.cn[k][i];
      cross3(r, an, t);
      for (int k = 0; k < 3; ++k) dvv[k] = af[k] - t[k];
      mtv33(Mi, dvv, vl);
      for (int k = 0; k < 3; ++k) vl[k] += s.cf[k][i];
      float qdd = (s.u[i] - (dot3(Ut, wl) + dot3(Ub, vl))) * s.dinv[i];
      for (int k = 0; k < 3; ++k) { s.pn[k][i] = wl[k] + ax[k] * qdd; s.pf[k][i] = vl[k]; }

      // joint integration (uses only this dof's own state)
      float lo = m.dof(3, j), hi = m.dof(4, j);
      float nqd = clampf(s.qd[j] + dt * qdd, -vmax, vmax);
      float nq = s.q[j] + dt * nqd;
      if (nq > hi && nqd > 0.0f) nqd = 0.0f;
      if (nq < lo && nqd < 0.0f) nqd = 0.0f;
      s.q[j] = clampf(nq, lo, hi);
      s.qd[j] = nqd;
    });
}

// One control step for env e, by `team`.  `in` rows (env-minor, N = n):
//   root_pos 3, root_quat 4, root_vel 3, root_ang_vel 3, q nd, qd nd,
//   prev_target nd, command nd; the per-env variant then kp nd, kv nd,
//   mu 1, ms 1; then 6 narrowphase rows for each of the n_np bodies
// `out` rows: root_pos 3, root_quat 4, root_vel 3, root_ang_vel 3, q nd,
//   qd nd, applied target nd, contact nb
template <bool kPerEnv, class Team, class Scratch>
AGT_HD void agt_control_step_env(const Team& team, const AgtModel& m, Scratch& s,
                                 const float* in, float* out, int n, int e) {
  const int nd = m.nd;
  const float margin = m.hdr(2), max_delta = m.hdr(3);
  in += e;
  out += e;
  AgtEnvParams<kPerEnv> P;
  P.n = n;
  if (kPerEnv) {
    const float* pe = in + (13 + 4 * nd) * n;
    P.kp = pe;
    P.kv = pe + nd * n;
    P.mu = pe[2 * nd * n];
    P.ms = pe[(2 * nd + 1) * n];
  } else {
    P.kp = m.dofs() + 5 * nd;
    P.kv = m.dofs() + 6 * nd;
    P.mu = m.hdr(4);
    P.ms = 1.0f;
  }
  // state in: root row t < 13, dof t < nd with its PD target (clamp + slew)
  const int rows = nd > 13 ? nd : 13;
  team.each(rows, [&](int t) {
    if (t < 13) s.root[t] = in[t * n];
    if (t < nd) {
      const float* q_in = in + 13 * n;
      s.q[t] = q_in[t * n];
      s.qd[t] = q_in[(nd + t) * n];
      float prev = q_in[(2 * nd + t) * n];
      float cmd = q_in[(3 * nd + t) * n];
      float c = clampf(cmd, m.dof(3, t) + margin, m.dof(4, t) - margin);
      s.tgt[t] = prev + clampf(c - prev, -max_delta, max_delta);
    }
  });

  if (m.npair > 0) agt_fk(team, m, s);
  const int np_row = 13 + 4 * nd + (kPerEnv ? 2 * nd + 2 : 0);
  agt_held_wrenches(team, m, s, in + np_row * n, n);

  float* contact = out + (13 + 3 * nd) * n;
  for (int st = 0; st < m.substeps; ++st)
    agt_substep(team, m, P, s, st == m.substeps - 1 ? contact : (float*)0, n);

  team.each(rows, [&](int t) {
    if (t < 13) out[t * n] = s.root[t];
    if (t < nd) {
      float* q_out = out + 13 * n;
      q_out[t * n] = s.q[t];
      q_out[(nd + t) * n] = s.qd[t];
      q_out[(2 * nd + t) * n] = s.tgt[t];
    }
  });
}
