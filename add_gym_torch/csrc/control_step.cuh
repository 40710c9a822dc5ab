// One physics control step for one env: the per-env body of the CUDA
// kernel in control_step.cu.
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
// Design and what bounds it.  One thread runs one env start to finish,
// so there is no cross-thread communication.  Every per-env tensor is
// env-minor ([rows, N] f32, row r of env e at r*N + e), so a warp's 32
// threads read and write 32 neighbouring floats.  The model constants live
// in one packed f32 buffer and one i32 buffer (layout below, written by
// add_gym_torch/physics/cuda_step.py::pack_model), read through the cache
// by every thread alike.  The per-env working set (the articulated-inertia
// blocks A/B/D, bias forces, FK frames: about 90 floats per body, some
// 11 KB for 30 bodies) is far beyond 255 registers, so it lives in local
// memory and streams through L1/L2.  The kernel is therefore bound by that
// local-memory traffic and by f32 arithmetic, not by its state I/O
// (13 + 4*nd floats in, plus 2*nd + 2 in the per-env variant and 6*n_np
// narrowphase rows, 13 + 3*nd + nb out per env).  A cooperative layout
// (a warp per env, blocks in shared memory) is the way past that bound.
//
// AGT_HD marks the functions for both compilers: nvcc builds them into
// the kernel; a host compiler can build them too, which lets the CPU tests
// check this arithmetic against the plain version.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define AGT_HD __host__ __device__ __forceinline__
#else
#define AGT_HD inline
#endif

#define AGT_MAX_BODIES 32

// f32 buffer layout (offsets in floats):
//   header   [AGT_HDR]:        dt, max_torque, position_limit_margin,
//                              max_target_delta, friction_mu, gravity, 0, 0
//   bodies   [nb][AGT_BODY]:   C0[9] C1[9] C2[9] r[3] axis[3] IA_A[9]
//                              IA_B[9] mass  (M_i = C0 + cos C1 + sin C2)
//   dofs     [nd][AGT_DOF]:    armature damping frictionloss lo hi kp kv
//   points   [ncp][AGT_PT]:    pos[3] radius k b stick_mass (CSR by body)
//   spheres  [nsph][AGT_SPH]:  pos[3] radius
//   pairs    [npair][AGT_PAIR]: radius_sum k_sc b_sc
// i32 buffer: parent[nb], cp_start[nb + 1], sph_body[nsph], pair[npair][2],
//             np_body[n_np] (sorted bodies of the narrowphase rows)
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
};

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
// the shared values in the model buffer's dof rows (stride AGT_DOF) and mu
// the header's; nothing is scaled by mass.  kPerEnv = true: kp/kv are
// env-minor input rows (stride n) and mu, ms this env's values.
template <bool kPerEnv>
struct AgtEnvParams {
  const float* kp;  // kp of dof j at kp[j * stride]
  const float* kv;
  int n;            // env count: the row stride of the per-env variant
  float mu, ms;
  AGT_HD float kp_of(int j) const { return kp[j * (kPerEnv ? n : AGT_DOF)]; }
  AGT_HD float kv_of(int j) const { return kv[j * (kPerEnv ? n : AGT_DOF)]; }
  AGT_HD float scale(float x) const { return kPerEnv ? x * ms : x; }
};

struct AgtEnvScratch {
  float W[AGT_MAX_BODIES][9];    // body -> world rotation
  float M[AGT_MAX_BODIES][9];    // parent -> body joint rotation
  float o[AGT_MAX_BODIES][3];    // world origin
  float om[AGT_MAX_BODIES][3];   // world angular velocity
  float vel[AGT_MAX_BODIES][3];  // world origin linear velocity
  float A[AGT_MAX_BODIES][9];    // articulated inertia blocks [[A, B], [B^T, D]]
  float B[AGT_MAX_BODIES][9];
  float D[AGT_MAX_BODIES][9];
  float pn[AGT_MAX_BODIES][3];   // bias force (angular, linear); pass 3 reuses
  float pf[AGT_MAX_BODIES][3];   // these rows for the spatial accelerations
  float cn[AGT_MAX_BODIES][3];   // velocity-product accelerations
  float cf[AGT_MAX_BODIES][3];
  float Ut[AGT_MAX_BODIES][3];   // U = Ia S (angular, linear)
  float Ub[AGT_MAX_BODIES][3];
  float dinv[AGT_MAX_BODIES];
  float u[AGT_MAX_BODIES];
  float scn[AGT_MAX_BODIES][3];  // held self-collision + narrowphase torque / force (world)
  float scf[AGT_MAX_BODIES][3];
  float q[AGT_MAX_BODIES], qd[AGT_MAX_BODIES], tgt[AGT_MAX_BODIES], tau[AGT_MAX_BODIES];
};

AGT_HD void agt_fk(const AgtModel& m, AgtEnvScratch& s, const float* rp, const float* rq,
                   const float* rv, const float* ra) {
  const float* F = m.f;
  const int* parent = m.ib;
  float w = rq[0], x = rq[1], y = rq[2], z = rq[3];
  float sc = 2.0f / (w * w + x * x + y * y + z * z);
  float* W0 = s.W[0];
  W0[0] = 1 - sc * (y * y + z * z); W0[1] = sc * (x * y - z * w); W0[2] = sc * (x * z + y * w);
  W0[3] = sc * (x * y + z * w); W0[4] = 1 - sc * (x * x + z * z); W0[5] = sc * (y * z - x * w);
  W0[6] = sc * (x * z - y * w); W0[7] = sc * (y * z + x * w); W0[8] = 1 - sc * (x * x + y * y);
  for (int k = 0; k < 3; ++k) {
    s.o[0][k] = rp[k];
    s.om[0][k] = ra[k];
    s.vel[0][k] = rv[k];
  }
  for (int i = 1; i < m.nb; ++i) {
    const float* bc = F + AGT_HDR + i * AGT_BODY;
    int p = parent[i];
    float c = cosf(s.q[i - 1]), sn = sinf(s.q[i - 1]);
    for (int k = 0; k < 9; ++k) s.M[i][k] = bc[k] + c * bc[9 + k] + sn * bc[18 + k];
    mm33(s.W[p], s.M[i], s.W[i]);
    float rw[3], axw[3], t[3];
    mv33(s.W[p], bc + 27, rw);
    mv33(s.W[i], bc + 30, axw);
    cross3(s.om[p], rw, t);
    for (int k = 0; k < 3; ++k) {
      s.o[i][k] = s.o[p][k] + rw[k];
      s.om[i][k] = s.om[p][k] + axw[k] * s.qd[i - 1];
      s.vel[i][k] = s.vel[p][k] + t[k];
    }
  }
}

// Held self-collision forces from the current FK frames into scn/scf.
AGT_HD void agt_self_collision(const AgtModel& m, AgtEnvScratch& s) {
  const float* sph = m.f + AGT_HDR + m.nb * AGT_BODY + m.nd * AGT_DOF + m.ncp * AGT_PT;
  const float* pr = sph + m.nsph * AGT_SPH;
  const int* sph_body = m.ib + 2 * m.nb + 1;
  const int* pairs = sph_body + m.nsph;
  for (int i = 0; i < m.nb; ++i)
    for (int k = 0; k < 3; ++k) s.scn[i][k] = s.scf[i][k] = 0.0f;
  for (int qq = 0; qq < m.npair; ++qq) {
    int sa = pairs[2 * qq], sb = pairs[2 * qq + 1];
    int ba = sph_body[sa], bb = sph_body[sb];
    float ra_[3], rb_[3], xa[3], xb[3], va[3], vb[3], t[3];
    mv33(s.W[ba], sph + sa * AGT_SPH, ra_);
    mv33(s.W[bb], sph + sb * AGT_SPH, rb_);
    cross3(s.om[ba], ra_, t);
    for (int k = 0; k < 3; ++k) { xa[k] = s.o[ba][k] + ra_[k]; va[k] = s.vel[ba][k] + t[k]; }
    cross3(s.om[bb], rb_, t);
    for (int k = 0; k < 3; ++k) { xb[k] = s.o[bb][k] + rb_[k]; vb[k] = s.vel[bb][k] + t[k]; }
    float d[3], dv[3], n[3];
    for (int k = 0; k < 3; ++k) { d[k] = xa[k] - xb[k]; dv[k] = va[k] - vb[k]; }
    float dist = sqrtf(dot3(d, d) + 1e-12f);
    const float* pc = pr + qq * AGT_PAIR;
    float pen = pc[0] - dist;
    for (int k = 0; k < 3; ++k) n[k] = d[k] / dist;
    float vn = dot3(dv, n);
    float fmag = pen > 0.0f ? fmaxf(pc[1] * pen - pc[2] * vn, 0.0f) : 0.0f;
    float f[3], ta[3], tb[3];
    for (int k = 0; k < 3; ++k) f[k] = n[k] * fmag;
    cross3(ra_, f, ta);
    cross3(rb_, f, tb);
    for (int k = 0; k < 3; ++k) {
      s.scn[ba][k] += ta[k];
      s.scf[ba][k] += f[k];
      s.scn[bb][k] -= tb[k];
      s.scf[bb][k] -= f[k];
    }
  }
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

// One substep; writes the per-body contact force to `contact` when non-null.
template <bool kPerEnv>
AGT_HD void agt_substep(const AgtModel& m, const AgtEnvParams<kPerEnv>& P, AgtEnvScratch& s,
                        float* rp, float* rq, float* rv, float* ra, float* contact, int n) {
  const float* F = m.f;
  const float dt = F[0], max_torque = F[1], mu = P.mu, gravity = F[5];
  const float* dofc = F + AGT_HDR + m.nb * AGT_BODY;
  const float* ptc = dofc + m.nd * AGT_DOF;
  const int* parent = m.ib;
  const int* cp_start = m.ib + m.nb;
  const int nb = m.nb, nd = m.nd;

  agt_fk(m, s, rp, rq, rv, ra);

  // ------------------------- contacts + ABA pass 1 (independent per body)
  for (int i = 0; i < nb; ++i) {
    const float* bc = F + AGT_HDR + i * AGT_BODY;
    const float* W = s.W[i];
    float fw[3] = {0.0f, 0.0f, 0.0f}, nw[3] = {0.0f, 0.0f, 0.0f}, csum = 0.0f;
    for (int pt = cp_start[i]; pt < cp_start[i + 1]; ++pt) {
      const float* pc = ptc + pt * AGT_PT;
      float r[3], t[3], v[3];
      mv33(W, pc, r);
      cross3(s.om[i], r, t);
      for (int k = 0; k < 3; ++k) v[k] = s.vel[i][k] + t[k];
      float phi = (s.o[i][2] + r[2]) - pc[3];
      float pen = fmaxf(-phi, 0.0f);
      float fn = phi < 0.0f ? fmaxf(pc[4] * pen - pc[5] * v[2], 0.0f) : 0.0f;
      float speed = sqrtf(v[0] * v[0] + v[1] * v[1] + 1e-10f);
      float ftm = fminf(mu * fn, pc[6] * speed / dt);
      float scale = -ftm / speed;
      float f[3] = {scale * v[0], scale * v[1], fn}, nn[3];
      cross3(r, f, nn);
      for (int k = 0; k < 3; ++k) { fw[k] += f[k]; nw[k] += nn[k]; }
      csum += fn;
    }
    if (contact) contact[i * n] = P.scale(csum);
    for (int k = 0; k < 3; ++k) {
      nw[k] = P.scale(nw[k] + s.scn[i][k]);
      fw[k] = P.scale(fw[k] + s.scf[i][k]);
    }

    float wb[3], vb[3];
    mtv33(W, s.om[i], wb);
    mtv33(W, s.vel[i], vb);
    if (i > 0) {
      float wJ[3];
      for (int k = 0; k < 3; ++k) wJ[k] = bc[30 + k] * s.qd[i - 1];
      cross3(wb, wJ, s.cn[i]);
      cross3(vb, wJ, s.cf[i]);
    } else {
      for (int k = 0; k < 3; ++k) s.cn[i][k] = s.cf[i][k] = 0.0f;
    }
    const float* IA = bc + 33;
    const float* IB = bc + 42;
    const float mass = bc[51];
    for (int k = 0; k < 9; ++k) {
      s.A[i][k] = P.scale(IA[k]);
      s.B[i][k] = P.scale(IB[k]);
      s.D[i][k] = (k % 4 == 0) ? P.scale(mass) : 0.0f;
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
    for (int k = 0; k < 3; ++k) { s.pn[i][k] = bn[k] - en[k]; s.pf[i][k] = bf[k] - ef[k]; }
  }

  // -------------------------------------------------------- joint torques
  for (int j = 0; j < nd; ++j) {
    const float* dc = dofc + j * AGT_DOF;
    float q = s.q[j], qd = s.qd[j];
    float tpd = clampf(P.kp_of(j) * (s.tgt[j] - q) - P.kv_of(j) * qd, -max_torque, max_torque);
    s.tau[j] = tpd - dc[1] * qd - dc[2] * tanhf(qd / 0.05f)
               + 400.0f * fmaxf(dc[3] - q, 0.0f) - 400.0f * fmaxf(q - dc[4], 0.0f);
  }

  // ----------------------------------------------------------- ABA pass 2
  for (int i = nb - 1; i > 0; --i) {
    const float* bc = F + AGT_HDR + i * AGT_BODY;
    const float* dc = dofc + (i - 1) * AGT_DOF;
    const float* ax = bc + 30;
    const float* r = bc + 27;
    const float* Mi = s.M[i];
    int p = parent[i];
    float* Ut = s.Ut[i];
    float* Ub = s.Ub[i];
    mv33(s.A[i], ax, Ut);
    mtv33(s.B[i], ax, Ub);
    float d = dot3(Ut, ax) + dc[0] + dt * (dc[1] + P.kv_of(i - 1));
    float dinv = 1.0f / d;
    float u = s.tau[i - 1] - dot3(ax, s.pn[i]);
    s.dinv[i] = dinv;
    s.u[i] = u;

    float Ap[9], Bp[9], Dp[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        Ap[a * 3 + b] = s.A[i][a * 3 + b] - Ut[a] * Ut[b] * dinv;
        Bp[a * 3 + b] = s.B[i][a * 3 + b] - Ut[a] * Ub[b] * dinv;
        Dp[a * 3 + b] = s.D[i][a * 3 + b] - Ub[a] * Ub[b] * dinv;
      }
    float ud = u * dinv;
    float t1[3], t2[3], pan[3], paf[3];
    mv33(Ap, s.cn[i], t1);
    mv33(Bp, s.cf[i], t2);
    for (int k = 0; k < 3; ++k) pan[k] = s.pn[i][k] + t1[k] + t2[k] + Ut[k] * ud;
    mtv33(Bp, s.cn[i], t1);
    mv33(Dp, s.cf[i], t2);
    for (int k = 0; k < 3; ++k) paf[k] = s.pf[i][k] + t1[k] + t2[k] + Ub[k] * ud;

    // to parent coords: n_p = M pan + r x (M paf); f_p = M paf
    float mpan[3], mpaf[3], rxm[3];
    mv33(Mi, pan, mpan);
    mv33(Mi, paf, mpaf);
    cross3(r, mpaf, rxm);
    for (int k = 0; k < 3; ++k) {
      s.pn[p][k] += mpan[k] + rxm[k];
      s.pf[p][k] += mpaf[k];
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
        s.A[p][k] += ((Ah[k] - Bh_rx[k]) - Bh_rx[b * 3 + a]) - rx_Dh_rx[k];
        s.B[p][k] += Bh[k] + rx_Dh[k];
        s.D[p][k] += Dh[k];
      }
  }

  // ----------------------------------------------------------- ABA pass 3
  // spatial accelerations overwrite the bias rows: pn/pf[i] hold a_n/a_f[i]
  float rhs[6], a0[6];
  for (int k = 0; k < 3; ++k) { rhs[k] = -s.pn[0][k]; rhs[3 + k] = -s.pf[0][k]; }
  agt_solve6(s.A[0], s.B[0], s.D[0], rhs, a0);
  for (int k = 0; k < 3; ++k) { s.pn[0][k] = a0[k]; s.pf[0][k] = a0[3 + k]; }

  const float vmax = 100.0f;
  for (int i = 1; i < nb; ++i) {
    const float* bc = F + AGT_HDR + i * AGT_BODY;
    const float* dc = dofc + (i - 1) * AGT_DOF;
    const float* r = bc + 27;
    const float* ax = bc + 30;
    int p = parent[i];
    float wl[3], vl[3], t[3], dvv[3];
    mtv33(s.M[i], s.pn[p], wl);
    for (int k = 0; k < 3; ++k) wl[k] += s.cn[i][k];
    cross3(r, s.pn[p], t);
    for (int k = 0; k < 3; ++k) dvv[k] = s.pf[p][k] - t[k];
    mtv33(s.M[i], dvv, vl);
    for (int k = 0; k < 3; ++k) vl[k] += s.cf[i][k];
    float qdd = (s.u[i] - (dot3(s.Ut[i], wl) + dot3(s.Ub[i], vl))) * s.dinv[i];
    for (int k = 0; k < 3; ++k) { s.pn[i][k] = wl[k] + ax[k] * qdd; s.pf[i][k] = vl[k]; }

    // joint integration (uses only this dof's own state)
    int j = i - 1;
    float lo = dc[3], hi = dc[4];
    float nqd = clampf(s.qd[j] + dt * qdd, -vmax, vmax);
    float nq = s.q[j] + dt * nqd;
    if (nq > hi && nqd > 0.0f) nqd = 0.0f;
    if (nq < lo && nqd < 0.0f) nqd = 0.0f;
    s.q[j] = clampf(nq, lo, hi);
    s.qd[j] = nqd;
  }

  // ------------------------------------------------------ root integration
  float wdot[3], alin[3], t[3];
  mv33(s.W[0], s.pn[0], wdot);
  mv33(s.W[0], s.pf[0], alin);
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
}

// Add the narrowphase rows (`rows`: 6 per touched body, env-minor, env
// offset applied) into the held wrenches: torque rows 0-2, force rows 3-5.
AGT_HD void agt_add_np_rows(const AgtModel& m, AgtEnvScratch& s, const float* rows, int n) {
  const int* np_body = m.ib + 2 * m.nb + 1 + m.nsph + 2 * m.npair;
  for (int j = 0; j < m.n_np; ++j) {
    int b = np_body[j];
    const float* r = rows + 6 * j * n;
    for (int k = 0; k < 3; ++k) {
      s.scn[b][k] += r[k * n];
      s.scf[b][k] += r[(3 + k) * n];
    }
  }
}

// One control step for env e.  `in` rows (env-minor, N = n):
//   root_pos 3, root_quat 4, root_vel 3, root_ang_vel 3, q nd, qd nd,
//   prev_target nd, command nd; the per-env variant then kp nd, kv nd,
//   mu 1, ms 1; then 6 narrowphase rows for each of the n_np bodies
// `out` rows: root_pos 3, root_quat 4, root_vel 3, root_ang_vel 3, q nd,
//   qd nd, applied target nd, contact nb
template <bool kPerEnv = false>
AGT_HD void agt_control_step_env(const AgtModel& m, AgtEnvScratch& s, const float* in,
                                 float* out, int n, int e) {
  const float* F = m.f;
  const int nd = m.nd;
  const float margin = F[2], max_delta = F[3];
  const float* dofc = F + AGT_HDR + m.nb * AGT_BODY;
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
    P.kp = dofc + 5;
    P.kv = dofc + 6;
    P.mu = F[4];
    P.ms = 1.0f;
  }
  float rp[3], rq[4], rv[3], ra[3];
  for (int k = 0; k < 3; ++k) {
    rp[k] = in[k * n];
    rv[k] = in[(7 + k) * n];
    ra[k] = in[(10 + k) * n];
  }
  for (int k = 0; k < 4; ++k) rq[k] = in[(3 + k) * n];
  const float* q_in = in + 13 * n;
  for (int j = 0; j < nd; ++j) {
    const float* dc = dofc + j * AGT_DOF;
    s.q[j] = q_in[j * n];
    s.qd[j] = q_in[(nd + j) * n];
    float prev = q_in[(2 * nd + j) * n];
    float cmd = q_in[(3 * nd + j) * n];
    // PD target clamp + slew limit
    float t = clampf(cmd, dc[3] + margin, dc[4] - margin);
    s.tgt[j] = prev + clampf(t - prev, -max_delta, max_delta);
  }

  if (m.npair > 0) {
    agt_fk(m, s, rp, rq, rv, ra);
    agt_self_collision(m, s);
  } else {
    for (int i = 0; i < m.nb; ++i)
      for (int k = 0; k < 3; ++k) s.scn[i][k] = s.scf[i][k] = 0.0f;
  }
  if (m.n_np > 0) {
    const int np_row = 13 + 4 * nd + (kPerEnv ? 2 * nd + 2 : 0);
    agt_add_np_rows(m, s, in + np_row * n, n);
  }

  float* contact = out + (13 + 3 * nd) * n;
  for (int st = 0; st < m.substeps; ++st)
    agt_substep(m, P, s, rp, rq, rv, ra, st == m.substeps - 1 ? contact : (float*)0, n);

  for (int k = 0; k < 3; ++k) {
    out[k * n] = rp[k];
    out[(7 + k) * n] = rv[k];
    out[(10 + k) * n] = ra[k];
  }
  for (int k = 0; k < 4; ++k) out[(3 + k) * n] = rq[k];
  float* q_out = out + 13 * n;
  for (int j = 0; j < nd; ++j) {
    q_out[j * n] = s.q[j];
    q_out[(nd + j) * n] = s.qd[j];
    q_out[(2 * nd + j) * n] = s.tgt[j];
  }
}
