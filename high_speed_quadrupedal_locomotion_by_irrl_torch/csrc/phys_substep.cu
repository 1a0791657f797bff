// Compliant-contact physics for Hopper (sm_90a): one substep, and a whole
// control step (n substeps, each after a PD torque) in one launch.
//
// Replaces the TPU kernel ops/phys_pallas.py::_kernel of the JAX package,
// whose body is ops/phys_lanes.substep_lanes: FK over the 13-body tree,
// spatial body velocities, penalty contact at the 4 toe spheres and the 8
// base-box corners (corners at 0.25 kn / 0.25 dn), the base wrench, RNEA bias
// at qdd = 0, the CRBA mass matrix plus rotor inertias, an SPD solve and
// semi-implicit Euler with an exp-map quaternion update. The plain PyTorch
// version is ops/phys_lanes.substep; the control step's is
// ops/phys_cuda.control_step_plain (PD torque, motor model and envelope clamp
// of ops/pd_torque.py before every substep).
//
// What bounds it: not HBM bytes (~1.3 KB an env against ~10k flops) and not
// the card's flop rate, but the latency of one dependent scalar chain per
// thread at low occupancy. So the design shortens the chain and spreads it:
//
// * Four lanes an env, one per leg. 12 of the 13 bodies hang in four
//   independent 3-link chains off the base, so a lane holds only its own
//   leg's three bodies (indexed by constants, so they stay in registers) and
//   the base. Lane = 8 * leg + env-in-warp: a warp carries 8 envs, the four
//   lanes of an env sit 8 apart and add up with __shfl_xor_sync over 8 and
//   16, and the 8 lanes of a leg store 8 neighbouring floats of a row.
//   Blocks are one warp, so 1024 envs are 128 blocks on 128 SMs. Lanes past
//   the ragged edge compute on a clamped env index and only their stores are
//   masked: every lane reaches every shuffle.
// * Sums before projections. Everything is expressed at the world origin, so
//   net forces and spatial inertias (kept as mass, first moment and the
//   symmetric rotational block: 10 numbers, not 36) add along a leg before
//   they meet a motion-subspace column: RNEA and CRBA in their composite
//   form. Body inertias are taken as symmetric, as every physical one is.
// * Legs are eliminated first. With dofs (base 6 | 4 x leg 3) the mass matrix
//   is block-arrow: each lane factors its own 3x3 block, forms Y = M_bl L^-T,
//   and the four lanes sum the Schur complement M_bb - sum Y Y^T and the
//   reduced right-hand side (27 numbers, the one reduction of a substep);
//   every lane then solves the same 6x6 and back-substitutes its 3 joints.
//   Same solution as a dense 18x18 Cholesky up to rounding, with no fill-in.
//   Every pivot keeps the fmaxf(s, 1e-12f) guard.
// * The base body's own terms are computed by all four lanes (they run in
//   lockstep anyway) and counted once, on leg 0; each lane takes 2 of the 8
//   box corners.
// * phys_control_step_kernel keeps the state in registers over the substeps
//   and computes each lane's 3 joint torques itself; the PD gains and the
//   motor envelope arrive by value. The Convert2Torque inputs (a torque
//   feedforward and a PD scale, (12, B) each, held over the control step)
//   are two nullable pointers read once a lane: a null one reads as 0 and 1,
//   which x 1 and + 0 leave exact, so the PD path is the same instruction
//   stream whether or not they are given.
// * Terrain (phys_control_step_kernel only; phys_substep_kernel ports the
//   flat Pallas kernel). A sampled heightmap shared by all envs, (ny, nx)
//   float32 (10 MB at the reference's 5000 x 500, so it stays in the 50 MB
//   L2), and per env a map offset, a cell size and a height scale. Each lane
//   looks the ground up under its toe and its two base corners, three
//   bilinear lookups a substep, in the JAX package's order of operations
//   (phys/terrain._sampled_height) with rounded intrinsics, so that no
//   contraction moves a point across a cell edge; the contact normal stays
//   vertical (phys_lanes._contact_point). The grid is read through the
//   read-only path; the pointers travel in one struct by value (kernel
//   parameter space, no registers until used). A null grid is flat ground:
//   the height reads 0 and pos - 0 keeps the flat path's bits.
// * The analytic fractal (phys/terrain.TerrainParams, cfg.terrain_sampled
//   False): value noise of 3 octaves with a per-env seed and height scale,
//   looked up where the heightmap is (toe and two corners a lane, vertical
//   normal), each lookup 3 octaves x 4 hashes fract(sin(.) * 43758.5453).
//   The hash multiplies a one-ulp difference of its sine argument by ~4e4,
//   so every operation before it is rounded on its own in the JAX order
//   (phys/terrain._hash2, _value_noise): an FMA contraction would give
//   another terrain. The sine is the precise sinf (no fast math): arguments
//   reach ~1.2e5, past its fast range, where it reduces through a local
//   array. It is its own instantiation of the kernel (the ground is a
//   template parameter), so the heightmap and flat code is what it was.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;        // one warp a block: 8 envs x 4 legs
constexpr int kEnvsPerWarp = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// packed parameter rows (ops/phys_pallas.pack_params layout)
constexpr int kRowMass = 0;       // 13
constexpr int kRowCom = 13;       // 13 x 3
constexpr int kRowInertia = 52;   // 13 x 3 x 3
constexpr int kRowJoint = 169;    // 12 x 3
constexpr int kRowFriction = 205;
constexpr int kRowKn = 206;
constexpr int kRowDn = 207;

// output rows: gc' 19 | gv' 18 | toe 12 | toe vel 12 | |f| 4 | fn 4 | torque 12
// (the torque rows only in the control step's output)
constexpr int kOutGv = 19;
constexpr int kOutToe = 37;
constexpr int kOutToeVel = 49;
constexpr int kOutFnorm = 61;
constexpr int kOutFn = 65;
constexpr int kOutTau = 69;

constexpr float kGravityZ = -9.81f;
constexpr float kToeOffsetZ = -0.19f;
constexpr float kToeRadius = 0.0275f;
constexpr float kJointDamping = 0.01f;
constexpr float kBoxHalfX = 0.15f, kBoxHalfY = 0.10f, kBoxHalfZ = 0.05f;

// Static topology (phys/model.py): link k of every leg is abduct, thigh,
// shank; the abduct joint turns about +x, hip and knee about -y, all in the
// parent frame.
__device__ __forceinline__ constexpr float rotor_inertia(int k) {
  return k == 2 ? 0.008966f : 0.003708f;
}

// PD gains and motor envelope by link of a leg, and the electrical motor
// model (ops/pd_torque.real_torque); filled by the host from ops/pd_torque.py,
// which alone holds the values.
struct PdConsts {
  float kp[3], kd[3], knee_ratio[3], gear[3];
  float max_torque, critical_speed, max_speed, slope;  // slope = max_torque / (max - critical)
  float motor_kt, motor_r, motor_tau_max, motor_battery_v, motor_damping, motor_friction;
  int motor_dynamics;
};

// What one lane keeps of its env between substeps.
struct LaneState {
  float gb[7];   // base position, quaternion wxyz
  float vb[6];   // base linear, angular velocity (world)
  float q[3], qd[3];  // own leg's joints
};

// The heightmap and the per-env terrain rows (offset (2, B), cell and height
// scale (B,)); grid == nullptr is flat ground. gx_max / gy_max are the
// clip limits nx - 1.001 and ny - 1.001, rounded to float on the host.
struct Terrain {
  const float* grid;
  const float* offset;
  const float* cell;
  const float* z_scale;
  int nx, ny;
  float gx_max, gy_max;
};

// The analytic fractal's per-env rows, (B,) each.
struct AnalyticTerrain {
  const float* seed;
  const float* z_scale;
};

struct LaneDiag {
  float toe[3], toe_vel[3], fnorm, fn;
};

// Spatial inertia about the world origin: mass, first moment m c, and the
// rotational block I_w + m [c]x [c]x^T as xx xy xz yy yz zz.
struct SpatialInertia {
  float m, h[3], I[6];
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) s += a[k] * b[k];
  return s;
}

// Sum over the four lanes of an env; every lane gets the same bits.
__device__ __forceinline__ float env_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 8);
  x += __shfl_xor_sync(kFullMask, x, 16);
  return x;
}

// Rotation matrices are row-major float[9].
__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}

// One link of FK: anchor = pp + Rp jo, R = Rp Rodrigues(axis, angle), with the
// static axis +x (kAxisX) or -y written out; the world axis is a column of Rp.
template <bool kAxisX>
__device__ __forceinline__ void fk_link(const float* Rp, const float* pp, const float* jo,
                                        float angle, float* R, float* anchor, float* axis_w) {
  const float c = cosf(angle), s = sinf(angle);
  const float d = c + (1.0f - c);  // the plain version's c + a*a*(1 - c) on the axis
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = Rp[3 * i], r1 = Rp[3 * i + 1], r2 = Rp[3 * i + 2];
    anchor[i] = pp[i] + r0 * jo[0] + r1 * jo[1] + r2 * jo[2];
    if (kAxisX) {
      R[3 * i] = r0 * d;
      R[3 * i + 1] = r1 * c + r2 * s;
      R[3 * i + 2] = r2 * c - r1 * s;
      axis_w[i] = r0;
    } else {
      R[3 * i] = r0 * c + r2 * s;
      R[3 * i + 1] = r1 * d;
      R[3 * i + 2] = r2 * c - r0 * s;
      axis_w[i] = -r1;
    }
  }
}

// Ground height under (x, y) for env e: clip, floor, bilinear weights and the
// scale in the order of phys/terrain._bilinear, each operation rounded on its
// own; 0 on flat ground.
__device__ __forceinline__ float ground_height(const Terrain& t, size_t sB, int e, float x,
                                               float y) {
  if (t.grid == nullptr) return 0.0f;
  const float cell = __ldg(t.cell + e);
  const float gx = fminf(fmaxf(__fdiv_rn(__fadd_rn(x, __ldg(t.offset + e)), cell), 0.0f),
                         t.gx_max);
  const float gy = fminf(fmaxf(__fdiv_rn(__fadd_rn(y, __ldg(t.offset + sB + e)), cell), 0.0f),
                         t.gy_max);
  const float ixf = floorf(gx), iyf = floorf(gy);
  const float fx = __fsub_rn(gx, ixf), fy = __fsub_rn(gy, iyf);
  const float gx1 = __fsub_rn(1.0f, fx), gy1 = __fsub_rn(1.0f, fy);
  const float* row = t.grid + (size_t)iyf * t.nx + (size_t)ixf;
  const float h00 = __ldg(row), h10 = __ldg(row + 1);
  const float h01 = __ldg(row + t.nx), h11 = __ldg(row + t.nx + 1);
  float s = __fmul_rn(__fmul_rn(h00, gx1), gy1);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(h10, fx), gy1));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(h01, gx1), fy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(h11, fx), fy));
  return __fmul_rn(__ldg(t.z_scale + e), s);
}

// phys/terrain._hash2 for the point's seed term sd = seed * 74.7, rounded in
// its order: (fract(sin(ix 127.1 + iy 311.7 + sd) 43758.5453)) 2 - 1.
__device__ __forceinline__ float noise_hash(float ix, float iy, float sd) {
  const float arg = __fadd_rn(__fadd_rn(__fmul_rn(ix, 127.1f), __fmul_rn(iy, 311.7f)), sd);
  const float h = __fmul_rn(sinf(arg), 43758.5453f);
  return __fsub_rn(__fmul_rn(__fsub_rn(h, floorf(h)), 2.0f), 1.0f);
}

// f^3 (f (6 f - 15) + 10), in the order of phys/terrain._value_noise.
__device__ __forceinline__ float smootherstep(float f) {
  const float inner = __fadd_rn(__fmul_rn(f, __fsub_rn(__fmul_rn(f, 6.0f), 15.0f)), 10.0f);
  return __fmul_rn(__fmul_rn(__fmul_rn(f, f), f), inner);
}

__device__ __forceinline__ float value_noise(float x, float y, float sd) {
  const float ix = floorf(x), iy = floorf(y);
  const float sx = smootherstep(__fsub_rn(x, ix)), sy = smootherstep(__fsub_rn(y, iy));
  const float ix1 = __fadd_rn(ix, 1.0f), iy1 = __fadd_rn(iy, 1.0f);
  const float sx1 = __fsub_rn(1.0f, sx), sy1 = __fsub_rn(1.0f, sy);
  float s = __fmul_rn(__fmul_rn(noise_hash(ix, iy, sd), sx1), sy1);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(noise_hash(ix1, iy, sd), sx), sy1));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(noise_hash(ix, iy1, sd), sx1), sy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(noise_hash(ix1, iy1, sd), sx), sy));
  return s;
}

// The analytic ground under (x, y) for env e (phys/terrain.analytic_height):
// octaves at frequency 1, 2, 4 and gain 1, 0.25, 0.0625 (both exact scalings).
__device__ __forceinline__ float ground_height(const AnalyticTerrain& t, size_t, int e, float x,
                                               float y) {
  const float sd = __fmul_rn(__ldg(t.seed + e), 74.7f);
  float h = value_noise(x, y, sd);
  h = __fadd_rn(h, __fmul_rn(0.25f, value_noise(__fmul_rn(x, 2.0f), __fmul_rn(y, 2.0f), sd)));
  h = __fadd_rn(h, __fmul_rn(0.0625f, value_noise(__fmul_rn(x, 4.0f), __fmul_rn(y, 4.0f), sd)));
  return __fmul_rn(__ldg(t.z_scale + e), h);
}

// Penalty contact against the ground at height `ground` under the point, with
// a vertical normal (phys_lanes._contact_point).
__device__ __forceinline__ float contact_point(const float* pos, const float* vel,
                                               float radius, float ground, float kn,
                                               float dn, float mu, float slip_vel,
                                               float impulse_scale, float* f) {
  float pen = fmaxf(radius - __fsub_rn(pos[2], ground), 0.0f);
  float active = pen > 0.0f ? 1.0f : 0.0f;
  float fn = fmaxf(kn * pen - dn * vel[2], 0.0f) * active;
  float vt_norm = sqrtf(vel[0] * vel[0] + vel[1] * vel[1] + slip_vel * slip_vel * 1e-4f);
  float ft = impulse_scale > 0.0f ? fminf(mu * fn, impulse_scale * vt_norm)
                                  : mu * fn * tanhf(vt_norm / slip_vel);
  float inv = ft / vt_norm;
  f[0] = -inv * vel[0];
  f[1] = -inv * vel[1];
  f[2] = fn;
  return fn;
}

// World-origin spatial inertia of a body with rotation R, world com cw, mass
// m and body-frame inertia Ib (phys_lanes._spatial_inertia, upper triangle).
__device__ __forceinline__ void spatial_inertia(const float* R, const float* cw, float m,
                                                const float* Ib, SpatialInertia& si) {
  float RI[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      RI[3 * i + q] = R[3 * i] * Ib[q] + R[3 * i + 1] * Ib[3 + q] + R[3 * i + 2] * Ib[6 + q];
#define IW(i, q) \
  (RI[3 * (i)] * R[3 * (q)] + RI[3 * (i) + 1] * R[3 * (q) + 1] + RI[3 * (i) + 2] * R[3 * (q) + 2])
  si.m = m;
#pragma unroll
  for (int i = 0; i < 3; ++i) si.h[i] = m * cw[i];
  si.I[0] = IW(0, 0) + m * (cw[2] * cw[2] + cw[1] * cw[1]);
  si.I[1] = IW(0, 1) + m * (-(cw[1] * cw[0]));
  si.I[2] = IW(0, 2) + m * (-(cw[2] * cw[0]));
  si.I[3] = IW(1, 1) + m * (cw[2] * cw[2] + cw[0] * cw[0]);
  si.I[4] = IW(1, 2) + m * (-(cw[2] * cw[1]));
  si.I[5] = IW(2, 2) + m * (cw[1] * cw[1] + cw[0] * cw[0]);
#undef IW
}

__device__ __forceinline__ void si_add(const SpatialInertia& a, const SpatialInertia& b,
                                       SpatialInertia& o) {
  o.m = a.m + b.m;
#pragma unroll
  for (int i = 0; i < 3; ++i) o.h[i] = a.h[i] + b.h[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) o.I[i] = a.I[i] + b.I[i];
}

// f = I v for spatial v = [w; vl], f = [n; fl].
__device__ __forceinline__ void si_apply(const SpatialInertia& si, const float* v, float* f) {
  const float* w = v;
  const float* vl = v + 3;
  float hxv[3], hxw[3];
  cross3(si.h, vl, hxv);
  cross3(si.h, w, hxw);
  f[0] = si.I[0] * w[0] + si.I[1] * w[1] + si.I[2] * w[2] + hxv[0];
  f[1] = si.I[1] * w[0] + si.I[3] * w[1] + si.I[4] * w[2] + hxv[1];
  f[2] = si.I[2] * w[0] + si.I[4] * w[1] + si.I[5] * w[2] + hxv[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) f[3 + i] = si.m * vl[i] - hxw[i];
}

// Net force on a body less its external wrench: I a + v x* (I v) - gravity
// (phys_lanes' f_net without f_ext), all about the world origin.
__device__ __forceinline__ void body_force(const SpatialInertia& si, const float* v,
                                           const float* a, float* f) {
  float Iv[6], Ia[6], cf[3], cf2[3], cff[3];
  si_apply(si, v, Iv);
  si_apply(si, a, Ia);
  cross3(v, Iv, cf);
  cross3(v + 3, Iv + 3, cf2);
  cross3(v, Iv + 3, cff);
  const float grav_z = si.m * kGravityZ;
  // gravity acts at the com: moment com x (0, 0, grav_z), with m com = h
  f[0] = Ia[0] + cf[0] + cf2[0] - si.h[1] * kGravityZ;
  f[1] = Ia[1] + cf[1] + cf2[1] + si.h[0] * kGravityZ;
  f[2] = Ia[2] + cf[2] + cf2[2];
  f[3] = Ia[3] + cff[0];
  f[4] = Ia[4] + cff[1];
  f[5] = Ia[5] + cff[2] - grav_z;
}

// A spatial force [n; f] about the world origin onto the 6 base dofs
// (columns [0; e_k] and [e_k; p0 x e_k]): [f; n + f x p0].
__device__ __forceinline__ void project_base(const float* F, const float* p0, float* o) {
  float fxp[3];
  cross3(F + 3, p0, fxp);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = F[3 + i];
    o[3 + i] = F[i] + fxp[i];
  }
}

// One substep of env e as seen by the lane of leg `leg`: updates s, fills d.
// Ground: Terrain (flat or the heightmap) or AnalyticTerrain.
template <class Ground>
__device__ __forceinline__ void substep_lane(const float* __restrict__ prm, size_t sB, int e,
                                             int leg, LaneState& s, const float* tau,
                                             const float* bw, const Ground& terr,
                                             float slip_vel, float impulse_scale, float dt,
                                             LaneDiag& d) {
#define PRM(r) __ldg(prm + (size_t)(r) * sB + e)
  const int j0 = 3 * leg;  // the leg's first joint; its bodies are j0 + 1 ...
  const float* p0 = s.gb;

  // ---- forward kinematics: base, then the leg's three links
  float R0[9];
  quat_to_mat(s.gb + 3, R0);
  float R[3][9], anchor[3][3], axis_w[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float jo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) jo[i] = PRM(kRowJoint + 3 * (j0 + k) + i);
    if (k == 0)
      fk_link<true>(R0, p0, jo, s.q[0], R[0], anchor[0], axis_w[0]);
    else
      fk_link<false>(R[k - 1], anchor[k - 1], jo, s.q[k], R[k], anchor[k], axis_w[k]);
  }
  float toe[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) toe[i] = anchor[2][i] + R[2][3 * i + 2] * kToeOffsetZ;

  // ---- motion-subspace columns S_k = [axis; anchor x axis]
  float S[3][6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) S[k][i] = axis_w[k][i];
    cross3(anchor[k], axis_w[k], &S[k][3]);
  }

  // ---- spatial velocities [w; v_O] and bias accelerations (RNEA, qdd = 0)
  float v0[6], a0[6], v[3][6], a[3][6];
  v0[0] = s.vb[3]; v0[1] = s.vb[4]; v0[2] = s.vb[5];
  v0[3] = s.vb[0] - p0[2] * s.vb[4] + p0[1] * s.vb[5];
  v0[4] = s.vb[1] + p0[2] * s.vb[3] - p0[0] * s.vb[5];
  v0[5] = s.vb[2] - p0[1] * s.vb[3] + p0[0] * s.vb[4];
  a0[0] = a0[1] = a0[2] = 0.0f;
  cross3(&s.vb[0], &s.vb[3], &a0[3]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* vp = k == 0 ? v0 : v[k - 1];
    const float* ap = k == 0 ? a0 : a[k - 1];
    float wxw[3], wxv[3], vxw[3];
    cross3(vp, &S[k][0], wxw);
    cross3(vp, &S[k][3], wxv);
    cross3(vp + 3, &S[k][0], vxw);
#pragma unroll
    for (int i = 0; i < 6; ++i) v[k][i] = vp[i] + S[k][i] * s.qd[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[k][i] = ap[i] + wxw[i] * s.qd[k];
      a[k][3 + i] = ap[3 + i] + (wxv[i] + vxw[i]) * s.qd[k];
    }
  }

  // ---- contact: the leg's toe, and 2 of the 8 base corners
  const float kn = PRM(kRowKn), dn = PRM(kRowDn), mu = PRM(kRowFriction);
  float ftoe[3], toe_wrench[6];
  {
    float wxp[3];
    cross3(&v[2][0], toe, wxp);
#pragma unroll
    for (int i = 0; i < 3; ++i) d.toe_vel[i] = v[2][3 + i] + wxp[i];
    d.fn = contact_point(toe, d.toe_vel, kToeRadius, ground_height(terr, sB, e, toe[0], toe[1]),
                         kn, dn, mu, slip_vel, impulse_scale, ftoe);
    cross3(toe, ftoe, toe_wrench);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      toe_wrench[3 + i] = ftoe[i];
      d.toe[i] = toe[i];
    }
    d.fnorm = sqrtf(ftoe[0] * ftoe[0] + ftoe[1] * ftoe[1] + ftoe[2] * ftoe[2]);
  }
  float corner_wrench[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  {
    // corner 2 * leg + c in (sx, sy, sz) order, sx outermost, each -1 then +1
    const float lx = (leg & 2) ? kBoxHalfX : -kBoxHalfX;
    const float ly = (leg & 1) ? kBoxHalfY : -kBoxHalfY;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float lz = c ? kBoxHalfZ : -kBoxHalfZ;
      float cp[3], wxp[3], cv[3], f[3], nxf[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) cp[i] = p0[i] + (R0[3 * i] * lx + R0[3 * i + 1] * ly + R0[3 * i + 2] * lz);
      cross3(v0, cp, wxp);
#pragma unroll
      for (int i = 0; i < 3; ++i) cv[i] = v0[3 + i] + wxp[i];
      contact_point(cp, cv, 0.0f, ground_height(terr, sB, e, cp[0], cp[1]), kn * 0.25f,
                    dn * 0.25f, mu, slip_vel, impulse_scale, f);
      cross3(cp, f, nxf);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        corner_wrench[i] += nxf[i];
        corner_wrench[3 + i] += f[i];
      }
    }
  }

  // ---- spatial inertias: the leg's bodies (then composite), and the base
  SpatialInertia Ic[3], Ibase;
  float fs[3][6];  // net force of link k and everything below it
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    const int b = j0 + 1 + k;
    float Ib[9], cw[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) Ib[i] = PRM(kRowInertia + 9 * b + i);
    const float c0 = PRM(kRowCom + 3 * b), c1 = PRM(kRowCom + 3 * b + 1),
                c2 = PRM(kRowCom + 3 * b + 2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cw[i] = anchor[k][i] + (R[k][3 * i] * c0 + R[k][3 * i + 1] * c1 + R[k][3 * i + 2] * c2);
    SpatialInertia si;
    spatial_inertia(R[k], cw, PRM(kRowMass + b), Ib, si);
    body_force(si, v[k], a[k], fs[k]);
    if (k == 2) {
      Ic[2] = si;
#pragma unroll
      for (int i = 0; i < 6; ++i) fs[2][i] -= toe_wrench[i];
    } else {
      si_add(si, Ic[k + 1], Ic[k]);
#pragma unroll
      for (int i = 0; i < 6; ++i) fs[k][i] += fs[k + 1][i];
    }
  }
  float fbase[6];
  {
    float Ib[9], cw[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) Ib[i] = PRM(kRowInertia + i);
    const float c0 = PRM(kRowCom), c1 = PRM(kRowCom + 1), c2 = PRM(kRowCom + 2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cw[i] = p0[i] + (R0[3 * i] * c0 + R0[3 * i + 1] * c1 + R0[3 * i + 2] * c2);
    spatial_inertia(R0, cw, PRM(kRowMass), Ib, Ibase);
    body_force(Ibase, v0, a0, fbase);
    // base wrench [f_world; n]: moment n + p0 x f about the world origin
    float pxf[3];
    cross3(p0, bw, pxf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fbase[i] -= bw[3 + i] + pxf[i];
      fbase[3 + i] -= bw[i];
    }
  }

  // ---- this lane's share of the base rows: its leg, its corners, and on
  // leg 0 the base body itself
  const bool first = leg == 0;
  SpatialInertia Ishare;
  float fshare[6];
  Ishare.m = Ic[0].m + (first ? Ibase.m : 0.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) Ishare.h[i] = Ic[0].h[i] + (first ? Ibase.h[i] : 0.0f);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Ishare.I[i] = Ic[0].I[i] + (first ? Ibase.I[i] : 0.0f);
    fshare[i] = fs[0][i] + (first ? fbase[i] : 0.0f) - corner_wrench[i];
  }
  float hb[6];  // share of the base bias
  project_base(fshare, p0, hb);
  float Mbb[6][6];  // share of the base block, column e = project(I S_e)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float col[6], F[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) col[i] = (i == 3 + k) ? 1.0f : 0.0f;  // [0; e_k]
    si_apply(Ishare, col, F);
    project_base(F, p0, Mbb[k]);
    const float ek[3] = {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) col[i] = ek[i];  // [e_k; p0 x e_k]
    cross3(p0, ek, &col[3]);
    si_apply(Ishare, col, F);
    project_base(F, p0, Mbb[3 + k]);
  }

  // ---- the leg's rows: bias, 3x3 block A, coupling C = M_bl (6x3)
  float hl[3], A[3][3], C[6][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hl[k] = dot6(S[k], fs[k]);
    float F[6], Ck[6];
    si_apply(Ic[k], S[k], F);
#pragma unroll
    for (int q = 0; q <= k; ++q) A[q][k] = dot6(S[q], F);
    A[k][k] += rotor_inertia(k);
    project_base(F, p0, Ck);
#pragma unroll
    for (int i = 0; i < 6; ++i) C[i][k] = Ck[i];
  }

  // ---- eliminate the leg: A = L L^T, Y = C L^-T, z = L^-1 r
  const float l00 = sqrtf(fmaxf(A[0][0], 1e-12f)), i0 = 1.0f / l00;
  const float l10 = A[0][1] * i0, l20 = A[0][2] * i0;
  const float l11 = sqrtf(fmaxf(A[1][1] - l10 * l10, 1e-12f)), i1 = 1.0f / l11;
  const float l21 = (A[1][2] - l20 * l10) * i1;
  const float l22 = sqrtf(fmaxf(A[2][2] - l20 * l20 - l21 * l21, 1e-12f)), i2 = 1.0f / l22;
  float Y[6][3], z[3];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    Y[r][0] = C[r][0] * i0;
    Y[r][1] = (C[r][1] - l10 * Y[r][0]) * i1;
    Y[r][2] = (C[r][2] - l20 * Y[r][0] - l21 * Y[r][1]) * i2;
  }
  {
    float r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = tau[k] - kJointDamping * s.qd[k] - hl[k];
    z[0] = r[0] * i0;
    z[1] = (r[1] - l10 * z[0]) * i1;
    z[2] = (r[2] - l20 * z[0] - l21 * z[1]) * i2;
  }

  // ---- Schur complement and reduced rhs, summed over the env's four lanes
  float Sb[6][6], x[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = r; c < 6; ++c)
      Sb[r][c] = env_sum(Mbb[c][r] - (Y[r][0] * Y[c][0] + Y[r][1] * Y[c][1] + Y[r][2] * Y[c][2]));
    x[r] = env_sum(-hb[r] - (Y[r][0] * z[0] + Y[r][1] * z[1] + Y[r][2] * z[2]));
  }

  // ---- 6x6 Cholesky solve (factor in the lower triangle, matrix in the upper)
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float t = Sb[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) t -= Sb[j][k] * Sb[j][k];
    const float ljj = sqrtf(fmaxf(t, 1e-12f));
    const float inv = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float u = Sb[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k) u -= Sb[i][k] * Sb[j][k];
      Sb[i][j] = u * inv;
    }
    Sb[j][j] = inv;  // the diagonal keeps 1 / L_jj
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= Sb[i][k] * x[k];
    x[i] = t * Sb[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = x[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t -= Sb[k][i] * x[k];
    x[i] = t * Sb[i][i];
  }

  // ---- back-substitute the leg: L^T xl = z - Y^T x
  float xl[3];
  {
    float t[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float u = z[k];
#pragma unroll
      for (int r = 0; r < 6; ++r) u -= Y[r][k] * x[r];
      t[k] = u;
    }
    xl[2] = t[2] * i2;
    xl[1] = (t[1] - l21 * xl[2]) * i1;
    xl[0] = (t[0] - l10 * xl[1] - l20 * xl[2]) * i0;
  }

  // ---- semi-implicit Euler with the exp-map quaternion update
#pragma unroll
  for (int i = 0; i < 6; ++i) s.vb[i] += dt * x[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) s.gb[i] += dt * s.vb[i];
  {
    const float qw = s.gb[3], qx = s.gb[4], qy = s.gb[5], qz = s.gb[6];
    const float ox = s.vb[3], oy = s.vb[4], oz = s.vb[5];
    const float angle = sqrtf(ox * ox + oy * oy + oz * oz);
    const float half = 0.5f * angle * dt;
    const float k = angle > 1e-9f ? sinf(half) / fmaxf(angle, 1e-12f) : 0.5f * dt;
    const float dw = cosf(half), dx = k * ox, dy = k * oy, dz = k * oz;
    const float nw = dw * qw - dx * qx - dy * qy - dz * qz;
    const float nx = dw * qx + dx * qw + dy * qz - dz * qy;
    const float ny = dw * qy - dx * qz + dy * qw + dz * qx;
    const float nz = dw * qz + dx * qy - dy * qx + dz * qw;
    const float inv = 1.0f / sqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
    s.gb[3] = nw * inv;
    s.gb[4] = nx * inv;
    s.gb[5] = ny * inv;
    s.gb[6] = nz * inv;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.qd[k] += dt * xl[k];
    s.q[k] += dt * s.qd[k];
  }
#undef PRM
}

// PD -> x pd_scale -> smoothing quirk -> + tau_ff -> motor model -> envelope
// clamp for link k of a leg (ops/pd_torque.pd_torque, elementwise; the JAX
// package's _pd_torque order).
__device__ __forceinline__ float pd_torque(const PdConsts& pd, int k, float ptarget,
                                           float torque_norm_last, float q, float qd,
                                           float pd_scale, float tau_ff) {
  float tau = pd.kp[k] * (ptarget - q) - pd.kd[k] * qd;
  tau = tau * pd_scale;
  tau = 0.99f * tau + 0.01f * torque_norm_last;
  tau = tau + tau_ff;
  if (pd.motor_dynamics) {
    const float gear = pd.gear[k];
    const float i_des = tau / gear / (pd.motor_kt * 1.5f);
    const float bemf = qd * gear * pd.motor_kt * 2.0f;
    const float v_des = i_des * pd.motor_r + bemf;
    const float v_act = fminf(fmaxf(v_des, -pd.motor_battery_v), pd.motor_battery_v);
    const float tau_act = (1.5f * pd.motor_kt) * (v_act - bemf) / pd.motor_r;
    const float sign = qd > 0.0f ? 1.0f : (qd < 0.0f ? -1.0f : 0.0f);
    tau = gear * fminf(fmaxf(tau_act, -pd.motor_tau_max), pd.motor_tau_max) -
          pd.motor_damping * qd - pd.motor_friction * sign;
  }
  const float kr = pd.knee_ratio[k];
  const float tm = pd.max_torque, cs = pd.critical_speed, ms = pd.max_speed;
  const float w = qd * kr;
  const float up = (w > cs ? tm - (w - cs) * pd.slope : tm) * kr;
  const float low = (w < -cs ? (-ms - w) / (-ms + cs) * -tm : -tm) * kr;
  return fminf(fmaxf(tau, low), up);
}

// The lane of this thread: env (clamped to B - 1 past the ragged edge, with
// `live` false), leg, and the state loaded from (19, B) and (18, B) rows.
struct Lane {
  int e, leg;
  bool live;
};

__device__ __forceinline__ Lane lane_of_thread(int B) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int env = warp * kEnvsPerWarp + (lane & 7);
  Lane l;
  l.live = env < B;
  l.e = l.live ? env : B - 1;
  l.leg = lane >> 3;
  return l;
}

__device__ __forceinline__ void load_state(const float* __restrict__ gc,
                                           const float* __restrict__ gv, size_t sB,
                                           const Lane& l, LaneState& s) {
#pragma unroll
  for (int i = 0; i < 7; ++i) s.gb[i] = gc[i * sB + l.e];
#pragma unroll
  for (int i = 0; i < 6; ++i) s.vb[i] = gv[i * sB + l.e];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.q[k] = gc[(7 + 3 * l.leg + k) * sB + l.e];
    s.qd[k] = gv[(6 + 3 * l.leg + k) * sB + l.e];
  }
}

// Rows gc' | gv' | toe | toe vel | |f| | fn: leg 0 writes the base rows, every
// lane its own leg's.
__device__ __forceinline__ void store_state(float* __restrict__ out, size_t sB, const Lane& l,
                                            const LaneState& s, const LaneDiag& d) {
  if (!l.live) return;
  const int e = l.e, leg = l.leg;
  if (leg == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) out[i * sB + e] = s.gb[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) out[(kOutGv + i) * sB + e] = s.vb[i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[(7 + 3 * leg + k) * sB + e] = s.q[k];
    out[(kOutGv + 6 + 3 * leg + k) * sB + e] = s.qd[k];
    out[(kOutToe + 3 * leg + k) * sB + e] = d.toe[k];
    out[(kOutToeVel + 3 * leg + k) * sB + e] = d.toe_vel[k];
  }
  out[(kOutFnorm + leg) * sB + e] = d.fnorm;
  out[(kOutFn + leg) * sB + e] = d.fn;
}

__global__ void __launch_bounds__(kThreads)
phys_substep_kernel(const float* __restrict__ prm, const float* __restrict__ gc,
                    const float* __restrict__ gv, const float* __restrict__ tau,
                    const float* __restrict__ bw, float* __restrict__ out, int B,
                    float slip_vel, float impulse_scale, float dt) {
  const Lane l = lane_of_thread(B);
  const size_t sB = (size_t)B;
  LaneState s;
  LaneDiag d;
  load_state(gc, gv, sB, l, s);
  float t[3], w[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = tau[(3 * l.leg + k) * sB + l.e];
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = bw[i * sB + l.e];
  const Terrain flat = {};
  substep_lane(prm, sB, l.e, l.leg, s, t, w, flat, slip_vel, impulse_scale, dt, d);
  store_state(out, sB, l, s, d);
}

// n_substeps x {PD torque from the fresh state -> substep}; writes the final
// state, the last substep's toe rows and the last substep's torque. tau_ff
// and pd_scale may be null (0 and 1); a Terrain's grid may be null (flat
// ground).
template <class Ground>
__global__ void __launch_bounds__(kThreads)
phys_control_step_kernel(const float* __restrict__ prm, const float* __restrict__ gc,
                         const float* __restrict__ gv, const float* __restrict__ ptarget,
                         const float* __restrict__ torque_norm_last,
                         const float* __restrict__ bw, const float* __restrict__ tau_ff,
                         const float* __restrict__ pd_scale, float* __restrict__ out, int B,
                         int n_substeps, float slip_vel, float impulse_scale, float dt,
                         PdConsts pd, Ground terr) {
  const Lane l = lane_of_thread(B);
  const size_t sB = (size_t)B;
  LaneState s;
  LaneDiag d;
  load_state(gc, gv, sB, l, s);
  float pt[3], tnl[3], ff[3], ps[3], t[3], w[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t at = (3 * l.leg + k) * sB + l.e;
    pt[k] = ptarget[at];
    tnl[k] = torque_norm_last[at];
    ff[k] = tau_ff ? tau_ff[at] : 0.0f;
    ps[k] = pd_scale ? pd_scale[at] : 1.0f;
    t[k] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = bw[i * sB + l.e];
#pragma unroll 1
  for (int it = 0; it < n_substeps; ++it) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t[k] = pd_torque(pd, k, pt[k], tnl[k], s.q[k], s.qd[k], ps[k], ff[k]);
    }
    substep_lane(prm, sB, l.e, l.leg, s, t, w, terr, slip_vel, impulse_scale, dt, d);
  }
  store_state(out, sB, l, s, d);
  if (l.live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[(kOutTau + 3 * l.leg + k) * sB + l.e] = t[k];
  }
}

inline int blocks_for(int B) {
  const int envs_per_block = kThreads / 32 * kEnvsPerWarp;
  return (B + envs_per_block - 1) / envs_per_block;
}

}  // namespace

extern "C" int phys_substep_launch(const float* prm, const float* gc, const float* gv,
                                   const float* tau, const float* bw, float* out, int B,
                                   float slip_vel, float impulse_scale, float dt,
                                   cudaStream_t stream) {
  if (B > 0) {
    phys_substep_kernel<<<blocks_for(B), kThreads, 0, stream>>>(prm, gc, gv, tau, bw, out, B,
                                                                slip_vel, impulse_scale, dt);
  }
  return (int)cudaGetLastError();
}

// pd_host: 22 floats on the host, kp[3] kd[3] knee_ratio[3] gear[3], then
// motor max torque, critical speed, max speed and the envelope's slope, then
// the motor model's kt, resistance, torque limit, battery voltage, damping
// and friction. tau_ff and pd_scale: (12, B) rows like ptarget, or null.
// grid: the (ny, nx) heightmap, or null; with it, terr_off (2, B), terr_cell
// and terr_z (B,). terr_seed: the analytic fractal's (B,) seeds, or null;
// with it, terr_z (B,) and no grid. Neither: flat ground.
extern "C" int phys_control_step_launch(const float* prm, const float* gc, const float* gv,
                                        const float* ptarget, const float* torque_norm_last,
                                        const float* bw, const float* tau_ff,
                                        const float* pd_scale, float* out, int B, int n_substeps,
                                        float slip_vel, float impulse_scale, float dt,
                                        const float* pd_host, int motor_dynamics,
                                        const float* grid, int nx, int ny,
                                        const float* terr_off, const float* terr_cell,
                                        const float* terr_z, const float* terr_seed,
                                        cudaStream_t stream) {
  if (n_substeps < 1) return (int)cudaErrorInvalidValue;
  if (grid != nullptr && (nx < 2 || ny < 2 || terr_off == nullptr || terr_cell == nullptr ||
                          terr_z == nullptr || terr_seed != nullptr))
    return (int)cudaErrorInvalidValue;
  if (terr_seed != nullptr && terr_z == nullptr) return (int)cudaErrorInvalidValue;
  Terrain terr = {};
  if (grid != nullptr) {
    terr = {grid, terr_off, terr_cell, terr_z, nx, ny, (float)(nx - 1.001), (float)(ny - 1.001)};
  }
  PdConsts pd;
  for (int k = 0; k < 3; ++k) {
    pd.kp[k] = pd_host[k];
    pd.kd[k] = pd_host[3 + k];
    pd.knee_ratio[k] = pd_host[6 + k];
    pd.gear[k] = pd_host[9 + k];
  }
  pd.max_torque = pd_host[12];
  pd.critical_speed = pd_host[13];
  pd.max_speed = pd_host[14];
  pd.slope = pd_host[15];
  pd.motor_kt = pd_host[16];
  pd.motor_r = pd_host[17];
  pd.motor_tau_max = pd_host[18];
  pd.motor_battery_v = pd_host[19];
  pd.motor_damping = pd_host[20];
  pd.motor_friction = pd_host[21];
  pd.motor_dynamics = motor_dynamics;
  if (B > 0 && terr_seed != nullptr) {
    const AnalyticTerrain analytic = {terr_seed, terr_z};
    phys_control_step_kernel<AnalyticTerrain><<<blocks_for(B), kThreads, 0, stream>>>(
        prm, gc, gv, ptarget, torque_norm_last, bw, tau_ff, pd_scale, out, B, n_substeps,
        slip_vel, impulse_scale, dt, pd, analytic);
  } else if (B > 0) {
    phys_control_step_kernel<Terrain><<<blocks_for(B), kThreads, 0, stream>>>(
        prm, gc, gv, ptarget, torque_norm_last, bw, tau_ff, pd_scale, out, B, n_substeps,
        slip_vel, impulse_scale, dt, pd, terr);
  }
  return (int)cudaGetLastError();
}
