// One compliant-contact physics substep per env, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/phys_pallas.py::_kernel of the JAX package,
// whose body is ops/phys_lanes.substep_lanes: FK over the 13-body tree,
// spatial body velocities, penalty contact at the 4 toe spheres and the 8
// base-box corners (corners at 0.25 kn / 0.25 dn), the base wrench, RNEA bias
// at qdd = 0, the CRBA mass matrix with path sparsity plus rotor inertias, an
// unrolled 18x18 Cholesky solve and semi-implicit Euler with an exp-map
// quaternion update. The plain PyTorch version is ops/phys_lanes.substep.
//
// Design: one thread per env, 128 threads a block, ceil(B/128) blocks, the
// ragged edge masked. Every array is SoA, (rows, B) row-major, so the 32
// threads of a warp read and write 32 neighbouring floats of each row. The
// body is straight scalar code over fixed-size local arrays; every loop is
// fully unrolled so that every index is a compile-time constant.
//
// What bounds it: not HBM bytes (~(208 + 55 + 69) * 4 B = 1.3 KB an env
// against ~10k flops) but the latency of one long dependent scalar chain per
// thread, and so occupancy: the 18x18 mass matrix, its Cholesky factor and
// the 13 rotations do not fit in 255 registers and spill to local memory
// (which stays in L1/L2 at these sizes). Fusing the 8 substeps of a control
// step and the PD torque into one launch, so the state stays on chip between
// substeps, is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// packed parameter rows (ops/phys_pallas.pack_params layout)
constexpr int kRowMass = 0;       // 13
constexpr int kRowCom = 13;       // 13 x 3
constexpr int kRowInertia = 52;   // 13 x 3 x 3
constexpr int kRowJoint = 169;    // 12 x 3
constexpr int kRowFriction = 205;
constexpr int kRowKn = 206;
constexpr int kRowDn = 207;

// output rows: gc' 19 | gv' 18 | toe 12 | toe vel 12 | |f| 4 | fn 4
constexpr int kOutGv = 19;
constexpr int kOutToe = 37;
constexpr int kOutToeVel = 49;
constexpr int kOutFnorm = 61;
constexpr int kOutFn = 65;

constexpr float kGravityZ = -9.81f;
constexpr float kToeOffsetZ = -0.19f;
constexpr float kToeRadius = 0.0275f;
constexpr float kJointDamping = 0.01f;

// Static topology (phys/model.py). Bodies: 0 base, then per leg
// abduct/thigh/shank; joint j drives body j + 1.
__device__ __forceinline__ constexpr int parent_of(int b) {
  return ((b - 1) % 3 == 0) ? 0 : b - 1;
}
__device__ __forceinline__ constexpr int leg_of(int b) { return (b - 1) / 3; }
__device__ __forceinline__ constexpr int link_of(int b) { return (b - 1) % 3; }
// joint axis in the parent frame: abduct about +x, hip and knee about -y
__device__ __forceinline__ constexpr float jaxis(int j, int i) {
  return (j % 3 == 0) ? (i == 0 ? 1.0f : 0.0f) : (i == 1 ? -1.0f : 0.0f);
}
__device__ __forceinline__ constexpr float rotor_inertia(int j) {
  return (j % 3 == 2) ? 0.008966f : 0.003708f;
}
__device__ __forceinline__ constexpr float box_half(int i) {
  return i == 0 ? 0.15f : (i == 1 ? 0.10f : 0.05f);
}
// corner c in (sx, sy, sz) order with sx outermost, each sign -1 then +1
__device__ __forceinline__ constexpr float corner_sign(int c, int i) {
  return ((c >> (2 - i)) & 1) ? 1.0f : -1.0f;
}

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

// Penalty contact against flat ground with a vertical normal
// (phys_lanes._contact_point).
__device__ __forceinline__ float contact_point(const float* pos, const float* vel,
                                               float radius, float kn, float dn,
                                               float mu, float slip_vel,
                                               float impulse_scale, float* f) {
  float pen = fmaxf(radius - pos[2], 0.0f);
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

__global__ void __launch_bounds__(kThreads)
phys_substep_kernel(const float* __restrict__ prm, const float* __restrict__ gc,
                    const float* __restrict__ gv, const float* __restrict__ tau,
                    const float* __restrict__ bw, float* __restrict__ out, int B,
                    float slip_vel, float impulse_scale, float dt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t sB = (size_t)B;
#define PRM(r) __ldg(prm + (size_t)(r) * sB + e)

  float g[19], v[18];
#pragma unroll
  for (int i = 0; i < 19; ++i) g[i] = gc[i * sB + e];
#pragma unroll
  for (int i = 0; i < 18; ++i) v[i] = gv[i * sB + e];

  // ---- forward kinematics
  float R[13][3][3], p[13][3];
  {
    const float w = g[3], x = g[4], y = g[5], z = g[6];
    R[0][0][0] = 1 - 2 * (y * y + z * z); R[0][0][1] = 2 * (x * y - w * z); R[0][0][2] = 2 * (x * z + w * y);
    R[0][1][0] = 2 * (x * y + w * z); R[0][1][1] = 1 - 2 * (x * x + z * z); R[0][1][2] = 2 * (y * z - w * x);
    R[0][2][0] = 2 * (x * z - w * y); R[0][2][1] = 2 * (y * z + w * x); R[0][2][2] = 1 - 2 * (x * x + y * y);
    p[0][0] = g[0]; p[0][1] = g[1]; p[0][2] = g[2];
  }
  float axis_w[12][3], anchor[12][3];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int b = j + 1, par = parent_of(b);
    const float jo0 = PRM(kRowJoint + 3 * j), jo1 = PRM(kRowJoint + 3 * j + 1),
                jo2 = PRM(kRowJoint + 3 * j + 2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      anchor[j][i] = p[par][i] + R[par][i][0] * jo0 + R[par][i][1] * jo1 + R[par][i][2] * jo2;
    // Rodrigues for the static unit axis
    const float ax = jaxis(j, 0), ay = jaxis(j, 1), az = jaxis(j, 2);
    const float c = cosf(g[7 + j]), s = sinf(g[7 + j]), C = 1.0f - c;
    float Rj[3][3] = {
        {c + ax * ax * C, ax * ay * C - az * s, ax * az * C + ay * s},
        {ay * ax * C + az * s, c + ay * ay * C, ay * az * C - ax * s},
        {az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C}};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        R[b][r][q] = R[par][r][0] * Rj[0][q] + R[par][r][1] * Rj[1][q] + R[par][r][2] * Rj[2][q];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[b][i] = anchor[j][i];
      axis_w[j][i] = R[par][i][0] * ax + R[par][i][1] * ay + R[par][i][2] * az;
    }
  }
  float com_w[13][3];
#pragma unroll
  for (int b = 0; b < 13; ++b) {
    const float c0 = PRM(kRowCom + 3 * b), c1 = PRM(kRowCom + 3 * b + 1), c2 = PRM(kRowCom + 3 * b + 2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      com_w[b][i] = p[b][i] + (R[b][i][0] * c0 + R[b][i][1] * c1 + R[b][i][2] * c2);
  }
  float toe[4][3];
#pragma unroll
  for (int leg = 0; leg < 4; ++leg)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      toe[leg][i] = p[3 * (leg + 1)][i] + R[3 * (leg + 1)][i][2] * kToeOffsetZ;

  // ---- motion-subspace columns S[d] = [omega; v_O]
  float S[18][6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 6; ++i) S[k][i] = (i == 3 + k) ? 1.0f : 0.0f;
    float ek[3] = {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) S[3 + k][i] = ek[i];
    cross3(p[0], ek, &S[3 + k][3]);
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) S[6 + j][i] = axis_w[j][i];
    cross3(anchor[j], axis_w[j], &S[6 + j][3]);
  }

  // ---- body spatial velocities
  float vb[13][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < 6; ++d) s += S[d][i] * v[d];
    vb[0][i] = s;
  }
#pragma unroll
  for (int b = 1; b < 13; ++b) {
    const int j = b - 1;
#pragma unroll
    for (int i = 0; i < 6; ++i) vb[b][i] = vb[parent_of(b)][i] + S[6 + j][i] * v[6 + j];
  }

  // ---- contact forces -> world-origin spatial wrenches
  const float kn = PRM(kRowKn), dn = PRM(kRowDn), mu = PRM(kRowFriction);
  float fext[13][6];
#pragma unroll
  for (int b = 0; b < 13; ++b)
#pragma unroll
    for (int i = 0; i < 6; ++i) fext[b][i] = 0.0f;
#pragma unroll
  for (int leg = 0; leg < 4; ++leg) {
    const int b = 3 * (leg + 1);
    float wxp[3], tv[3], f[3], nxf[3];
    cross3(&vb[b][0], toe[leg], wxp);
#pragma unroll
    for (int i = 0; i < 3; ++i) tv[i] = vb[b][3 + i] + wxp[i];
    const float fn = contact_point(toe[leg], tv, kToeRadius, kn, dn, mu, slip_vel,
                                   impulse_scale, f);
    cross3(toe[leg], f, nxf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fext[b][i] += nxf[i];
      fext[b][3 + i] += f[i];
      out[(kOutToe + 3 * leg + i) * sB + e] = toe[leg][i];
      out[(kOutToeVel + 3 * leg + i) * sB + e] = tv[i];
    }
    out[(kOutFnorm + leg) * sB + e] = sqrtf(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);
    out[(kOutFn + leg) * sB + e] = fn;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float local[3], cp[3], wxp[3], cv[3], f[3], nxf[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) local[i] = corner_sign(c, i) * box_half(i);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cp[i] = p[0][i] + (R[0][i][0] * local[0] + R[0][i][1] * local[1] + R[0][i][2] * local[2]);
    cross3(&vb[0][0], cp, wxp);
#pragma unroll
    for (int i = 0; i < 3; ++i) cv[i] = vb[0][3 + i] + wxp[i];
    contact_point(cp, cv, 0.0f, kn * 0.25f, dn * 0.25f, mu, slip_vel, impulse_scale, f);
    cross3(cp, f, nxf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fext[0][i] += nxf[i];
      fext[0][3 + i] += f[i];
    }
  }
  {  // base wrench [f_world(3); n(3)]
    float fb[3], nb[3], pxf[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fb[i] = bw[i * sB + e];
      nb[i] = bw[(3 + i) * sB + e];
    }
    cross3(p[0], fb, pxf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fext[0][i] += nb[i] + pxf[i];
      fext[0][3 + i] += fb[i];
    }
  }

  // ---- bias accelerations (RNEA with qdd = 0)
  float acc[13][6];
  {
    float vxw[3];
    cross3(&v[0], &v[3], vxw);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc[0][i] = 0.0f;
      acc[0][3 + i] = vxw[i];
    }
  }
#pragma unroll
  for (int b = 1; b < 13; ++b) {
    const int par = parent_of(b), j = b - 1;
    float wxw[3], wxv[3], vxw[3];
    cross3(&vb[par][0], &S[6 + j][0], wxw);
    cross3(&vb[par][0], &S[6 + j][3], wxv);
    cross3(&vb[par][3], &S[6 + j][0], vxw);
    const float qd = v[6 + j];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc[b][i] = acc[par][i] + wxw[i] * qd;
      acc[b][3 + i] = acc[par][3 + i] + (wxv[i] + vxw[i]) * qd;
    }
  }

  // ---- per body: spatial inertia, net force -> bias h, CRBA -> M (upper)
  float h[18], M[18][18];
#pragma unroll
  for (int d = 0; d < 18; ++d) {
    h[d] = 0.0f;
#pragma unroll
    for (int q = 0; q < 18; ++q) M[d][q] = 0.0f;
  }
#pragma unroll
  for (int b = 0; b < 13; ++b) {
    float I6[6][6];
    {
      float Ib[3][3], RI[3][3], Iw[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q) Ib[i][q] = PRM(kRowInertia + 9 * b + 3 * i + q);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          RI[i][q] = R[b][i][0] * Ib[0][q] + R[b][i][1] * Ib[1][q] + R[b][i][2] * Ib[2][q];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          Iw[i][q] = RI[i][0] * R[b][q][0] + RI[i][1] * R[b][q][1] + RI[i][2] * R[b][q][2];
      const float m = PRM(kRowMass + b);
      const float* c = com_w[b];
      const float cx[3][3] = {{0.0f, -c[2], c[1]}, {c[2], 0.0f, -c[0]}, {-c[1], c[0], 0.0f}};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float cc = cx[i][0] * cx[q][0] + cx[i][1] * cx[q][1] + cx[i][2] * cx[q][2];
          I6[i][q] = Iw[i][q] + m * cc;
          I6[i][3 + q] = m * cx[i][q];
          I6[3 + i][q] = m * cx[q][i];
          I6[3 + i][3 + q] = (i == q) ? m : 0.0f;
        }
    }
    // net force f = I a + v x* (I v) - f_grav - f_ext
    float Iv[6], Ia[6], fnet[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      Iv[i] = dot6(I6[i], vb[b]);
      Ia[i] = dot6(I6[i], acc[b]);
    }
    {
      float cf[3], cf2[3], cff[3];
      cross3(&vb[b][0], &Iv[0], cf);
      cross3(&vb[b][3], &Iv[3], cf2);
      cross3(&vb[b][0], &Iv[3], cff);
      const float grav_z = PRM(kRowMass + b) * kGravityZ;
      const float* cw = com_w[b];
      const float gn[3] = {cw[1] * grav_z, -(cw[0] * grav_z), 0.0f};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        fnet[i] = Ia[i] + cf[i] + cf2[i] - gn[i] - fext[b][i];
        fnet[3 + i] = Ia[3 + i] + cff[i] - (i == 2 ? grav_z : 0.0f) - fext[b][3 + i];
      }
    }
    // dofs of body b: the 6 base dofs and its leg chain up to itself
    const int nj = (b == 0) ? 0 : link_of(b) + 1;
    const int j0 = (b == 0) ? 0 : 3 * leg_of(b);
#pragma unroll
    for (int d = 0; d < 6; ++d) h[d] += dot6(S[d], fnet);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < nj) h[6 + j0 + k] += dot6(S[6 + j0 + k], fnet);
    // CRBA: M[d][e] += S_d . (I6 S_e) for d <= e within the dofs
    float F[9][6];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (q < 6 + nj) {
        const int eq = q < 6 ? q : 6 + j0 + (q - 6);
#pragma unroll
        for (int i = 0; i < 6; ++i) F[q][i] = dot6(I6[i], S[eq]);
      }
    }
#pragma unroll
    for (int qd = 0; qd < 9; ++qd) {
      if (qd < 6 + nj) {
        const int d = qd < 6 ? qd : 6 + j0 + (qd - 6);
#pragma unroll
        for (int qe = 0; qe < 9; ++qe) {
          if (qe >= qd && qe < 6 + nj) {
            const int ee = qe < 6 ? qe : 6 + j0 + (qe - 6);
            M[d][ee] += dot6(S[d], F[qe]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) M[6 + j][6 + j] += rotor_inertia(j);

  // ---- rhs and Cholesky solve (factor L stored in the lower triangle of M;
  // the upper triangle keeps the matrix)
  float x[18];
#pragma unroll
  for (int d = 0; d < 6; ++d) x[d] = -h[d];
#pragma unroll
  for (int j = 0; j < 12; ++j)
    x[6 + j] = tau[j * sB + e] - kJointDamping * v[6 + j] - h[6 + j];
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    float s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= M[j][k] * M[j][k];
    M[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / M[j][j];
#pragma unroll
    for (int i = j + 1; i < 18; ++i) {
      float t = M[j][i];  // = M[i][j] of the symmetric matrix
#pragma unroll
      for (int k = 0; k < j; ++k) t -= M[i][k] * M[j][k];
      M[i][j] = t * inv;
    }
  }
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= M[i][k] * x[k];
    x[i] = s / M[i][i];
  }
#pragma unroll
  for (int i = 17; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < 18; ++k) s -= M[k][i] * x[k];
    x[i] = s / M[i][i];
  }

  // ---- semi-implicit Euler with the exp-map quaternion update
  float vn[18];
#pragma unroll
  for (int d = 0; d < 18; ++d) {
    vn[d] = v[d] + dt * x[d];
    out[(kOutGv + d) * sB + e] = vn[d];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i * sB + e] = g[i] + dt * vn[i];
  {
    const float qw = g[3], qx = g[4], qy = g[5], qz = g[6];
    const float ox = vn[3], oy = vn[4], oz = vn[5];
    const float angle = sqrtf(ox * ox + oy * oy + oz * oz);
    const float half = 0.5f * angle * dt;
    const float k = angle > 1e-9f ? sinf(half) / fmaxf(angle, 1e-12f) : 0.5f * dt;
    const float dw = cosf(half), dx = k * ox, dy = k * oy, dz = k * oz;
    const float nw = dw * qw - dx * qx - dy * qy - dz * qz;
    const float nx = dw * qx + dx * qw + dy * qz - dz * qy;
    const float ny = dw * qy - dx * qz + dy * qw + dz * qx;
    const float nz = dw * qz + dx * qy - dy * qx + dz * qw;
    const float inv = 1.0f / sqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
    out[3 * sB + e] = nw * inv;
    out[4 * sB + e] = nx * inv;
    out[5 * sB + e] = ny * inv;
    out[6 * sB + e] = nz * inv;
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) out[(7 + j) * sB + e] = g[7 + j] + dt * vn[6 + j];
#undef PRM
}

}  // namespace

extern "C" int phys_substep_launch(const float* prm, const float* gc, const float* gv,
                                   const float* tau, const float* bw, float* out, int B,
                                   float slip_vel, float impulse_scale, float dt,
                                   cudaStream_t stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    phys_substep_kernel<<<blocks, kThreads, 0, stream>>>(prm, gc, gv, tau, bw, out, B,
                                                         slip_vel, impulse_scale, dt);
  }
  return (int)cudaGetLastError();
}
