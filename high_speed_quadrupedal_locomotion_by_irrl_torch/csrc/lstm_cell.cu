// Fused LSTM cell for Hopper (sm_90a): one cell, or the same layer of two
// independent towers in one launch.
//
// Replaces the TPU kernel ops/lstm_pallas.py::_kernel of the JAX package:
//   gates = x @ Wx + h @ Wh + b   (gate order [i, f, o, g])
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// The plain PyTorch versions are models/lstm.lstm_cell and, for the pair
// with its pre-cell state reset (c, h scaled by 1 - mask), lstm_cell_pair.
//
// What bounds it: at the policy's shapes (B = 1024, d = 35 or 48, n = 48) a
// cell is 33-39 MFLOP and ~0.9 MB of traffic, half a microsecond of the
// card's float32 rate, so it is bound by latency: how its loads and its
// dependent instructions are scheduled and hidden with a handful of warps on an
// SM, not by flops or HBM bytes. The design:
//
// * Register tiles. A block takes kTile = 16 batch rows and all n hidden
//   units as kGroups = 4 row groups of n threads; a thread owns one unit and
//   kRows = 4 rows, i.e. the 4 gates of 4 rows: 16 accumulators. Per step of
//   the reduction it reads its unit's 4 gate weights and, as one 128-bit
//   load that the row group shares by broadcast, its 4 inputs, and does 16
//   FMAs. (8 rows a thread halve the loads per FMA but leave 3 warps on an
//   SM, too few to hide the shared-memory latency: measured slower.)
// * The tile's x and (masked) h rows are staged k-major, [k][row], each
//   thread loading a column of its own group's rows and storing it as one
//   128-bit word; c * keep is fetched at the same time and waits in
//   registers.
// * Weights stream through a ring in shared memory. Wx and Wh are one
//   reduction of d + n steps; their rows arrive in chunks of kChunk steps by
//   cp.async (16 bytes a thread, coalesced), kStages chunks deep, so the L2
//   latency of chunk c + 2 hides behind the FMAs of chunk c and no block
//   waits on a copy of the whole 74 KB weight set before its first FMA.
//   Steps past d + n are zero-filled in tile and ring, so the inner loop has
//   no bounds and no branches and its loads are scheduled across steps (with
//   a branch a step, every step waited out its own loads). Tile
//   and ring are 24 KB: the default shared-memory limit is enough.
// * The gate tail runs for all rows without a branch, so the exp and tanh
//   chains of the rows interleave; only the stores are masked.
// * The card is filled: B / 16 blocks a tower, and the pair launch puts the
//   two towers on gridDim.y, 128 blocks at B = 1024. The gate products are
//   this kernel's own loops: no library product is called.
//
// Rows of x, h, c and of the outputs may be strided (row strides in
// elements, unit inner stride), so the pair launch reads the packed
// recurrent state in place.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;                // batch rows a block
constexpr int kRows = 4;                 // batch rows a thread
constexpr int kGroups = kTile / kRows;   // blockDim.y
constexpr int kChunk = 8;                // reduction steps a weight chunk
constexpr int kStages = 3;               // weight chunks in the ring
static_assert(kRows % 4 == 0 && kTile % kRows == 0 && kChunk % kGroups == 0, "tile shape");
constexpr int kMaxSmem = 48 * 1024;      // usable without raising the limit
constexpr int kMaxThreads = 512;         // n * kGroups: hidden sizes up to 128

struct CellArgs {
  const float *__restrict__ x, *__restrict__ h, *__restrict__ c;
  const float *__restrict__ wx, *__restrict__ wh, *__restrict__ b;
  float *__restrict__ h_out, *__restrict__ c_out;
};

struct Strides {
  int x, h, c, out;  // row strides, in elements
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc[r][g] += w[g] * in[r] for the rows of this thread's group at one step.
__device__ __forceinline__ void fma_step(float (&acc)[kRows][4], const float* s_row,
                                         const float* w_row, int n) {
  const float w0 = w_row[0], w1 = w_row[n], w2 = w_row[2 * n], w3 = w_row[3 * n];
  float in[kRows];
#pragma unroll
  for (int r = 0; r < kRows; r += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s_row + r);
    in[r] = v.x; in[r + 1] = v.y; in[r + 2] = v.z; in[r + 3] = v.w;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r][0] += in[r] * w0;
    acc[r][1] += in[r] * w1;
    acc[r][2] += in[r] * w2;
    acc[r][3] += in[r] * w3;
  }
}

// Start the copy of weight chunk `chunk` (steps chunk * kChunk ... of the
// reduction over [Wx; Wh]) into one stage of the ring: thread (u, g) moves
// the u-th 16 bytes of rows g, g + kGroups, ... Steps past d + n get zeros,
// so the products need no bounds. Always commits a group, so that every
// thread counts the same groups.
__device__ __forceinline__ void load_chunk(const CellArgs& a, int d, int n, int chunk,
                                           float* s_stage) {
  const int n4 = 4 * n, K = d + n;
#pragma unroll
  for (int j = 0; j < kChunk / kGroups; ++j) {
    const int r = threadIdx.y + j * kGroups, k = chunk * kChunk + r;
    float* dst = s_stage + r * n4 + 4 * threadIdx.x;
    if (k < K) {
      const float* row = k < d ? a.wx + (size_t)k * n4 : a.wh + (size_t)(k - d) * n4;
      __pipeline_memcpy_async(dst, row + 4 * threadIdx.x, 16);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __pipeline_commit();
}

// This thread's share of the tile: column k of its group's kRows rows of src
// (row stride ld), each times keep[row] where keep is given, into s_dst[k][row]
// as 128-bit stores.
__device__ __forceinline__ void stage_column(const float* __restrict__ src, int ld, int k,
                                             int row_first, int B, const float* keep,
                                             float* s_dst) {
  float v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    v[j] = row_first + j < B
               ? src[(size_t)(row_first + j) * ld + k] * (keep != nullptr ? keep[j] : 1.0f)
               : 0.0f;
#pragma unroll
  for (int j = 0; j < kRows; j += 4)
    *reinterpret_cast<float4*>(s_dst + k * kTile + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

__device__ __forceinline__ void cell_block(const CellArgs& a, const float* __restrict__ mask,
                                           const Strides& ld, int B, int d, int n,
                                           float* smem) {
  const int n4 = 4 * n, K = d + n;
  const int nchunks = (K + kChunk - 1) / kChunk;
  float* s_in = smem;                            // [nchunks * kChunk][kTile]
  float* s_w = smem + nchunks * kChunk * kTile;  // [kStages][kChunk][4n]

  for (int c = 0; c < kStages - 1; ++c) load_chunk(a, d, n, c, s_w + c * kChunk * n4);

  // thread (u, g) owns hidden unit u of the group's kRows rows; it also stages
  // the group's rows of x and h k-major, s_in[k][row], x first, then h * keep,
  // then zeros up to a whole chunk. c * keep waits in registers meanwhile.
  const int u = threadIdx.x;
  const int row_first = blockIdx.x * kTile + threadIdx.y * kRows;
  float keep[kRows], c_prev[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const bool live = row_first + j < B;
    keep[j] = (mask != nullptr && live) ? 1.0f - mask[row_first + j] : 1.0f;
    c_prev[j] = live ? a.c[(size_t)(row_first + j) * ld.c + u] * keep[j] : 0.0f;
  }
  float* s_grp = s_in + threadIdx.y * kRows;
  for (int k = u; k < d; k += n) stage_column(a.x, ld.x, k, row_first, B, nullptr, s_grp);
  stage_column(a.h, ld.h, u, row_first, B, keep, s_grp + d * kTile);
  for (int k = K + u; k < nchunks * kChunk; k += n)
#pragma unroll
    for (int j = 0; j < kRows; ++j) s_grp[k * kTile + j] = 0.0f;

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  int stage = 0;  // of chunk c
  for (int c = 0; c < nchunks; ++c) {
    // chunk c has landed for every thread, and every thread is done with
    // chunk c - 1, whose stage the next copy overwrites (the first pass also
    // publishes the tile)
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    const int next = stage == 0 ? kStages - 1 : stage - 1;
    load_chunk(a, d, n, c + kStages - 1, s_w + next * kChunk * n4);
    const float* sw = s_w + stage * kChunk * n4 + u;
    const float* si = s_grp + c * kChunk * kTile;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) fma_step(acc, si + kk * kTile, sw + kk * n4, n);
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }

  const float b0 = __ldg(a.b + u), b1 = __ldg(a.b + n + u), b2 = __ldg(a.b + 2 * n + u),
              b3 = __ldg(a.b + 3 * n + u);
  // rows past the edge hold zeros and are computed too: without a branch a
  // row the gate chains of all rows interleave; only the stores are masked
  float c_new[kRows], h_new[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float ig = sigmoidf(acc[r][0] + b0);
    const float fg = sigmoidf(acc[r][1] + b1);
    const float og = sigmoidf(acc[r][2] + b2);
    const float cg = tanhf(acc[r][3] + b3);
    c_new[r] = fg * c_prev[r] + ig * cg;
    h_new[r] = og * tanhf(c_new[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row_first + r;
    if (row < B) {
      a.c_out[(size_t)row * ld.out + u] = c_new[r];
      a.h_out[(size_t)row * ld.out + u] = h_new[r];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_kernel(CellArgs a, Strides ld, int B, int d, int n) {
  extern __shared__ __align__(16) float smem[];
  cell_block(a, nullptr, ld, B, d, n, smem);
}

// blockIdx.y picks the tower; mask (B,) or null resets the state of its rows.
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_pair_kernel(CellArgs a0, CellArgs a1, const float* __restrict__ mask, Strides ld,
                      int B, int d, int n) {
  extern __shared__ __align__(16) float smem[];
  const bool second = blockIdx.y != 0;  // field by field: a struct picked whole goes to local memory
  const CellArgs a = {second ? a1.x : a0.x,   second ? a1.h : a0.h,
                      second ? a1.c : a0.c,   second ? a1.wx : a0.wx,
                      second ? a1.wh : a0.wh, second ? a1.b : a0.b,
                      second ? a1.h_out : a0.h_out, second ? a1.c_out : a0.c_out};
  cell_block(a, mask, ld, B, d, n, smem);
}

inline size_t smem_bytes(int d, int n) {
  const size_t steps = (size_t)((d + n + kChunk - 1) / kChunk) * kChunk;
  return sizeof(float) * (steps * kTile + (size_t)kStages * kChunk * 4 * n);
}

inline bool shape_ok(int d, int n) {
  return d > 0 && n > 0 && n * kGroups <= kMaxThreads && smem_bytes(d, n) <= (size_t)kMaxSmem;
}

}  // namespace

extern "C" int lstm_cell_launch(const float* x, const float* h, const float* c,
                                const float* wx, const float* wh, const float* bias,
                                float* h_out, float* c_out, int B, int d, int n,
                                cudaStream_t stream) {
  if (!shape_ok(d, n)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const CellArgs a = {x, h, c, wx, wh, bias, h_out, c_out};
    const Strides ld = {d, n, n, n};
    lstm_cell_kernel<<<dim3((B + kTile - 1) / kTile), dim3(n, kGroups), smem_bytes(d, n),
                       stream>>>(a, ld, B, d, n);
  }
  return (int)cudaGetLastError();
}

// ptrs: 16 device pointers on the host, tower 0 then tower 1, each
// x h c wx wh b h_out c_out. mask: (B,) device pointer or null.
extern "C" int lstm_cell_pair_launch(const void* const* ptrs, const float* mask, int B, int d,
                                     int n, int ld_x, int ld_h, int ld_c, int ld_out,
                                     cudaStream_t stream) {
  if (!shape_ok(d, n)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    CellArgs a[2];
    for (int t = 0; t < 2; ++t) {
      const void* const* p = ptrs + 8 * t;
      a[t] = {(const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
              (const float*)p[4], (const float*)p[5], (float*)p[6], (float*)p[7]};
    }
    const Strides ld = {ld_x, ld_h, ld_c, ld_out};
    lstm_cell_pair_kernel<<<dim3((B + kTile - 1) / kTile, 2), dim3(n, kGroups),
                            smem_bytes(d, n), stream>>>(a[0], a[1], mask, ld, B, d, n);
  }
  return (int)cudaGetLastError();
}
