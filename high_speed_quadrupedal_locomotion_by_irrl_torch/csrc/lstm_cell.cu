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
//
// Training. lstm_cell_train_kernel is the same forward (one tower or two on
// gridDim.y, with the mask) that also keeps the activated gates [i, f, o, g]
// of every row, (B, 4n), for the backward. lstm_cell_bwd_kernel is the
// gradient of one step, with no TPU counterpart (the JAX package leaves the
// transpose of its cell to XLA). From the gradients that reach c' and h' it
// computes, in one launch a step:
//   dct = dc' + dh' * o * (1 - tanh(c')^2)
//   dgates = [dct*g*i(1-i), dct*(c*keep)*f(1-f), dh'*tanh(c')*o(1-o), dct*i*(1-g^2)]
//   dc = dct * f * keep;   dh = (dgates @ Wh^T) * keep;   dx = dgates @ Wx^T
// and writes dgates over the stashed gates, so that the weight gradients are
// one product over all steps afterwards (ops/lstm_cuda.py). The two
// transposed products are one reduction over the 4n gate columns, shaped as
// the forward's: the wrapper hands the kernel [Wh^T | Wx^T] as one (4n, kp)
// matrix, zero-padded to whole columns a thread, so a thread owns hidden
// unit u of dh and columns u, u + n, ... of dx for its kRows rows, the
// weight rows stream through the same cp.async ring and the tile of dgates
// lies j-major in shared memory. It is bound like the forward: ~38 MFLOP and
// ~2 MB a tower at B = 1024, latency and the shared-memory pipe, not flops.
//
// One weight set a row. lstm_cell_pair_rows_kernel is the pair's function
// (with the mask) where row b reads its own Wx[b] (d, 4n), Wh[b] (n, 4n) and
// b[b] (4n): the cell of the JAX package's jax.vmap(lstm.deterministic_action)
// over stacked, blended parameter sets (analysis/landscape.py), whose TPU
// kernel is the same ops/lstm_pallas.py::_kernel under vmap. Its plain
// version is models/lstm.lstm_cell_pair_rows. Nothing is shared between
// rows, so the tile design above has nothing to amortize: each row streams
// its own (d + n + 1) * 4n floats, 64.5 KB a tower at d = 35 and 74.5 KB at
// d = 48, n = 48. It is bound by those bytes (1.43 GB a control step at 5151
// rows, both layers and towers: 0.43 ms at 3.35 TB/s) and does 2 flops a
// weight. The design is the simple one that keeps the weight stream
// coalesced: one block a (row, tower), one thread a gate column, the row's x
// and h * keep in shared memory; thread j walks weight rows k = 0 .. d + n - 1
// reading element j of each (neighbouring threads on neighbouring addresses),
// with four accumulators so that four loads are in flight a thread; the gates
// meet in shared memory for the tail of the pair.

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

// kTrain also writes the activated gates of every row to gates_out (B, 4n).
template <bool kTrain>
__device__ __forceinline__ void cell_block(const CellArgs& a, const float* __restrict__ mask,
                                           const Strides& ld, int B, int d, int n,
                                           float* smem, float* __restrict__ gates_out = nullptr) {
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
  float c_new[kRows], h_new[kRows], act[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float ig = sigmoidf(acc[r][0] + b0);
    const float fg = sigmoidf(acc[r][1] + b1);
    const float og = sigmoidf(acc[r][2] + b2);
    const float cg = tanhf(acc[r][3] + b3);
    c_new[r] = fg * c_prev[r] + ig * cg;
    h_new[r] = og * tanhf(c_new[r]);
    if (kTrain) { act[r][0] = ig; act[r][1] = fg; act[r][2] = og; act[r][3] = cg; }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row_first + r;
    if (row < B) {
      a.c_out[(size_t)row * ld.out + u] = c_new[r];
      a.h_out[(size_t)row * ld.out + u] = h_new[r];
      if (kTrain) {
        float* g = gates_out + (size_t)row * n4 + u;
        g[0] = act[r][0]; g[n] = act[r][1]; g[2 * n] = act[r][2]; g[3 * n] = act[r][3];
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_kernel(CellArgs a, Strides ld, int B, int d, int n) {
  extern __shared__ __align__(16) float smem[];
  cell_block<false>(a, nullptr, ld, B, d, n, smem);
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
  cell_block<false>(a, mask, ld, B, d, n, smem);
}

// The forward of a training step: gridDim.y towers (1 or 2), the mask, and
// the activated gates kept for lstm_cell_bwd_kernel.
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_train_kernel(CellArgs a0, CellArgs a1, float* __restrict__ gates0,
                       float* __restrict__ gates1, const float* __restrict__ mask, Strides ld,
                       int B, int d, int n) {
  extern __shared__ __align__(16) float smem[];
  const bool second = blockIdx.y != 0;
  const CellArgs a = {second ? a1.x : a0.x,   second ? a1.h : a0.h,
                      second ? a1.c : a0.c,   second ? a1.wx : a0.wx,
                      second ? a1.wh : a0.wh, second ? a1.b : a0.b,
                      second ? a1.h_out : a0.h_out, second ? a1.c_out : a0.c_out};
  cell_block<true>(a, mask, ld, B, d, n, smem, second ? gates1 : gates0);
}

// --- backward of one step ------------------------------------------------------

struct BwdArgs {
  float* __restrict__ gates;  // (B, 4n) in: activated [i, f, o, g]; out: dgates (pre-activation)
  const float *__restrict__ c_prev, *__restrict__ c_new;  // c before the reset (row stride ld_c); c'
  // gradients that reach h' and c', each (B, n) or null: from the layer above
  // or the loss (up) and from step t + 1 (rec)
  const float *__restrict__ dh_up, *__restrict__ dh_rec, *__restrict__ dc_up, *__restrict__ dc_rec;
  const float* __restrict__ wt;  // (4n, kp): [Wh^T | Wx^T | 0]
  float *__restrict__ dc_out, *__restrict__ dh_out;  // (B, n): to c and h of step t - 1
  float* __restrict__ dx_out;                        // (B, d), or null with d = 0
};

// Start the copy of rows chunk * kChunk ... of wt into one stage of the ring,
// 16 bytes a copy, the block's threads striding over the chunk. Rows past 4n
// get zeros. Always commits a group.
__device__ __forceinline__ void load_wt_chunk(const float* __restrict__ wt, int n4, int kp,
                                              int chunk, float* s_stage) {
  const int kp4 = kp >> 2;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthreads = blockDim.x * blockDim.y;
  for (int idx = tid; idx < kChunk * kp4; idx += nthreads) {
    const int r = idx / kp4, q = idx - r * kp4, j = chunk * kChunk + r;
    float* dst = s_stage + r * kp + 4 * q;
    if (j < n4) {
      __pipeline_memcpy_async(dst, wt + (size_t)j * kp + 4 * q, 16);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __pipeline_commit();
}

// kCols: output columns a thread owns: u (dh), then u + n, ... (dx).
template <int kCols>
__device__ __forceinline__ void cell_bwd_block(const BwdArgs& a, const float* __restrict__ mask,
                                               int B, int d, int n, int kp, int ld_c,
                                               float* smem) {
  const int n4 = 4 * n;
  const int nchunks = (n4 + kChunk - 1) / kChunk;
  float* s_dg = smem;                            // [nchunks * kChunk][kTile], j-major
  float* s_w = smem + nchunks * kChunk * kTile;  // [kStages][kChunk][kp]

  for (int c = 0; c < kStages - 1; ++c) load_wt_chunk(a.wt, n4, kp, c, s_w + c * kChunk * kp);

  // the gate tail's derivative: thread (u, g) owns unit u of its group's kRows
  // rows, as in the forward, and so reads and overwrites only its own gates
  const int u = threadIdx.x;
  const int row_first = blockIdx.x * kTile + threadIdx.y * kRows;
  float keep[kRows], dg[4][kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = row_first + j;
    keep[j] = 1.0f;
    dg[0][j] = dg[1][j] = dg[2][j] = dg[3][j] = 0.0f;
    if (row < B) {
      if (mask != nullptr) keep[j] = 1.0f - mask[row];
      float* gp = a.gates + (size_t)row * n4 + u;
      const float ig = gp[0], fg = gp[n], og = gp[2 * n], cg = gp[3 * n];
      const size_t off = (size_t)row * n + u;
      const float cm = a.c_prev[(size_t)row * ld_c + u] * keep[j];
      const float tc = tanhf(a.c_new[off]);
      const float dh = (a.dh_up != nullptr ? a.dh_up[off] : 0.0f) +
                       (a.dh_rec != nullptr ? a.dh_rec[off] : 0.0f);
      const float dc = (a.dc_up != nullptr ? a.dc_up[off] : 0.0f) +
                       (a.dc_rec != nullptr ? a.dc_rec[off] : 0.0f);
      const float dct = dc + dh * og * (1.0f - tc * tc);
      dg[0][j] = dct * cg * ig * (1.0f - ig);
      dg[1][j] = dct * cm * fg * (1.0f - fg);
      dg[2][j] = dh * tc * og * (1.0f - og);
      dg[3][j] = dct * ig * (1.0f - cg * cg);
      a.dc_out[off] = dct * fg * keep[j];
      gp[0] = dg[0][j]; gp[n] = dg[1][j]; gp[2 * n] = dg[2][j]; gp[3 * n] = dg[3][j];
    }
  }
  float* s_grp = s_dg + threadIdx.y * kRows;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < kRows; j += 4)
      *reinterpret_cast<float4*>(s_grp + (g * n + u) * kTile + j) =
          make_float4(dg[g][j], dg[g][j + 1], dg[g][j + 2], dg[g][j + 3]);
  for (int k = n4 + u; k < nchunks * kChunk; k += n)
#pragma unroll
    for (int j = 0; j < kRows; ++j) s_grp[k * kTile + j] = 0.0f;

  // out[row][col] = sum_j dgates[row][j] * wt[j][col]
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[r][q] = 0.0f;
  int stage = 0;
  for (int c = 0; c < nchunks; ++c) {
    // as in the forward: chunk c has landed, chunk c - 1 is consumed (the
    // first pass also publishes the tile of dgates)
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    const int next = stage == 0 ? kStages - 1 : stage - 1;
    load_wt_chunk(a.wt, n4, kp, c + kStages - 1, s_w + next * kChunk * kp);
    const float* sw = s_w + stage * kChunk * kp + u;
    const float* si = s_grp + c * kChunk * kTile;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float in[kRows], w[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) w[q] = sw[kk * kp + q * n];
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(si + kk * kTile + r);
        in[r] = v.x; in[r + 1] = v.y; in[r + 2] = v.z; in[r + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[r][q] += in[r] * w[q];
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row_first + r;
    if (row < B) {
      a.dh_out[(size_t)row * n + u] = acc[r][0] * keep[r];
#pragma unroll
      for (int q = 1; q < kCols; ++q) {
        const int col = (q - 1) * n + u;
        if (col < d) a.dx_out[(size_t)row * d + col] = acc[r][q];
      }
    }
  }
}

// gridDim.y towers (1 or 2); mask (B,) or null.
template <int kCols>
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_bwd_kernel(BwdArgs a0, BwdArgs a1, const float* __restrict__ mask, int B, int d,
                     int n, int kp, int ld_c) {
  extern __shared__ __align__(16) float smem[];
  const bool second = blockIdx.y != 0;
  const BwdArgs a = {second ? a1.gates : a0.gates,   second ? a1.c_prev : a0.c_prev,
                     second ? a1.c_new : a0.c_new,   second ? a1.dh_up : a0.dh_up,
                     second ? a1.dh_rec : a0.dh_rec, second ? a1.dc_up : a0.dc_up,
                     second ? a1.dc_rec : a0.dc_rec, second ? a1.wt : a0.wt,
                     second ? a1.dc_out : a0.dc_out, second ? a1.dh_out : a0.dh_out,
                     second ? a1.dx_out : a0.dx_out};
  cell_bwd_block<kCols>(a, mask, B, d, n, kp, ld_c, smem);
}

constexpr int kMaxCols = 2;  // dx up to n wide

inline size_t bwd_smem_bytes(int n, int kp) {
  const size_t steps = (size_t)((4 * n + kChunk - 1) / kChunk) * kChunk;
  return sizeof(float) * (steps * kTile + (size_t)kStages * kChunk * kp);
}

inline bool bwd_shape_ok(int d, int n, int cols, int kp) {
  return d >= 0 && n > 0 && n * kGroups <= kMaxThreads && cols >= 1 && cols <= kMaxCols &&
         d <= (cols - 1) * n && kp % 4 == 0 && kp >= cols * n &&
         bwd_smem_bytes(n, kp) <= (size_t)kMaxSmem;
}

inline size_t smem_bytes(int d, int n) {
  const size_t steps = (size_t)((d + n + kChunk - 1) / kChunk) * kChunk;
  return sizeof(float) * (steps * kTile + (size_t)kStages * kChunk * 4 * n);
}

inline bool shape_ok(int d, int n) {
  return d > 0 && n > 0 && n * kGroups <= kMaxThreads && smem_bytes(d, n) <= (size_t)kMaxSmem;
}

// --- one weight set a row ------------------------------------------------------

constexpr int kRowsMaxThreads = 1024;  // 4n: hidden sizes up to 256

// blockIdx.x = row, blockIdx.y = tower; blockDim.x = 4n rounded up to a warp.
__global__ void __launch_bounds__(kRowsMaxThreads)
lstm_cell_pair_rows_kernel(CellArgs a0, CellArgs a1, const float* __restrict__ mask,
                           Strides ld, int d, int n) {
  extern __shared__ __align__(16) float smem[];
  const bool second = blockIdx.y != 0;
  const CellArgs a = {second ? a1.x : a0.x,   second ? a1.h : a0.h,
                      second ? a1.c : a0.c,   second ? a1.wx : a0.wx,
                      second ? a1.wh : a0.wh, second ? a1.b : a0.b,
                      second ? a1.h_out : a0.h_out, second ? a1.c_out : a0.c_out};
  const int row = blockIdx.x, j = threadIdx.x, n4 = 4 * n, K = d + n;
  float* s_in = smem;        // [x | h * keep], K
  float* s_g = smem + K;     // pre-activation gates, 4n
  const float keep = mask != nullptr ? 1.0f - mask[row] : 1.0f;
  for (int k = j; k < d; k += blockDim.x) s_in[k] = a.x[(size_t)row * ld.x + k];
  for (int k = j; k < n; k += blockDim.x) s_in[d + k] = a.h[(size_t)row * ld.h + k] * keep;
  __syncthreads();
  if (j < n4) {
    const float* wx = a.wx + (size_t)row * d * n4 + j;
    const float* wh = a.wh + (size_t)row * n * n4 + j;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
    for (; k + 4 <= d; k += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += s_in[k + q] * __ldg(wx + (size_t)(k + q) * n4);
    }
    for (; k < d; ++k) acc[0] += s_in[k] * __ldg(wx + (size_t)k * n4);
    int m = 0;
    for (; m + 4 <= n; m += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += s_in[d + m + q] * __ldg(wh + (size_t)(m + q) * n4);
    }
    for (; m < n; ++m) acc[0] += s_in[d + m] * __ldg(wh + (size_t)m * n4);
    s_g[j] = (acc[0] + acc[1]) + (acc[2] + acc[3]) + __ldg(a.b + (size_t)row * n4 + j);
  }
  __syncthreads();
  if (j < n) {
    const float ig = sigmoidf(s_g[j]);
    const float fg = sigmoidf(s_g[n + j]);
    const float og = sigmoidf(s_g[2 * n + j]);
    const float cg = tanhf(s_g[3 * n + j]);
    const float c_new = fg * (a.c[(size_t)row * ld.c + j] * keep) + ig * cg;
    a.c_out[(size_t)row * ld.out + j] = c_new;
    a.h_out[(size_t)row * ld.out + j] = og * tanhf(c_new);
  }
}

inline size_t rows_smem_bytes(int d, int n) { return sizeof(float) * (size_t)(d + 5 * n); }

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

// towers: 1 or 2. ptrs: 9 device pointers a tower, on the host: x h c wx wh b
// h_out c_out gates_out. mask: (B,) device pointer or null.
extern "C" int lstm_cell_train_launch(const void* const* ptrs, const float* mask, int towers,
                                      int B, int d, int n, int ld_x, int ld_h, int ld_c,
                                      int ld_out, cudaStream_t stream) {
  if (!shape_ok(d, n) || towers < 1 || towers > 2) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    CellArgs a[2];
    float* gates[2];
    for (int t = 0; t < 2; ++t) {
      const void* const* p = ptrs + 9 * (t < towers ? t : 0);
      a[t] = {(const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
              (const float*)p[4], (const float*)p[5], (float*)p[6], (float*)p[7]};
      gates[t] = (float*)p[8];
    }
    const Strides ld = {ld_x, ld_h, ld_c, ld_out};
    lstm_cell_train_kernel<<<dim3((B + kTile - 1) / kTile, towers), dim3(n, kGroups),
                             smem_bytes(d, n), stream>>>(a[0], a[1], gates[0], gates[1], mask,
                                                         ld, B, d, n);
  }
  return (int)cudaGetLastError();
}

// towers: 1 or 2. ptrs: 11 device pointers a tower, on the host, in the order
// of BwdArgs. d: columns of dx to write (0: none); cols: 1 + ceil(d / n);
// kp: columns of wt. ld_c: row stride of c_prev.
extern "C" int lstm_cell_bwd_launch(const void* const* ptrs, const float* mask, int towers, int B,
                                    int d, int n, int cols, int kp, int ld_c,
                                    cudaStream_t stream) {
  if (!bwd_shape_ok(d, n, cols, kp) || towers < 1 || towers > 2)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    BwdArgs a[2];
    for (int t = 0; t < 2; ++t) {
      const void* const* p = ptrs + 11 * (t < towers ? t : 0);
      a[t] = {(float*)p[0],        (const float*)p[1], (const float*)p[2], (const float*)p[3],
              (const float*)p[4],  (const float*)p[5], (const float*)p[6], (const float*)p[7],
              (float*)p[8],        (float*)p[9],       (float*)p[10]};
    }
    const dim3 grid((B + kTile - 1) / kTile, towers), block(n, kGroups);
    const size_t smem = bwd_smem_bytes(n, kp);
    if (cols == 1)
      lstm_cell_bwd_kernel<1><<<grid, block, smem, stream>>>(a[0], a[1], mask, B, d, n, kp, ld_c);
    else
      lstm_cell_bwd_kernel<2><<<grid, block, smem, stream>>>(a[0], a[1], mask, B, d, n, kp, ld_c);
  }
  return (int)cudaGetLastError();
}

// ptrs: 16 device pointers on the host, tower 0 then tower 1, each x h c wx wh b
// h_out c_out, with wx (B, d, 4n), wh (B, n, 4n), b (B, 4n) contiguous.
// mask: (B,) device pointer or null.
extern "C" int lstm_cell_pair_rows_launch(const void* const* ptrs, const float* mask, int B,
                                          int d, int n, int ld_x, int ld_h, int ld_c, int ld_out,
                                          cudaStream_t stream) {
  const int threads = (4 * n + 31) / 32 * 32;
  if (d <= 0 || n <= 0 || threads > kRowsMaxThreads || rows_smem_bytes(d, n) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    CellArgs a[2];
    for (int t = 0; t < 2; ++t) {
      const void* const* p = ptrs + 8 * t;
      a[t] = {(const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
              (const float*)p[4], (const float*)p[5], (float*)p[6], (float*)p[7]};
    }
    const Strides ld = {ld_x, ld_h, ld_c, ld_out};
    lstm_cell_pair_rows_kernel<<<dim3(B, 2), dim3(threads), rows_smem_bytes(d, n),
                                 stream>>>(a[0], a[1], mask, ld, d, n);
  }
  return (int)cudaGetLastError();
}
