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
// Training: one launch a layer over the whole BPTT sequence, in each
// direction. Neither kernel has a TPU counterpart: the JAX package runs its
// cell under lax.scan and leaves the transpose to XLA. Rows of the batch never
// meet in an LSTM layer, only step t and t + 1 of one row do, so a block that
// owns a tile of rows walks all T steps alone, with no grid-wide
// synchronisation, and keeps the layer's weights resident in shared memory
// for the whole walk (up to 74 KB a tower, above the default 48 KB: the
// launchers raise the block's limit with cudaFuncSetAttribute).
//
// * lstm_seq_train_kernel: the pair's forward (one tower or two on
//   gridDim.y, the mask's pre-cell reset, the strided initial state) at every
//   step, writing c_seq, h_seq and the activated gates [i, f, o, g] (T, B, 4n)
//   for the backward. Two neighbouring lanes share a hidden unit: in the
//   products one owns gates i and f of the group's rows, the other o and g
//   (the weights lie unit-major, [k][u][gate], so each reads its two gate
//   weights of a step as one 64-bit word); for the tail they swap halves by
//   a shuffle and each finishes half the rows. That doubles the warps of a
//   block (12 at 16 rows) and halves each thread's exp/tanh chains, the
//   tail that dominates a step after the products. c stays in registers;
//   h' * keep of the next step goes straight into the other half of a
//   double-buffered input tile, whose x part cp.async fills with x[t + 1]
//   while step t computes (mask[t + 1] is loaded into registers meanwhile).
//   One __syncthreads a step. The reduction is cell_block's: fma over
//   [x; h * keep] in ascending k, padded with zeros to whole chunks, then the
//   same gate tail (cell_state), so the result is bit for bit a loop of pair
//   launches (the rollout's cells) on the same inputs.
// * lstm_seq_bwd_kernel: the gradient, walking t = T - 1 ... 0. From the
//   gradients that reach c' and h' (from above: dc_up, dh_up; from step
//   t + 1: dc_rec, dh_rec, held in registers) it computes at each step
//     dct = dc' + dh' * o * (1 - tanh(c')^2)
//     dgates = [dct*g*i(1-i), dct*(c*keep)*f(1-f), dh'*tanh(c')*o(1-o), dct*i*(1-g^2)]
//     dc = dct * f * keep;   dh = (dgates @ Wh^T) * keep;   dx = dgates @ Wx^T
//   writes dgates over the kept gates (the weight gradients are one product
//   each over all steps afterwards, ops/lstm_cuda.py) and, after step 0, dc
//   and dh of the initial state. The two transposed products are one
//   reduction over the 4n gate columns in ascending order: the wrapper hands
//   [Wh^T, Wx^T] interleaved as (4n, n, cols), resident in shared memory, a
//   thread owns hidden unit u of dh and column u of dx (d <= n) for its rows,
//   and the step's dgates lie j-major in a double-buffered tile. The next
//   step's gates, c, c', dh_up, dc_up and mask are loaded into registers
//   while this step computes.
//
// At B = 1024, n = 48 a step of both towers is 67-78 MFLOP forward and about
// as many backward plus 3-4 MB of gates and states: at the card's f32 rate
// the forward is bound by operations (~1 us a step) and the backward about
// equally by bytes and operations. What held the per-step kernels these
// replace back (a launch, a weight stream from L2 and a drain every step,
// the recurrence through device memory) is gone. What is left is latency:
// B = 1024 rows of two towers are ~16 rows an SM, so a step of an SM is one
// block's chain of products, exact exp/reciprocal/tanh tail and barrier, with
// few warps to hide either. The kernels are templates on the tile, rows a
// thread (kR) and rows a block (kR * kG); kSeqTrain* and kSeqBwd* below hold
// the fastest on the H100.
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

// c' = f * c + i * g with its one rounding spelled out: the compiler may
// contract the sum either way, and did so differently in two kernels, which
// then parted in the last bit. The pair and the sequence forward share this.
__device__ __forceinline__ float cell_state(float fg, float c, float ig, float cg) {
  return __fmaf_rn(fg, c, ig * cg);
}

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
    c_new[r] = cell_state(fg, c_prev[r], ig, cg);
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

// --- a layer over a whole sequence: training --------------------------------------

constexpr int kSeqMaxN = 64;             // hidden sizes up to 64: blockDim (2n or n, kG)
constexpr int kSeqMaxSmem = 232448;      // 227 KB: a block's most on sm_90
// The tiles, rows a thread and row groups a block: the forward takes 16 rows
// of 4 (12 warps with its lane pairs, one block an SM at B = 1024), the
// backward 8 rows of 2 (6 warps, two blocks an SM). Of 16 x 4, 16 x 2 and
// 8 x 2 these were the fastest on the H100. A build may set others with
// -DSEQ_TRAIN_ROWS=.. -DSEQ_TRAIN_GROUPS=.. -DSEQ_BWD_ROWS=.. -DSEQ_BWD_GROUPS=..
// (rows a thread 2 or 4), as scripts/lstm_seq_tiles.py does to time them.
#ifndef SEQ_TRAIN_ROWS
#define SEQ_TRAIN_ROWS 4
#endif
#ifndef SEQ_TRAIN_GROUPS
#define SEQ_TRAIN_GROUPS 4
#endif
#ifndef SEQ_BWD_ROWS
#define SEQ_BWD_ROWS 2
#endif
#ifndef SEQ_BWD_GROUPS
#define SEQ_BWD_GROUPS 4
#endif
constexpr int kSeqTrainRows = SEQ_TRAIN_ROWS, kSeqTrainGroups = SEQ_TRAIN_GROUPS;
constexpr int kSeqBwdRows = SEQ_BWD_ROWS, kSeqBwdGroups = SEQ_BWD_GROUPS;

struct SeqArgs {
  const float* __restrict__ x;                      // (T, B, d)
  const float *__restrict__ h0, *__restrict__ c0;   // (B, n), row strides ld_h, ld_c
  const float *__restrict__ wx, *__restrict__ wh, *__restrict__ b;
  float *__restrict__ c_seq, *__restrict__ h_seq;   // (T, B, n)
  float* __restrict__ gates;                        // (T, B, 4n): activated [i, f, o, g]
};

// kR values at p (16-byte aligned for kR = 4, 8-byte for kR = 2) into v, and back.
template <int kR>
__device__ __forceinline__ void load_rows(float (&v)[kR], const float* p) {
  static_assert(kR == 2 || kR == 4, "rows a thread");
  if constexpr (kR == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int kR>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[kR]) {
  static_assert(kR == 1 || kR == 2 || kR == 4, "rows");
  if constexpr (kR == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kR == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

inline size_t seq_smem_bytes(int d, int n) {
  const size_t kp = (size_t)(d + n + kChunk - 1) / kChunk * kChunk;   // the padded reduction
  return sizeof(float) * (kp * 4 * n + 2 * kp * kSeqTrainRows * kSeqTrainGroups);
}

inline size_t seq_bwd_smem_bytes(int n, int cols) {
  return sizeof(float) * ((size_t)4 * n * n * cols + (size_t)2 * 4 * n * kSeqBwdRows * kSeqBwdGroups);
}

// Start the copy of x[t]'s rows of this tile into s_tile[k][row] (k < d), 4
// bytes a copy, neighbouring threads on neighbouring rows (conflict-free in
// shared memory; the rows' lines are shared through L1). Rows past B are not
// copied: they hold what the tile held, and no live row reads them.
template <int kT>
__device__ __forceinline__ void copy_x_async(const float* __restrict__ x_t, int B, int d,
                                             int tile_first, float* s_tile) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthr = blockDim.x * blockDim.y;
  for (int idx = tid; idx < kT * d; idx += nthr) {
    const int k = idx / kT, r = idx - k * kT, row = tile_first + r;
    if (row < B) __pipeline_memcpy_async(s_tile + k * kT + r, x_t + (size_t)row * d + k, 4);
  }
  __pipeline_commit();
}

// Blocks of (n, kG) threads (the backward) or (2n, kG) (the forward); 8 rows
// of 2 are meant to run two blocks an SM.
#define SEQ_BOUNDS(kR, kG, lanes) \
  __launch_bounds__(lanes * kSeqMaxN * kG, kR == 2 && kG == 4 ? 2 : 1)

template <int kR, int kG>
__global__ void SEQ_BOUNDS(kR, kG, 2)
lstm_seq_train_kernel(SeqArgs a0, SeqArgs a1, const float* __restrict__ mask, int T, int B,
                      int d, int n, int ld_h, int ld_c) {
  constexpr int kT = kR * kG, kH = kR / 2;   // rows a block; rows of a thread's gate tail
  extern __shared__ __align__(16) float smem[];
  const bool second = blockIdx.y != 0;  // field by field: a struct picked whole goes to local memory
  const SeqArgs a = {second ? a1.x : a0.x,         second ? a1.h0 : a0.h0,
                     second ? a1.c0 : a0.c0,       second ? a1.wx : a0.wx,
                     second ? a1.wh : a0.wh,       second ? a1.b : a0.b,
                     second ? a1.c_seq : a0.c_seq, second ? a1.h_seq : a0.h_seq,
                     second ? a1.gates : a0.gates};
  const int n4 = 4 * n, K = d + n, kp = (K + kChunk - 1) / kChunk * kChunk;
  float* s_w = smem;                // [kp][n][4]: the 4 gate weights of unit u at step k together
  float* s_in = smem + kp * n4;     // [2][kp][kT]: x, then h * keep, then zeros; k-major
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthr = blockDim.x * blockDim.y;

  // once a launch: [Wx; Wh] by cp.async, 4 bytes a copy (each lands in its
  // unit's quad), zeros past step K; both input tiles zeroed
  for (int idx = tid; idx < kp * n4; idx += nthr) {
    const int k = idx / n4, col = idx - k * n4, g = col / n, u = col - g * n;
    float* dst = s_w + (k * n + u) * 4 + g;
    if (k < K) {
      const float* row = k < d ? a.wx + (size_t)k * n4 : a.wh + (size_t)(k - d) * n4;
      __pipeline_memcpy_async(dst, row + col, 4);
    } else {
      *dst = 0.0f;
    }
  }
  __pipeline_commit();
  for (int idx = tid; idx < 2 * kp * kT; idx += nthr) s_in[idx] = 0.0f;
  __syncthreads();

  // the two lanes 2u and 2u + 1 (half 0 and 1) share hidden unit u of the
  // group's kR rows: in the products half 0 owns gates i and f of every row,
  // half 1 gates o and g; for the tail they swap, and half 0 owns all four
  // gates of the first kH rows, half 1 of the last kH
  const int half = threadIdx.x & 1, u = threadIdx.x >> 1;
  const int tile_first = blockIdx.x * kT, group_first = tile_first + threadIdx.y * kR;
  const int row_first = group_first + half * kH;   // of this thread's tail
  copy_x_async<kT>(a.x, B, d, tile_first, s_in);
  float keep[kH], c[kH], h[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const int row = row_first + j;
    const bool live = row < B;
    keep[j] = (mask != nullptr && live) ? 1.0f - mask[row] : 1.0f;
    c[j] = live ? a.c0[(size_t)row * ld_c + u] : 0.0f;
    h[j] = live ? a.h0[(size_t)row * ld_h + u] * keep[j] : 0.0f;
  }
  float* s_h = s_in + (d + u) * kT + threadIdx.y * kR + half * kH;   // this thread's h rows
  store_rows<kH>(s_h, h);
  const float b0 = __ldg(a.b + u), b1 = __ldg(a.b + n + u), b2 = __ldg(a.b + 2 * n + u),
              b3 = __ldg(a.b + 3 * n + u);
  __pipeline_wait_prior(0);
  __syncthreads();

  const size_t step_x = (size_t)B * d, step_n = (size_t)B * n;
  const float* sw = s_w + 4 * u + 2 * half;
  for (int t = 0; t < T; ++t) {
    const float* si = s_in + (t & 1) * kp * kT + threadIdx.y * kR;
    float* so = s_in + ((t + 1) & 1) * kp * kT;
    const bool more = t + 1 < T;
    float keep_next[kH];
    if (more) copy_x_async<kT>(a.x + (t + 1) * step_x, B, d, tile_first, so);
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      const int row = row_first + j;
      keep_next[j] = (mask != nullptr && more && row < B) ? 1.0f - mask[(t + 1) * (size_t)B + row]
                                                          : 1.0f;
    }

    float acc[kR][2];   // gates 2 * half and 2 * half + 1 of the group's rows
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int k0 = 0; k0 < kp; k0 += kChunk) {
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const int k = k0 + kk;
        const float2 w = *reinterpret_cast<const float2*>(sw + k * n4);
        float in[kR];
        load_rows<kR>(in, si + k * kT);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          acc[r][0] += in[r] * w.x;
          acc[r][1] += in[r] * w.y;
        }
      }
    }
    // the swap: half 0 sends i, f of the last kH rows and receives o, g of the first
    float pre[kH][4];
#pragma unroll
    for (int j = 0; j < kH; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float got = __shfl_xor_sync(0xffffffffu, half ? acc[j][q] : acc[kH + j][q], 1);
        pre[j][q] = half ? got : acc[j][q];
        pre[j][2 + q] = half ? acc[kH + j][q] : got;
      }

    // cell_block's tail on c * keep; every row computed, only the stores masked
    float h_next[kH];
#pragma unroll
    for (int r = 0; r < kH; ++r) {
      const float ig = sigmoidf(pre[r][0] + b0);
      const float fg = sigmoidf(pre[r][1] + b1);
      const float og = sigmoidf(pre[r][2] + b2);
      const float cg = tanhf(pre[r][3] + b3);
      const float c_prev = c[r] * keep[r];
      const float c_new = cell_state(fg, c_prev, ig, cg);
      const float h_new = og * tanhf(c_new);
      const int row = row_first + r;
      if (row < B) {
        const size_t off = t * step_n + (size_t)row * n + u;
        a.c_seq[off] = c_new;
        a.h_seq[off] = h_new;
        float* g = a.gates + 4 * t * step_n + (size_t)row * n4 + u;
        g[0] = ig; g[n] = fg; g[2 * n] = og; g[3 * n] = cg;
      }
      c[r] = c_new;
      h_next[r] = row < B ? h_new * keep_next[r] : 0.0f;
      keep[r] = keep_next[r];
    }
    if (more) store_rows<kH>(s_h + ((t + 1) & 1) * kp * kT, h_next);
    // x[t + 1] has landed for this thread; after the barrier, for all, and
    // every thread is done reading this step's tile, which step t + 1 refills
    __pipeline_wait_prior(0);
    __syncthreads();
  }
}

// --- its gradient -------------------------------------------------------------------

struct SeqBwdArgs {
  float* __restrict__ gates;                // (T, B, 4n) in: activated; out: dgates (pre-activation)
  const float* __restrict__ c0;             // (B, n), row stride ld_c: c before step 0's reset
  const float* __restrict__ c_seq;          // (T, B, n)
  const float *__restrict__ dh_up, *__restrict__ dc_up;   // (T, B, n) or null
  const float* __restrict__ wt;             // (4n, n, cols): [j][u] = (Wh^T[j][u], Wx^T[j][u])
  float *__restrict__ dc0, *__restrict__ dh0;   // (B, n): to the initial state
  float* __restrict__ dx;                   // (T, B, d), or null with cols = 1
};

// What step t reads of this thread's kR rows: the activated gates, c before
// the reset (c_seq[t - 1], or c0 at t = 0), c' = c_seq[t], the gradients from
// above and keep = 1 - mask[t]. Rows past B read zeros.
template <int kR>
struct BwdStep {
  float g[4][kR], c_prev[kR], c_new[kR], dh[kR], dc[kR], keep[kR];
};

template <int kR>
__device__ __forceinline__ void load_bwd_step(BwdStep<kR>& s, const SeqBwdArgs& a,
                                              const float* __restrict__ mask, int t, int B,
                                              int n, int ld_c, int row_first, int u) {
  const size_t step_n = (size_t)B * n;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int row = row_first + j;
    const bool live = row < B;
    const size_t off = t * step_n + (size_t)row * n + u;
    const float* gp = a.gates + 4 * t * step_n + (size_t)row * 4 * n + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) s.g[q][j] = live ? gp[q * n] : 0.0f;
    s.c_prev[j] = !live ? 0.0f : t > 0 ? a.c_seq[off - step_n] : a.c0[(size_t)row * ld_c + u];
    s.c_new[j] = live ? a.c_seq[off] : 0.0f;
    s.dh[j] = (live && a.dh_up != nullptr) ? a.dh_up[off] : 0.0f;
    s.dc[j] = (live && a.dc_up != nullptr) ? a.dc_up[off] : 0.0f;
    s.keep[j] = (live && mask != nullptr) ? 1.0f - mask[t * (size_t)B + row] : 1.0f;
  }
}

// kCols: 1 (dh) or 2 (dh and dx).
template <int kR, int kG, int kCols>
__global__ void SEQ_BOUNDS(kR, kG, 1)
lstm_seq_bwd_kernel(SeqBwdArgs a0, SeqBwdArgs a1, const float* __restrict__ mask, int T, int B,
                    int d, int n, int ld_c) {
  constexpr int kT = kR * kG;
  extern __shared__ __align__(16) float smem[];
  const bool second = blockIdx.y != 0;
  const SeqBwdArgs a = {second ? a1.gates : a0.gates, second ? a1.c0 : a0.c0,
                        second ? a1.c_seq : a0.c_seq, second ? a1.dh_up : a0.dh_up,
                        second ? a1.dc_up : a0.dc_up, second ? a1.wt : a0.wt,
                        second ? a1.dc0 : a0.dc0,     second ? a1.dh0 : a0.dh0,
                        second ? a1.dx : a0.dx};
  const int n4 = 4 * n;
  float* s_w = smem;                    // [4n][n][kCols]
  float* s_dg = smem + n4 * n * kCols;  // [2][4n][kT]: dgates, j-major
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthr = blockDim.x * blockDim.y;
  for (int idx = tid; idx < n4 * n * kCols / 4; idx += nthr)
    __pipeline_memcpy_async(s_w + 4 * idx, a.wt + 4 * idx, 16);
  __pipeline_commit();

  const int u = threadIdx.x, row_first = blockIdx.x * kT + threadIdx.y * kR;
  const size_t step_n = (size_t)B * n;
  BwdStep<kR> cur, nxt;
  load_bwd_step<kR>(cur, a, mask, T - 1, B, n, ld_c, row_first, u);
  float dh_rec[kR], dc_rec[kR];   // from step t + 1; none reaches the last step
#pragma unroll
  for (int j = 0; j < kR; ++j) dh_rec[j] = dc_rec[j] = 0.0f;
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) load_bwd_step<kR>(nxt, a, mask, t - 1, B, n, ld_c, row_first, u);
    float* s_tile = s_dg + (t & 1) * n4 * kT;
    float dg[4][kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const float ig = cur.g[0][j], fg = cur.g[1][j], og = cur.g[2][j], cg = cur.g[3][j];
      const float cm = cur.c_prev[j] * cur.keep[j];
      const float tc = tanhf(cur.c_new[j]);
      const float dh = cur.dh[j] + dh_rec[j];
      const float dc = cur.dc[j] + dc_rec[j];
      const float dct = dc + dh * og * (1.0f - tc * tc);
      dg[0][j] = dct * cg * ig * (1.0f - ig);
      dg[1][j] = dct * cm * fg * (1.0f - fg);
      dg[2][j] = dh * tc * og * (1.0f - og);
      dg[3][j] = dct * ig * (1.0f - cg * cg);
      dc_rec[j] = dct * fg * cur.keep[j];
      const int row = row_first + j;
      if (row < B) {
        float* gp = a.gates + 4 * t * step_n + (size_t)row * n4 + u;
        gp[0] = dg[0][j]; gp[n] = dg[1][j]; gp[2 * n] = dg[2][j]; gp[3 * n] = dg[3][j];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) store_rows<kR>(s_tile + (q * n + u) * kT + threadIdx.y * kR, dg[q]);
    // the tile is whole; the other tile, which step t - 1 fills, was read by
    // every thread before this barrier's predecessor
    __syncthreads();

    // out[row][col] = sum_j dgates[row][j] * wt[j][col], j ascending
    float acc[kR][kCols];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[r][q] = 0.0f;
    const float* si = s_tile + threadIdx.y * kR;
    const float* sw = s_w + kCols * u;
    for (int j0 = 0; j0 < n4; j0 += kChunk) {
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        float in[kR], w[kCols];
        load_rows<kR>(in, si + j * kT);
        if constexpr (kCols == 2) {
          const float2 q = *reinterpret_cast<const float2*>(sw + j * n * kCols);
          w[0] = q.x; w[1] = q.y;
        } else {
          w[0] = sw[j * n];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[r][q] += in[r] * w[q];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      dh_rec[r] = acc[r][0] * cur.keep[r];
      const int row = row_first + r;
      if (kCols == 2 && row < B && u < d) a.dx[t * (size_t)B * d + (size_t)row * d + u] = acc[r][kCols - 1];
    }
    cur = nxt;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = row_first + r;
    if (row < B) {
      a.dc0[(size_t)row * n + u] = dc_rec[r];
      a.dh0[(size_t)row * n + u] = dh_rec[r];
    }
  }
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

// Dynamic shared memory of the forward (backward = 0) or the backward at d
// columns of dx (0: none), as the launchers ask for it.
extern "C" size_t lstm_seq_smem_bytes(int backward, int d, int n) {
  return backward ? seq_bwd_smem_bytes(n, d > 0 ? 2 : 1) : seq_smem_bytes(d, n);
}

// towers: 1 or 2. ptrs: 9 device pointers a tower, on the host: x h0 c0 wx wh
// b c_seq h_seq gates. mask: (T, B) device pointer or null. ld_h, ld_c: row
// strides of h0 and c0. Raises the kernel's shared-memory limit first.
extern "C" int lstm_seq_train_launch(const void* const* ptrs, const float* mask, int towers,
                                     int T, int B, int d, int n, int ld_h, int ld_c,
                                     cudaStream_t stream) {
  constexpr int kR = kSeqTrainRows, kG = kSeqTrainGroups, kT = kR * kG;
  const size_t smem = seq_smem_bytes(d, n);
  if (d <= 0 || n <= 0 || n > kSeqMaxN || n % 4 != 0 || T <= 0 || towers < 1 || towers > 2 ||
      smem > (size_t)kSeqMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  SeqArgs a[2];
  for (int t = 0; t < 2; ++t) {
    const void* const* p = ptrs + 9 * (t < towers ? t : 0);
    a[t] = {(const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
            (const float*)p[4], (const float*)p[5], (float*)p[6],       (float*)p[7],
            (float*)p[8]};
  }
  const cudaError_t e = cudaFuncSetAttribute(lstm_seq_train_kernel<kR, kG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lstm_seq_train_kernel<kR, kG><<<dim3((B + kT - 1) / kT, towers), dim3(2 * n, kG), smem,
                                  stream>>>(a[0], a[1], mask, T, B, d, n, ld_h, ld_c);
  return (int)cudaGetLastError();
}

template <int kCols>
static int launch_seq_bwd(const SeqBwdArgs (&a)[2], const float* mask, int towers, int T, int B, int d,
                   int n, int ld_c, size_t smem, cudaStream_t stream) {
  constexpr int kR = kSeqBwdRows, kG = kSeqBwdGroups, kT = kR * kG;
  const cudaError_t e = cudaFuncSetAttribute(lstm_seq_bwd_kernel<kR, kG, kCols>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lstm_seq_bwd_kernel<kR, kG, kCols><<<dim3((B + kT - 1) / kT, towers), dim3(n, kG), smem,
                                       stream>>>(a[0], a[1], mask, T, B, d, n, ld_c);
  return (int)cudaGetLastError();
}

// towers: 1 or 2. ptrs: 9 device pointers a tower, on the host, in the order
// of SeqBwdArgs. d: columns of dx to write (0: none; else d <= n). ld_c: row
// stride of c0. Raises the kernel's shared-memory limit first.
extern "C" int lstm_seq_bwd_launch(const void* const* ptrs, const float* mask, int towers, int T,
                                   int B, int d, int n, int ld_c, cudaStream_t stream) {
  const size_t smem = seq_bwd_smem_bytes(n, d > 0 ? 2 : 1);
  if (n <= 0 || n > kSeqMaxN || n % 4 != 0 || T <= 0 || towers < 1 || towers > 2 || d < 0 ||
      d > n || smem > (size_t)kSeqMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  SeqBwdArgs a[2];
  for (int t = 0; t < 2; ++t) {
    const void* const* p = ptrs + 9 * (t < towers ? t : 0);
    a[t] = {(float*)p[0],       (const float*)p[1], (const float*)p[2],
            (const float*)p[3], (const float*)p[4], (const float*)p[5],
            (float*)p[6],       (float*)p[7],       (float*)p[8]};
  }
  return d > 0 ? launch_seq_bwd<2>(a, mask, towers, T, B, d, n, ld_c, smem, stream)
               : launch_seq_bwd<1>(a, mask, towers, T, B, d, n, ld_c, smem, stream);
}

#undef SEQ_BOUNDS

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
