// Fused LSTM cell for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/lstm_pallas.py::_kernel of the JAX package:
//   gates = x @ Wx + h @ Wh + b   (gate order [i, f, o, g])
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// The plain PyTorch version is models/lstm.lstm_cell.
//
// Design: one block per 32-row batch tile. Wx, Wh and b, and the tile's x
// and h rows, are staged in dynamic shared memory ((d + n) * 4n + 4n + 32
// (d + n) floats: 85 KB at d = n = 48, so the launch raises the block's
// shared-memory limit above 48 KB). The block is (n, 8) threads; each thread
// owns one hidden unit and walks 4 of the tile's rows, computing that unit's
// four gate dot products from shared memory, then the elementwise tail, and
// writes c' and h'. The gate products are this kernel's own loops: no
// library product is called.
//
// What bounds it: at the policy's shapes (B = 1024, d = 35 or 48, n = 48) the
// cell is 33-37 MFLOP and ~0.9 MB of traffic, under a microsecond of the
// card's float32 rate or bandwidth; the launch and the dependent chain of
// d + n multiply-adds per gate are what it waits on (latency- and
// launch-bound, not FLOP-bound). Each of the B / 32 blocks re-reads the
// weights from L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;      // batch rows per block
constexpr int kRowGroups = 8;  // blockDim.y

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                                 const float* __restrict__ c, const float* __restrict__ wx,
                                 const float* __restrict__ wh, const float* __restrict__ bias,
                                 float* __restrict__ h_out, float* __restrict__ c_out, int B,
                                 int d, int n) {
  extern __shared__ float smem[];
  const int n4 = 4 * n;
  float* s_wx = smem;               // (d, 4n)
  float* s_wh = s_wx + d * n4;      // (n, 4n)
  float* s_b = s_wh + n * n4;       // (4n,)
  float* s_x = s_b + n4;            // (kTile, d)
  float* s_h = s_x + kTile * d;     // (kTile, n)

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, B - row0);

  for (int i = tid; i < d * n4; i += nthreads) s_wx[i] = wx[i];
  for (int i = tid; i < n * n4; i += nthreads) s_wh[i] = wh[i];
  for (int i = tid; i < n4; i += nthreads) s_b[i] = bias[i];
  for (int i = tid; i < rows * d; i += nthreads) s_x[i] = x[(size_t)row0 * d + i];
  for (int i = tid; i < rows * n; i += nthreads) s_h[i] = h[(size_t)row0 * n + i];
  __syncthreads();

  const int u = threadIdx.x;  // hidden unit
  for (int r = threadIdx.y; r < rows; r += kRowGroups) {
    float gi = 0.0f, gf = 0.0f, go = 0.0f, gg = 0.0f;
    const float* xr = s_x + r * d;
    for (int t = 0; t < d; ++t) {
      const float xv = xr[t];
      const float* w = s_wx + t * n4 + u;
      gi += xv * w[0];
      gf += xv * w[n];
      go += xv * w[2 * n];
      gg += xv * w[3 * n];
    }
    float hi = 0.0f, hf = 0.0f, ho = 0.0f, hg = 0.0f;
    const float* hr = s_h + r * n;
    for (int t = 0; t < n; ++t) {
      const float hv = hr[t];
      const float* w = s_wh + t * n4 + u;
      hi += hv * w[0];
      hf += hv * w[n];
      ho += hv * w[2 * n];
      hg += hv * w[3 * n];
    }
    const float ig = sigmoidf(gi + hi + s_b[u]);
    const float fg = sigmoidf(gf + hf + s_b[n + u]);
    const float og = sigmoidf(go + ho + s_b[2 * n + u]);
    const float cg = tanhf(gg + hg + s_b[3 * n + u]);
    const size_t idx = (size_t)(row0 + r) * n + u;
    const float c_new = fg * c[idx] + ig * cg;
    c_out[idx] = c_new;
    h_out[idx] = og * tanhf(c_new);
  }
}

}  // namespace

extern "C" int lstm_cell_launch(const float* x, const float* h, const float* c,
                                const float* wx, const float* wh, const float* bias,
                                float* h_out, float* c_out, int B, int d, int n,
                                cudaStream_t stream) {
  if (n <= 0 || n * kRowGroups > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(d + n) * 4 * n + 4 * n + (size_t)kTile * (d + n));
  static size_t smem_allowed = 0;  // the limit already raised for this kernel
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(lstm_cell_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  if (B > 0) {
    const dim3 block(n, kRowGroups);
    const int blocks = (B + kTile - 1) / kTile;
    lstm_cell_kernel<<<blocks, block, smem, stream>>>(x, h, c, wx, wh, bias, h_out, c_out, B,
                                                      d, n);
  }
  return (int)cudaGetLastError();
}
