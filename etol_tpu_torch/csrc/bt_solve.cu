// Batched block-tridiagonal SPD solve with one refinement pass, float32.
//
// Replaces etol_tpu/ops/pallas_bt.py::_bt_kernel (the Pallas TPU kernel
// behind solve_lanes(D, O, r, refine=1)) and computes the same thing:
// for each of B independent systems H x = r, with H[k,k] = D_k and
// H[k,k+1] = O_k (k < K-1),
//   * block Cholesky by the Schur recurrence: S_0 = D_0, L_k = chol(S_k),
//     W_k = L_k^{-1} O_k, Lsub_k = W_k^T, S_{k+1} = D_{k+1} - W_k^T W_k;
//   * forward sweep L y = r, backward sweep L^T x = y;
//   * one refinement pass: c = r - H x, both sweeps against the stored
//     factor, x += correction.
// A non-positive pivot gives NaN (sqrtf of a negative number), which the
// solver reads as a failed factor and answers with a gradient step.
//
// What bounds it on an H100: it is latency-bound. Each lane runs a
// K-long sequential recurrence of small dense w x w factorizations and
// triangular solves, about K*w^3 flops on ~10 KB of input (K=51, w=5),
// so neither the arithmetic units nor memory bandwidth are near busy.
// The design keeps the per-node algebra in registers: one thread per
// lane, the node width W a template parameter (1..9) so every w x w loop
// unrolls, and all arrays in lane-minor layout [K, n, B] so neighbouring
// threads read neighbouring addresses. Blocks hold 64 threads, so B=2048
// runs 32 blocks and the last stage of the staged solve (B=64) fills one
// SM of 132; making it fast (more lanes per SM, splitting a lane's work
// across threads) is later work.
//
// Interface: plain C, pointers from torch.Tensor.data_ptr(), launched on
// the caller's stream without synchronising; returns the cudaError_t of
// the launch. The caller allocates every array:
//   D [K, W*W, B], O [K-1, W*W, B], r [K, W, B]   inputs
//   x [K, W, B]                                   output
//   lfac [K, W(W+1)/2, B]  packed lower Cholesky factors
//   lsub [K-1, W*W, B]     sub-diagonal factors Lsub_k (row-major)
//   y [K, W, B]            forward-sweep result (reused by refinement)
//   c [K, W, B]            refinement right-hand side r - H x
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// element e of node k in a lane-minor [K, n, B] array
__device__ __forceinline__ long long at(int k, int n, int e, int B, int b) {
  return ((long long)k * n + e) * B + b;
}

// S (row-major W x W) -> packed lower factor L
template <int W>
__device__ __forceinline__ void chol(const float (&S)[W * W],
                                     float (&L)[W * (W + 1) / 2]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = S[i * W + j];
#pragma unroll
      for (int t = 0; t < j; ++t) s -= L[tri(i, t)] * L[tri(j, t)];
      L[tri(i, j)] = (i == j) ? sqrtf(s) : s / L[tri(j, j)];
    }
  }
}

// solve L y = b
template <int W>
__device__ __forceinline__ void fwd(const float (&L)[W * (W + 1) / 2],
                                    const float (&b)[W], float (&y)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float s = b[i];
#pragma unroll
    for (int t = 0; t < i; ++t) s -= L[tri(i, t)] * y[t];
    y[i] = s / L[tri(i, i)];
  }
}

// solve L^T x = b
template <int W>
__device__ __forceinline__ void bwd(const float (&L)[W * (W + 1) / 2],
                                    const float (&b)[W], float (&x)[W]) {
#pragma unroll
  for (int i = W - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int t = i + 1; t < W; ++t) s -= L[tri(t, i)] * x[t];
    x[i] = s / L[tri(i, i)];
  }
}

template <int W>
__device__ __forceinline__ void load_L(const float* lfac, int k, int B, int b,
                                       float (&L)[W * (W + 1) / 2]) {
  constexpr int TW = W * (W + 1) / 2;
#pragma unroll
  for (int e = 0; e < TW; ++e) L[e] = lfac[at(k, TW, e, B, b)];
}

template <int W>
__device__ __forceinline__ void load_sub(const float* lsub, int k, int B,
                                         int b, float (&ls)[W * W]) {
#pragma unroll
  for (int e = 0; e < W * W; ++e) ls[e] = lsub[at(k, W * W, e, B, b)];
}

// Forward sweep of L y = rhs over all nodes, where rhs_k is read from
// `src` (r for the first solve, c for the refinement), y written to `y`.
// Node k's rhs is src_k - Lsub_{k-1} y_{k-1}.
template <int W>
__device__ void forward_sweep(const float* src, const float* lfac,
                              const float* lsub, float* y, int K, int B,
                              int b) {
  constexpr int TW = W * (W + 1) / 2;
  float L[TW], ls[W * W], rhs[W], yk[W], yp[W];
  for (int k = 0; k < K; ++k) {
    load_L<W>(lfac, k, B, b, L);
#pragma unroll
    for (int i = 0; i < W; ++i) rhs[i] = src[at(k, W, i, B, b)];
    if (k > 0) {
      load_sub<W>(lsub, k - 1, B, b, ls);
#pragma unroll
      for (int i = 0; i < W; ++i) {
#pragma unroll
        for (int j = 0; j < W; ++j) rhs[i] -= ls[i * W + j] * yp[j];
      }
    }
    fwd<W>(L, rhs, yk);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      y[at(k, W, i, B, b)] = yk[i];
      yp[i] = yk[i];
    }
  }
}

// Backward sweep of L^T x = y; `accumulate` adds the result into x
// (the refinement correction) instead of storing it.
template <int W>
__device__ void backward_sweep(const float* y, const float* lfac,
                               const float* lsub, float* x, int K, int B,
                               int b, bool accumulate) {
  constexpr int TW = W * (W + 1) / 2;
  float L[TW], ls[W * W], rhs[W], xk[W], xn[W];
  for (int k = K - 1; k >= 0; --k) {
    load_L<W>(lfac, k, B, b, L);
#pragma unroll
    for (int t = 0; t < W; ++t) rhs[t] = y[at(k, W, t, B, b)];
    if (k < K - 1) {
      load_sub<W>(lsub, k, B, b, ls);
      // x_k = L_k^{-T} (y_k - Lsub_k^T x_{k+1})
#pragma unroll
      for (int t = 0; t < W; ++t) {
#pragma unroll
        for (int j = 0; j < W; ++j) rhs[t] -= ls[j * W + t] * xn[j];
      }
    }
    bwd<W>(L, rhs, xk);
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const long long o = at(k, W, t, B, b);
      x[o] = accumulate ? x[o] + xk[t] : xk[t];
      xn[t] = xk[t];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    bt_solve_kernel(const float* __restrict__ D, const float* __restrict__ O,
                    const float* __restrict__ r, float* __restrict__ x,
                    float* __restrict__ lfac, float* __restrict__ lsub,
                    float* __restrict__ y, float* __restrict__ c, int K,
                    int B) {
  constexpr int W2 = W * W;
  constexpr int TW = W * (W + 1) / 2;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // ---- factor: S_0 = D_0, then L_k, Lsub_k, S_{k+1} ---------------
  float S[W2], L[TW], ls[W2], col[W], wcol[W];
#pragma unroll
  for (int e = 0; e < W2; ++e) S[e] = D[at(0, W2, e, B, b)];
  for (int k = 0; k < K; ++k) {
    chol<W>(S, L);
#pragma unroll
    for (int e = 0; e < TW; ++e) lfac[at(k, TW, e, B, b)] = L[e];
    if (k == K - 1) break;
    // column cc of W_k = L_k^{-1} O_k; Lsub_k = W_k^T, so
    // Lsub_k[cc][t] = W_k[t][cc]
#pragma unroll
    for (int cc = 0; cc < W; ++cc) {
#pragma unroll
      for (int i = 0; i < W; ++i) col[i] = O[at(k, W2, i * W + cc, B, b)];
      fwd<W>(L, col, wcol);
#pragma unroll
      for (int t = 0; t < W; ++t) ls[cc * W + t] = wcol[t];
    }
#pragma unroll
    for (int e = 0; e < W2; ++e) lsub[at(k, W2, e, B, b)] = ls[e];
    // S_{k+1}[i][j] = D_{k+1}[i][j] - sum_t W[t][i] W[t][j]
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float s = D[at(k + 1, W2, i * W + j, B, b)];
#pragma unroll
        for (int t = 0; t < W; ++t) s -= ls[i * W + t] * ls[j * W + t];
        S[i * W + j] = s;
      }
    }
  }

  // ---- first solve ---------------------------------------------------
  forward_sweep<W>(r, lfac, lsub, y, K, B, b);
  backward_sweep<W>(y, lfac, lsub, x, K, B, b, false);

  // ---- refinement: c = r - H x, solve against the stored factor ------
  // res_k = r_k - D_k x_k - O_k x_{k+1} - O_{k-1}^T x_{k-1}
  float xp[W], xc[W], xn[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    xp[t] = 0.f;
    xc[t] = x[at(0, W, t, B, b)];
  }
  for (int k = 0; k < K; ++k) {
    const bool has_next = k + 1 < K;
#pragma unroll
    for (int t = 0; t < W; ++t)
      xn[t] = has_next ? x[at(k + 1, W, t, B, b)] : 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float s = r[at(k, W, i, B, b)];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        s -= D[at(k, W2, i * W + j, B, b)] * xc[j];
        if (has_next) s -= O[at(k, W2, i * W + j, B, b)] * xn[j];
        if (k > 0) s -= O[at(k - 1, W2, j * W + i, B, b)] * xp[j];
      }
      c[at(k, W, i, B, b)] = s;
    }
#pragma unroll
    for (int t = 0; t < W; ++t) {
      xp[t] = xc[t];
      xc[t] = xn[t];
    }
  }
  forward_sweep<W>(c, lfac, lsub, y, K, B, b);
  backward_sweep<W>(y, lfac, lsub, x, K, B, b, true);
}

template <int W>
cudaError_t launch(const float* D, const float* O, const float* r, float* x,
                   float* lfac, float* lsub, float* y, float* c, int K, int B,
                   cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  bt_solve_kernel<W><<<blocks, kThreads, 0, stream>>>(D, O, r, x, lfac, lsub,
                                                       y, c, K, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" int etol_bt_solve_f32(const float* D, const float* O,
                                 const float* r, float* x, float* lfac,
                                 float* lsub, float* y, float* c, int K, int W,
                                 int B, void* stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return (int)launch<1>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 2: return (int)launch<2>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 3: return (int)launch<3>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 4: return (int)launch<4>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 5: return (int)launch<5>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 6: return (int)launch<6>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 7: return (int)launch<7>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 8: return (int)launch<8>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    case 9: return (int)launch<9>(D, O, r, x, lfac, lsub, y, c, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
