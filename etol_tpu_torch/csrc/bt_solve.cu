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
// A non-positive pivot gives a non-finite x for that lane (rsqrtf of a
// negative number is NaN, of zero is inf) and touches no other lane; the
// solver reads it as a failed factor and answers with a gradient step.
//
// What bounds it on an H100. By the roofline it is bound by bytes: at
// (K, w, B) = (51, 5, 2048) it must move 24.9 MB (7.4 us at 3.35 TB/s)
// for about 91 MFLOP (1.4 us at 67 TFLOP/s). In practice it is bound by
// latency: a lane is a K-long recurrence of w x w factorizations, walked
// twice down and twice up, and each node's pivots depend on the node
// before. The time of one warp's dependent chain is the floor however
// many lanes run beside it: on an NVIDIA H100 80GB HBM3 at 700 W the
// shared-memory kernel takes 0.047-0.064 ms a launch at K=51, w=5 for
// batches from 64 to 2048 (one wave of blocks at each), where the
// device-memory kernel takes 0.67-1.18 ms (chip_smoke.py prints both).
// One warp starts a shuffle or a shared-memory access only every few
// cycles, so the design counts those, not the arithmetic.
//
// Two kernels, chosen by the wrapper from (K, w) alone:
//
// bt_smem_kernel: the kernel for this card, used whenever a lane's factor
//   fits a block's shared memory (every shape of the problem ladder).
//   * A lane is split across a group of W threads of one warp; a block is
//     one warp of 32/W lanes, so a batch spreads over as many SMs as it
//     has such groups, and nothing but __syncwarp is needed. Thread i of
//     a group holds row i of S_k and column i of W_k = L_k^{-1} O_k, so
//     the w columns of W_k and the w rows of the Schur update run side
//     by side; rows of S_k and right-hand sides go round the group by
//     __shfl_sync, W_k through its Lsub slot in shared memory. The w x w
//     Cholesky itself is done by every thread of
//     the group alike on its own copy of S_k: its pivots then follow each
//     other without a shuffle in between, which is the longest chain.
//   * The packed factor, Lsub, y and c live in shared memory and never
//     touch device memory. A node's factor and its Lsub start on 16
//     bytes and are read four floats a load; the lane stride is an odd
//     multiple of 4 floats, which keeps the lanes of a block on different
//     banks. y's slots are reused for x and c's for the refinement's
//     forward result.
//   * D, O and r are read in their native [B, K, w, w] layout, each
//     thread its own row and column, one node ahead of their use, and x
//     is written in [B, K, w]. The residual's second reading of D and O
//     (L2-warm) rides in the first backward sweep, where its loads and
//     arithmetic fill the gaps of the sweep's dependent chain.
//   * The forward substitution of the first solve runs inside the factor
//     loop; one reciprocal square root a pivot is stored with the factor
//     and every division by a pivot is a multiplication.
//
// bt_solve_kernel: one thread per lane, factor in device memory scratch,
//   lane-minor layout [K, n, B]. It takes any K, so it serves horizons
//   whose per-lane factor does not fit shared memory.
//
// Interface: plain C, pointers from torch.Tensor.data_ptr(), launched on
// the caller's stream without synchronising; each function returns the
// cudaError_t of its launch. The caller allocates every array.
//   etol_bt_solve_smem_f32: D [B, K, W, W], O [B, K-1, W, W], r [B, K, W]
//     inputs, x [B, K, W] output.
//   etol_bt_solve_f32: D [K, W*W, B], O [K-1, W*W, B], r [K, W, B] inputs,
//     x [K, W, B] output, and scratch
//       lfac [K, W(W+1)/2, B]  packed lower Cholesky factors
//       lsub [K-1, W*W, B]     sub-diagonal factors Lsub_k (row-major)
//       y [K, W, B]            forward-sweep result (reused by refinement)
//       c [K, W, B]            refinement right-hand side r - H x
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

// ---------------------------------------------------------------------
// The shared-memory kernel: a lane split across W threads of one warp.
// ---------------------------------------------------------------------

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// A node's packed factor and its Lsub start on 16 bytes in shared memory
// (the lane stride is a multiple of 4 floats), so that a thread reads
// them four floats a load.
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// n floats (n a multiple of 4) from 16-byte aligned shared memory, the
// first `keep` of them into out
template <int N, int KEEP>
__device__ __forceinline__ void load_vec(const float* src,
                                         float (&out)[KEEP]) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = p[q];
    if (4 * q + 0 < KEEP) out[4 * q + 0] = v.x;
    if (4 * q + 1 < KEEP) out[4 * q + 1] = v.y;
    if (4 * q + 2 < KEEP) out[4 * q + 2] = v.z;
    if (4 * q + 3 < KEEP) out[4 * q + 3] = v.w;
  }
}

// What thread i of a lane's group reads of node k in the native layout:
// row i of D_k, column i of O_k (k < K-1) and entry i of r_k. The loads
// are started one node ahead of their use, so that the factor of node k
// covers their latency.
template <int W>
struct NodeIn {
  float d[W], o[W], r;
};

template <int W>
__device__ __forceinline__ void load_node(NodeIn<W>& in,
                                          const float* __restrict__ Db,
                                          const float* __restrict__ Ob,
                                          const float* __restrict__ rb, int k,
                                          int K, int i) {
  constexpr int W2 = W * W;
  if (k >= K) return;
#pragma unroll
  for (int j = 0; j < W; ++j) in.d[j] = __ldg(Db + k * W2 + i * W + j);
  in.r = __ldg(rb + k * W + i);
  if (k < K - 1) {
#pragma unroll
    for (int t = 0; t < W; ++t) in.o[t] = __ldg(Ob + k * W2 + t * W + i);
  }
}

// What thread i reads of node k for the residual: row i of D_k, entry i
// of r_k, and row i and column i of O_k (k < K-1).
template <int W>
struct ResIn {
  float drow[W], orow[W], ocol[W], r;
};

template <int W>
__device__ __forceinline__ void load_res(ResIn<W>& in,
                                         const float* __restrict__ Db,
                                         const float* __restrict__ Ob,
                                         const float* __restrict__ rb, int k,
                                         int K, int i) {
  constexpr int W2 = W * W;
  if (k < 0) return;
#pragma unroll
  for (int j = 0; j < W; ++j) in.drow[j] = __ldg(Db + k * W2 + i * W + j);
  in.r = __ldg(rb + k * W + i);
  if (k < K - 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      in.orow[j] = __ldg(Ob + k * W2 + i * W + j);
      in.ocol[j] = __ldg(Ob + k * W2 + j * W + i);
    }
  }
}

// every thread of a group gets v of the group's thread t, t = 0..W-1
template <int W>
__device__ __forceinline__ void gather(float v, int base, float (&out)[W]) {
#pragma unroll
  for (int t = 0; t < W; ++t) out[t] = __shfl_sync(kFull, v, base + t);
}

// The packed factor of node k from shared memory, as full rows and the
// reciprocal pivots (stored in the diagonal's slots).
template <int W>
__device__ __forceinline__ void load_factor(const float* lf,
                                            float (&L)[W * (W + 1) / 2],
                                            float (&inv)[W]) {
  load_vec<pad4(W * (W + 1) / 2), W * (W + 1) / 2>(lf, L);
#pragma unroll
  for (int t = 0; t < W; ++t) inv[t] = L[tri(t, t)];
}

// solve L y = b with the reciprocal pivots
template <int W>
__device__ __forceinline__ void fwd_inv(const float (&L)[W * (W + 1) / 2],
                                        const float (&inv)[W],
                                        const float (&b)[W], float (&y)[W]) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
    float s = b[t];
#pragma unroll
    for (int u = 0; u < t; ++u) s -= L[tri(t, u)] * y[u];
    y[t] = s * inv[t];
  }
}

// solve L^T x = b with the reciprocal pivots
template <int W>
__device__ __forceinline__ void bwd_inv(const float (&L)[W * (W + 1) / 2],
                                        const float (&inv)[W],
                                        const float (&b)[W], float (&x)[W]) {
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
    float s = b[t];
#pragma unroll
    for (int u = t + 1; u < W; ++u) s -= L[tri(u, t)] * x[u];
    x[t] = s * inv[t];
  }
}

// v[i] for a run-time i, without indexing registers
template <int W>
__device__ __forceinline__ float pick(const float (&v)[W], int i) {
  float out = v[0];
#pragma unroll
  for (int t = 1; t < W; ++t) out = (t == i) ? v[t] : out;
  return out;
}

// Backward sweep of the first solve, L^T x = y, against the factor in
// shared memory, with the refinement's right-hand side
//   c_k = r_k - D_k x_k - O_k x_{k+1} - O_{k-1}^T x_{k-1}
// computed on the way: its loads run one node ahead and its arithmetic
// fills the gaps of the sweep's dependent chain. x_k overwrites y_k in
// place. c_k lacks its last term until x_{k-1} is known, so it waits in
// `pend` for one trip.
template <int W>
__device__ __forceinline__ void backward_first(
    const float* __restrict__ lfac, const float* __restrict__ lsub,
    float* __restrict__ ybuf, float* __restrict__ cbuf,
    const float* __restrict__ Db, const float* __restrict__ Ob,
    const float* __restrict__ rb, int K, int i, int base, bool active) {
  constexpr int W2P = pad4(W * W);
  constexpr int TW = W * (W + 1) / 2;
  constexpr int TWP = pad4(TW);
  float L[TW], inv[W], rhs[W], xk[W], xn[W];
#pragma unroll
  for (int t = 0; t < W; ++t) xn[t] = 0.f;
  float pend = 0.f;
  ResIn<W> in, next;
  load_res<W>(next, Db, Ob, rb, K - 1, K, i);
  for (int k = K - 1; k >= 0; --k) {
    in = next;
    load_res<W>(next, Db, Ob, rb, k - 1, K, i);
    float s = ybuf[k * W + i];
    if (k < K - 1) {
      // x_k = L_k^{-T} (y_k - Lsub_k^T x_{k+1}): column i of Lsub_k
      const float* ls = lsub + k * W2P;
#pragma unroll
      for (int j = 0; j < W; ++j) s -= ls[j * W + i] * xn[j];
    }
    gather<W>(s, base, rhs);
    load_factor<W>(lfac + k * TWP, L, inv);
    bwd_inv<W>(L, inv, rhs, xk);

    float c = in.r;
#pragma unroll
    for (int j = 0; j < W; ++j) c -= in.drow[j] * xk[j];
    if (k < K - 1) {
      float done = pend;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        c -= in.orow[j] * xn[j];
        done -= in.ocol[j] * xk[j];
      }
      if (active) cbuf[(k + 1) * W + i] = done;
    }
    pend = c;
    if (active) ybuf[k * W + i] = pick<W>(xk, i);
#pragma unroll
    for (int t = 0; t < W; ++t) xn[t] = xk[t];
  }
  if (active) cbuf[i] = pend;
}

// Forward sweep of the refinement, L y' = c, in place in c's slots
// (thread i reads the c_k[i] it wrote itself in backward_first).
template <int W>
__device__ __forceinline__ void forward_refine(
    const float* __restrict__ lfac, const float* __restrict__ lsub,
    float* __restrict__ cbuf, int K, int i, int base, bool active) {
  constexpr int W2P = pad4(W * W);
  constexpr int TW = W * (W + 1) / 2;
  constexpr int TWP = pad4(TW);
  float L[TW], inv[W], rhs[W], yk[W];
#pragma unroll
  for (int t = 0; t < W; ++t) yk[t] = 0.f;
  for (int k = 0; k < K; ++k) {
    float s = cbuf[k * W + i];
    if (k > 0) {
      // c_k - Lsub_{k-1} y'_{k-1}: row i of Lsub_{k-1}
      const float* ls = lsub + (k - 1) * W2P + i * W;
#pragma unroll
      for (int t = 0; t < W; ++t) s -= ls[t] * yk[t];
    }
    gather<W>(s, base, rhs);
    load_factor<W>(lfac + k * TWP, L, inv);
    fwd_inv<W>(L, inv, rhs, yk);
    if (active) cbuf[k * W + i] = pick<W>(yk, i);
  }
}

// Backward sweep of the refinement: src holds the correction's forward
// result, xs the first solve's x, and xs_k + correction_k goes out to xg.
template <int W>
__device__ __forceinline__ void backward_last(
    const float* __restrict__ lfac, const float* __restrict__ lsub,
    const float* __restrict__ src, const float* __restrict__ xs,
    float* __restrict__ xg, int K, int i, int base, bool active) {
  constexpr int W2P = pad4(W * W);
  constexpr int TW = W * (W + 1) / 2;
  constexpr int TWP = pad4(TW);
  float L[TW], inv[W], rhs[W], xk[W], xn[W];
#pragma unroll
  for (int t = 0; t < W; ++t) xn[t] = 0.f;
  for (int k = K - 1; k >= 0; --k) {
    float s = src[k * W + i];
    if (k < K - 1) {
      const float* ls = lsub + k * W2P;
#pragma unroll
      for (int j = 0; j < W; ++j) s -= ls[j * W + i] * xn[j];
    }
    gather<W>(s, base, rhs);
    load_factor<W>(lfac + k * TWP, L, inv);
    bwd_inv<W>(L, inv, rhs, xk);
    if (active) xg[k * W + i] = xs[k * W + i] + pick<W>(xk, i);
#pragma unroll
    for (int t = 0; t < W; ++t) xn[t] = xk[t];
  }
}

template <int W>
__global__ void __launch_bounds__(kWarp)
    bt_smem_kernel(const float* __restrict__ D, const float* __restrict__ O,
                   const float* __restrict__ r, float* __restrict__ x, int K,
                   int B, int lpb, int lane_stride) {
  constexpr int W2 = W * W;
  constexpr int W2P = pad4(W2);
  constexpr int TW = W * (W + 1) / 2;
  constexpr int TWP = pad4(TW);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int g = tid / W;               // the group's lane within the block
  const int base = g * W;              // the group's first thread
  const int i = tid - base;            // this thread's row / column
  const int b0 = blockIdx.x * lpb;
  const long long b = b0 + g;
  // threads past the block's last group, and groups past the batch, walk
  // along (the shuffles name the full warp) and store nothing
  const bool active = g < lpb && b < B;
  const int gl = g < lpb ? g : 0;      // a lane whose memory exists
  const long long bl = active ? b : 0;  // a lane whose inputs exist
  const float* Db = D + bl * K * W2;
  const float* Ob = O + bl * (K - 1) * W2;
  const float* rb = r + bl * K * W;

  float* lane = smem + gl * lane_stride;
  float* lfac = lane;                  // [K, TWP], 1/L_ii on the diagonal
  float* lsub = lfac + K * TWP;        // [K, W2P] (K-1 used)
  float* ybuf = lsub + K * W2P;        // [K, W]: y, then x
  float* cbuf = ybuf + K * W;          // [K, W]: c, then the correction's y

  // ---- factor with the forward substitution fused in -----------------
  // Wc: column i of W_{k-1}; Wf: all of it as Lsub_{k-1},
  // Wf[c * W + t] = W_{k-1}[t][c]
  float Wc[W], Wf[W2], yprev[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    Wc[t] = 0.f;
    yprev[t] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < W2; ++e) Wf[e] = 0.f;
  NodeIn<W> in, next;
  load_node<W>(next, Db, Ob, rb, 0, K, i);

  for (int k = 0; k < K; ++k) {
    in = next;
    load_node<W>(next, Db, Ob, rb, k + 1, K, i);

    // row i of S_k = D_k - W_{k-1}^T W_{k-1} and entry i of
    // r_k - Lsub_{k-1} y_{k-1}; Lsub_{k-1}[i][t] = W_{k-1}[t][i] = Wc[t]
    float Srow[W];
    float rhs_i = in.r;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float s = in.d[j];
#pragma unroll
      for (int t = 0; t < W; ++t) s -= Wc[t] * Wf[j * W + t];
      Srow[j] = s;
    }
#pragma unroll
    for (int t = 0; t < W; ++t) rhs_i -= Wc[t] * yprev[t];

    // the lower triangle of S_k and the right-hand side to every thread
    // of the group: the Cholesky below then needs no shuffle between its
    // dependent steps
    float L[TW], inv[W], rfull[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
#pragma unroll
      for (int j = 0; j <= t; ++j)
        L[tri(t, j)] = __shfl_sync(kFull, Srow[j], base + t);
    }
    gather<W>(rhs_i, base, rfull);

    // Cholesky in place, by every thread alike; the diagonal's slots
    // take the reciprocal pivots
#pragma unroll
    for (int j = 0; j < W; ++j) {
      inv[j] = rsqrtf(L[tri(j, j)]);
      L[tri(j, j)] = inv[j];
#pragma unroll
      for (int t = j + 1; t < W; ++t) L[tri(t, j)] *= inv[j];
#pragma unroll
      for (int t = j + 1; t < W; ++t) {
#pragma unroll
        for (int u = j + 1; u <= t; ++u)
          L[tri(t, u)] -= L[tri(t, j)] * L[tri(u, j)];
      }
    }
    // y_k, by every thread alike
    fwd_inv<W>(L, inv, rfull, yprev);
    // the group shares the stores of the factor; thread i stores y_k[i]
    if (active) {
#pragma unroll
      for (int e = 0; e < TW; ++e)
        if (e % W == i) lfac[k * TWP + e] = L[e];
#pragma unroll
      for (int t = 0; t < W; ++t)
        if (t == i) ybuf[k * W + t] = yprev[t];
    }

    // column i of W_k = L_k^{-1} O_k, which is row i of Lsub_k
    if (k < K - 1) {
      fwd_inv<W>(L, inv, in.o, Wc);
      if (active) {
#pragma unroll
        for (int t = 0; t < W; ++t) lsub[k * W2P + i * W + t] = Wc[t];
      }
      // all of W_k back to every thread, four floats a load
      __syncwarp();
      load_vec<W2P, W2>(lsub + k * W2P, Wf);
    }
  }
  __syncwarp();

  // ---- first solve: backward sweep, x into y's slots, c on the way ---
  backward_first<W>(lfac, lsub, ybuf, cbuf, Db, Ob, rb, K, i, base, active);

  // ---- refinement: forward sweep L y' = c, in place -------------------
  forward_refine<W>(lfac, lsub, cbuf, K, i, base, active);
  // ---- and backward sweep; x + correction goes out --------------------
  backward_last<W>(lfac, lsub, cbuf, ybuf, x + b * K * W, K, i, base,
                   active);
}

template <int W>
cudaError_t launch_smem(const float* D, const float* O, const float* r,
                        float* x, int K, int B, int lpb, int lane_stride,
                        int smem_bytes, cudaStream_t stream) {
  constexpr int per_lane = pad4(W * (W + 1) / 2) + pad4(W * W) + 2 * W;
  if (lpb < 1 || lpb * W > kWarp || lane_stride < K * per_lane ||
      lane_stride % 4 != 0 ||
      smem_bytes != (int)sizeof(float) * lpb * lane_stride)
    return cudaErrorInvalidValue;
  // the dynamic shared memory this width was granted on each device, so
  // that a launch asks again only for more (and a launch recorded into a
  // CUDA graph, after one made outside it, only launches)
  static int granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem_bytes > granted[dev]) {
    err = cudaFuncSetAttribute(bt_smem_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) granted[dev] = smem_bytes;
  }
  const int blocks = (B + lpb - 1) / lpb;
  bt_smem_kernel<W><<<blocks, kWarp, smem_bytes, stream>>>(D, O, r, x, K, B,
                                                           lpb, lane_stride);
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

extern "C" int etol_bt_solve_smem_f32(const float* D, const float* O,
                                      const float* r, float* x, int K, int W,
                                      int B, int lpb, int lane_stride,
                                      int smem_bytes, void* stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ETOL_BT_SMEM_CASE(w)                                              \
  case w:                                                                 \
    return (int)launch_smem<w>(D, O, r, x, K, B, lpb, lane_stride,        \
                               smem_bytes, s);
  switch (W) {
    ETOL_BT_SMEM_CASE(1)
    ETOL_BT_SMEM_CASE(2)
    ETOL_BT_SMEM_CASE(3)
    ETOL_BT_SMEM_CASE(4)
    ETOL_BT_SMEM_CASE(5)
    ETOL_BT_SMEM_CASE(6)
    ETOL_BT_SMEM_CASE(7)
    ETOL_BT_SMEM_CASE(8)
    ETOL_BT_SMEM_CASE(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ETOL_BT_SMEM_CASE
}
