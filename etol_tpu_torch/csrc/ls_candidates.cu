// The line search's candidate pass for the separable schemes, float32.
//
// Replaces no TPU kernel: the JAX package writes this pass (the candidate
// block of body_diag in etol_tpu/solve/al_sqp.py) as the node functions
// vmapped over the step grid and leaves it to XLA, which fuses it. The
// port's plain version is the same code under torch.func
// (etol_tpu_torch/solve/al_sqp.py, _ALFuncs.candidate_residuals, then
// al_from_parts and the decrease in _body): each intermediate written to
// device memory at [B, n, K, rows], some 150 small kernels a trip. This
// kernel computes what the Armijo test reads in one launch, for a
// memoryless euler or trapezoidal problem whose dynamics are xdot =
// u[:nx] (the models below), and a second launch gives the chosen step.
//
// What it computes, for each lane b and candidate j with alpha_j:
//   * Zc = clamp(Z + alpha_j p, lb, ub), node by node, written out
//     [B, n, K, w] for the user's running cost, which stays in PyTorch;
//   * the scaled defects c_k = (x_{k+1} - x_k - dt/2 (u_k + u_{k+1})) / cs
//     (trapezoidal) or (x_{k+1} - x_k - dt u_{k+1}) / cs (euler), over the
//     state's nx rows;
//   * the obstacle rows at each node, + obstacle_margin, in the
//     transcription's order (etol_tpu_torch/transcribe/obstacles.py): the
//     edge ellipses, the convex pieces' softmin, the moving zones' balls
//     at the node's precomputed centres;
//   * the AL terms of _ALFuncs.al_from_parts without the cost:
//     sum lam c + rho/2 sum c^2 + 1/(2 rho) sum (max(0, mu + rho g)^2 - mu^2),
//     into val [B, n], and dec [B, n] = sum grad . (Zc - Z).
// No [B, n, K, rows] tensor reaches device memory. Given the chosen
// candidate of each lane (sel [B]), the same arithmetic writes that step's
// point [B, K, w], defects [B, K-1, nx] and rows [B, K, m] instead.
//
// What bounds it on an H100. At the rescue's (K, w, n, B) = (33, 4, 24,
// 2048) with ocp_2d_ex1's 14 rows a node (9 ellipses, 3 pieces of 4
// halfspaces, 2 zones) it reads 12 MB and writes Zc, 26 MB: 11.4 us at
// 3.35 TB/s; it computes 0.66 GFLOP with 29 M exp and log, 9.8 us at 67
// TFLOP/s (ops/ls_candidates.py::cost). The plain version is bound by
// launches and by the intermediates it writes: 3.45 ms replayed in a CUDA
// graph there, where this kernel takes 0.19 ms on an H100 80GB HBM3 at
// 700 W, bound by its instructions' latency (a row's loads and its exp
// and log one after another), not by the bytes.
// The design:
//   * G threads a (lane, candidate), the nodes across them, the sums over
//     nodes by G-wide shuffles: a node's defect reads node k+1, which the
//     thread clamps itself (two clamps a node, no exchange). G is 32 where
//     the groups fit the card at once (the MPC tick's 24 candidates, a
//     warp each, two nodes a thread), else 8, so a K=33 lane wastes 7 of
//     40 node slots and not 31 of 64;
//   * where a warp would take more than two nodes a thread and the card
//     has room (long horizons at small batches: the dry run's K=2048 at
//     B=1, 24 groups), G doubles up to 512, the warps' sums then added
//     through shared memory: one group's 2048 nodes in a warp took 0.22
//     ms, 64 nodes a thread one after another. The chosen launch, which
//     sums nothing, doubles G down to a node a thread wherever the card
//     has room (one warp a lane took 15 us at K=33, B=1);
//   * a lane's obstacle data is read by every thread of its groups, the
//     same address across a group: broadcast loads that the L1 keeps;
//   * at most 80 registers a thread (six blocks an SM, not five): 0.190
//     against 0.223 ms at the rescue's shape on an H100 80GB HBM3 at
//     700 W. The card's fast exp, log and division took it to 0.159 ms,
//     but the MPC tick then ran 1-2% more trips (their errors of a few
//     ulp decide Armijo tests of tiny decreases), so this keeps IEEE
//     division and the accurate expf and logf;
//   * Zc is computed with rounded multiplies and adds, as torch computes
//     Z + alpha p (no contraction), so the user's cost reads the plain
//     route's candidates bit for bit.
//
// The arithmetic (node_terms, lane_value) is plain C++ as well: compiled
// without nvcc it builds on a host compiler, which is how the CPU tests
// hold it against the plain version.
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ETOL_HD __host__ __device__ __forceinline__
#else
#define ETOL_HD inline
#endif

namespace etol_ls {

// One launch's tensors (lane axis first, contiguous, float32 but sel) and
// sizes; ops/ls_candidates.py mirrors this layout.
struct Args {
  const float* Z;           // [B, K, W] the lanes' points
  const float* p;           // [B, K, W] their directions
  const float* lb;          // [B, K, W] bounds
  const float* ub;          // [B, K, W]
  const float* grad;        // [B, K, W] the AL gradient at Z
  const float* alpha;       // [n] step sizes
  const int64_t* sel;       // [B] the chosen candidate; null: all of them
  const float* lam;         // [B, K-1, NX] defect multipliers
  const float* mu;          // [B, K, M] inequality multipliers
  const float* rho;         // [B]
  const float* cs;          // [B, NX] defect scales
  const float* dt;          // [B]
  const float* ell;         // [B, E, 6] centre, cos, sin, a^2, b^2
  const float* ell_mask;    // [B, E]
  const float* hs;          // [B, P, H, 3] a piece's halfspaces n.x <= b
  const float* hs_mask;     // [B, P, H]
  const float* piece_mask;  // [B, P]
  const float* centers;     // [B, K, T, D] the zones' centres at the nodes
  const float* dim_mask;    // [B, T, D]
  const float* radius;      // [B, T]
  const float* track_mask;  // [B, T]
  float* Zc;                // [B, n, K, W]; with sel [B, K, W]
  float* val;               // [B, n] the AL value less the cost
  float* dec;               // [B, n] grad . (Zc - Z)
  float* cd;                // [B, K-1, NX] with sel: the scaled defects
  float* g;                 // [B, K, M] with sel: the inequality rows
  int B, K, n, E, P, H, T, D;
  int ellipses, pieces, tracks;  // the rows the obstacle form has
  int trapezoidal;               // else euler
  float margin;                  // obstacle_margin
};

// Partial sums of one (lane, candidate): sum lam c, sum c^2,
// sum (s^2 - mu^2), sum grad . (Zc - Z).
struct Sums {
  float lc, cc, ss, dec;
};

// torch.clamp: NaN stays NaN (fminf and fmaxf would drop it).
ETOL_HD float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

ETOL_HD float relu_nan(float v) { return v != v ? v : fmaxf(v, 0.0f); }

// z + alpha * p rounded twice, as two torch kernels round it.
ETOL_HD float step(float z, float alpha, float p) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(z, __fmul_rn(alpha, p));
#else
  volatile float ap = alpha * p;
  return z + ap;
#endif
}

ETOL_HD int rows(const Args& a) {
  return (a.ellipses ? a.E : 0) + (a.pieces ? a.P : 0) + (a.tracks ? a.T : 0);
}

// A halfspace n.x <= b's margin b - n.p at the point (px, py); 1e3 for a
// masked row.
ETOL_HD float hs_margin(const float* nb, float mask, float px, float py) {
  return mask > 0.0f ? nb[2] - (nb[0] * px + nb[1] * py) : 1000.0f;
}

// One inequality row g (margin added) into the sums, and into g_out.
ETOL_HD void row(float gv, float mu, float rho, Sums& s, float* g_out, int r) {
  const float s_ = relu_nan(mu + rho * gv);
  s.ss += s_ * s_ - mu * mu;
  if (g_out) g_out[r] = gv;
}

// Node k of lane b at step size alpha: its clamped point (into zc_out when
// given), its step's scaled defects (k < K-1; into cd_out when given) and
// its obstacle rows (into g_out when given), its terms summed first and
// then added into `total` (a node's rows, then the nodes: shorter chains
// of float32 adds than one running sum).
template <int NX, int NU>
ETOL_HD void node_terms(const Args& a, int64_t b, int k, float alpha,
                        float* zc_out, float* cd_out, float* g_out,
                        Sums& total) {
  constexpr int W = NX + NU;
  Sums s = {0.0f, 0.0f, 0.0f, 0.0f};
  static_assert(NU >= NX && NX >= 2, "xdot = u[:nx] in the plane or above");
  const int64_t o = (b * a.K + k) * W;
  float z0[W];
  for (int j = 0; j < W; ++j) {
    const float z = a.Z[o + j];
    const float v = clamp_nan(step(z, alpha, a.p[o + j]), a.lb[o + j],
                              a.ub[o + j]);
    z0[j] = v;
    s.dec += a.grad[o + j] * (v - z);
    if (zc_out) zc_out[j] = v;
  }
  const float rho = a.rho[b];
  if (k + 1 < a.K) {
    float z1[W];
    for (int j = 0; j < W; ++j) {
      z1[j] = clamp_nan(step(a.Z[o + W + j], alpha, a.p[o + W + j]),
                        a.lb[o + W + j], a.ub[o + W + j]);
    }
    const float h = a.dt[b];
    const float* lam = a.lam + (b * (a.K - 1) + k) * NX;
    for (int i = 0; i < NX; ++i) {
      float c = a.trapezoidal
                    ? z1[i] - z0[i] - (h * 0.5f) * (z0[NX + i] + z1[NX + i])
                    : z1[i] - z0[i] - h * z1[NX + i];
      c = c / a.cs[b * NX + i];
      s.lc += lam[i] * c;
      s.cc += c * c;
      if (cd_out) cd_out[i] = c;
    }
  }

  const int M = rows(a);
  const float* mu = a.mu + (b * a.K + k) * M;
  const float px = z0[0], py = z0[1];
  int r = 0;
  if (a.ellipses) {
    for (int e = 0; e < a.E; ++e, ++r) {
      float gv = -1.0f;
      if (a.ell_mask[b * a.E + e] > 0.0f) {
        const float* el = a.ell + (b * a.E + e) * 6;
        const float dx = px - el[0], dy = py - el[1];
        const float delx = el[2] * dx - el[3] * dy;
        const float dely = el[3] * dx + el[2] * dy;
        const float ab = el[4] * el[5];
        gv = (ab - (el[5] * (delx * delx) + el[4] * (dely * dely)))
             / fmaxf(ab, 1e-12f);
      }
      row(gv + a.margin, mu[r], rho, s, g_out, r);
    }
  }
  if (a.pieces) {
    const float tau = 0.05f;
    for (int q = 0; q < a.P; ++q, ++r) {
      float gv = -1000.0f;
      if (a.piece_mask[b * a.P + q] > 0.0f) {
        const float* hp = a.hs + (b * a.P + q) * a.H * 3;
        const float* hm = a.hs_mask + (b * a.P + q) * a.H;
        // softmin = -tau logsumexp(-margin / tau), masked rows 1e3 away
        float top = -INFINITY, nrows = 0.0f;
        for (int h = 0; h < a.H; ++h) {
          top = fmaxf(top, -hs_margin(hp + 3 * h, hm[h], px, py) / tau);
          nrows += hm[h];
        }
        float sum = 0.0f;
        for (int h = 0; h < a.H; ++h) {
          sum += expf(-hs_margin(hp + 3 * h, hm[h], px, py) / tau - top);
        }
        gv = -tau * (logf(sum) + top) + tau * logf(fmaxf(nrows, 1.0f));
      }
      row(gv + a.margin, mu[r], rho, s, g_out, r);
    }
  }
  if (a.tracks) {
    const float* cen = a.centers + (b * a.K + k) * a.T * a.D;
    for (int t = 0; t < a.T; ++t, ++r) {
      float gv = -1.0f;
      if (a.track_mask[b * a.T + t] > 0.0f) {
        float d2 = 0.0f;
        for (int d = 0; d < a.D; ++d) {
          const float diff = (d < NX ? z0[d] : 0.0f) - cen[t * a.D + d];
          d2 += a.dim_mask[(b * a.T + t) * a.D + d] * (diff * diff);
        }
        const float rr = a.radius[b * a.T + t];
        const float rsq = rr * rr;
        gv = (rsq - d2) / fmaxf(rsq, 1e-12f);
      }
      row(gv + a.margin, mu[r], rho, s, g_out, r);
    }
  }
  total.lc += s.lc;
  total.cc += s.cc;
  total.ss += s.ss;
  total.dec += s.dec;
}

// A candidate's AL value less the cost, from its summed terms.
ETOL_HD float lane_value(const Sums& s, float rho) {
  return s.lc + (0.5f * rho) * s.cc + (0.5f / rho) * s.ss;
}

}  // namespace etol_ls

#ifdef __CUDACC__

namespace {

using namespace etol_ls;

constexpr int kThreads = 128;
// blocks an SM holds at once: at most 80 registers a thread (96
// unbounded), 24 warps an SM in place of 20
constexpr int kBlocks = 6;
// the card's threads at once: 132 SMs of 2048
constexpr long long kCardThreads = 132LL * 2048;
// the widest group
constexpr int kMaxG = 512;

// A group of G threads in blocks of kThreads, or a block of its own where
// it is wider; as many registers a thread as kBlocks blocks of kThreads
// allow.
template <int G>
struct Block {
  static constexpr int threads = G > kThreads ? G : kThreads;
  static constexpr int min = kBlocks * kThreads / threads > 0
                                 ? kBlocks * kThreads / threads : 1;
};

// Every candidate of every lane (CHOSEN false: Zc, val, dec), or each
// lane's chosen one (CHOSEN true: Zc, cd, g), G threads a group.
template <int NX, int NU, int G, bool CHOSEN>
__global__ void __launch_bounds__(Block<G>::threads, Block<G>::min)
ls_candidates_kernel(Args a) {
  constexpr int W = NX + NU;
  constexpr int BT = Block<G>::threads;
  const long long tid = (long long)blockIdx.x * BT + threadIdx.x;
  const long long group = tid / G;
  const int t = (int)(tid % G);
  const int n = CHOSEN ? 1 : a.n;
  const bool valid = group < (long long)a.B * n;
  const long long b = valid ? group / n : 0;
  Sums s = {0.0f, 0.0f, 0.0f, 0.0f};
  if (valid) {
    const float alpha = CHOSEN ? a.alpha[a.sel[b]] : a.alpha[group % n];
    float* zc = a.Zc + group * a.K * W;
    const int M = rows(a);
    for (int k = t; k < a.K; k += G) {
      float* cd = CHOSEN && k + 1 < a.K ? a.cd + (b * (a.K - 1) + k) * NX
                                        : nullptr;
      float* g = CHOSEN ? a.g + (b * a.K + k) * M : nullptr;
      node_terms<NX, NU>(a, b, k, alpha, zc + k * W, cd, g, s);
    }
  }
  if (CHOSEN) return;
  constexpr int WG = G < 32 ? G : 32;
#pragma unroll
  for (int off = WG / 2; off > 0; off /= 2) {
    s.lc += __shfl_xor_sync(0xffffffffu, s.lc, off);
    s.cc += __shfl_xor_sync(0xffffffffu, s.cc, off);
    s.ss += __shfl_xor_sync(0xffffffffu, s.ss, off);
    s.dec += __shfl_xor_sync(0xffffffffu, s.dec, off);
  }
  if (G > 32) {
    // a group of several warps: their sums through shared memory, added
    // by the group's first thread
    __shared__ Sums part[BT / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) part[warp] = s;
    __syncthreads();
    if (t == 0) {
      for (int i = 1; i < G / 32; ++i) {
        s.lc += part[warp + i].lc;
        s.cc += part[warp + i].cc;
        s.ss += part[warp + i].ss;
        s.dec += part[warp + i].dec;
      }
    }
  }
  if (valid && t == 0) {
    a.val[group] = lane_value(s, a.rho[b]);
    a.dec[group] = s.dec;
  }
}

template <int NX, int NU, int G>
cudaError_t launch_g(const Args& a, long long groups, cudaStream_t st) {
  constexpr int BT = Block<G>::threads;
  const long long blocks = (groups * G + BT - 1) / BT;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.sel) {
    ls_candidates_kernel<NX, NU, G, true><<<(unsigned)blocks, BT, 0, st>>>(
        a);
  } else {
    ls_candidates_kernel<NX, NU, G, false><<<(unsigned)blocks, BT, 0, st>>>(
        a);
  }
  return cudaGetLastError();
}

// G from the launch's shape: 8 where a warp a group would not fit the card
// at once, else 32, doubled while the doubled groups still fit and a
// thread would take more than two nodes, or more than one in the chosen
// launch (which sums nothing, so G leaves its values as they are).
template <int NX, int NU>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const long long groups = a.sel ? a.B : (long long)a.B * a.n;
  if (groups * 32 > kCardThreads) return launch_g<NX, NU, 8>(a, groups, st);
  const int nodes = a.sel ? 1 : 2;
  int g = 32;
  while (g < kMaxG && (a.K + g - 1) / g > nodes &&
         groups * 2 * g <= kCardThreads)
    g *= 2;
  switch (g) {
    case 32:
      return launch_g<NX, NU, 32>(a, groups, st);
    case 64:
      return launch_g<NX, NU, 64>(a, groups, st);
    case 128:
      return launch_g<NX, NU, 128>(a, groups, st);
    case 256:
      return launch_g<NX, NU, 256>(a, groups, st);
    default:
      return launch_g<NX, NU, kMaxG>(a, groups, st);
  }
}

}  // namespace

// The candidate pass of the model with id `model` (0: the planar single
// integrator, 1: the 3-D point mass) on `stream`: every candidate's Zc,
// val and dec, or with a->sel each lane's chosen step's Zc, cd and g.
// Returns the launch's cudaError.
extern "C" int etol_ls_candidates_f32(int model, const etol_ls::Args* a,
                                      void* stream) {
  if (a->K < 2 || a->B < 1 || a->n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case 0:
      return (int)launch<2, 2>(*a, s);
    case 1:
      return (int)launch<3, 3>(*a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
