// The Hermite-Simpson step coupling of the AL Hessian blocks, float32.
//
// Replaces no TPU kernel: the JAX package writes this part of the block
// assembly (_ALFuncs._pair_coupling in etol_tpu/solve/al_sqp.py) as
// jacfwd and hessian of the step defect under vmap and leaves it to XLA,
// which fuses it. The port's plain version is the same code under
// torch.func (etol_tpu_torch/solve/al_sqp.py, _ALFuncs._pair_coupling):
// about 660 small kernels a trip, each a few microseconds of launch for
// nanoseconds of arithmetic. This kernel computes what that function
// returns in one launch, for a memoryless Hermite-Simpson problem whose
// dynamics are one of the models below.
//
// What it computes, for each lane and step k with a = z_k, b = z_{k+1}
// (w = nx + nu, no parameter columns):
//   * the defect c = x1 - x0 - dt/6 (f0 + 4 fm + f1), with
//     xm = (x0 + x1)/2 + dt/8 (f0 - f1), um = (u0 + u1)/2,
//     tm = (t0 + t1)/2 (etol_tpu_torch/transcribe/collocation.py);
//   * its scaled Jacobians A = dc/da / cs and B = dc/db / cs (row-wise);
//   * unless the solver's hessian is "gn", the exact curvature of
//     sum_i s_i c_i / cs_i, with s = lam_k + rho c / cs held constant,
//     split into its aa, bb and ab quadrants;
//   * the Gauss-Newton products: rho A^T A + Haa onto Dc_k, rho B^T B +
//     Hbb onto Dc_{k+1}, and O_k = rho A^T B + Hab.
// It writes Dc [B, K, w, w] and O [B, K-1, w, w] whole.
//
// Derivatives. The only per-model code is f, written once as a template
// over its number type (struct Unicycle). The kernel evaluates it on its
// own forward-mode numbers: Dual<N> (a value and N first derivatives)
// for the Jacobians of f at z0 and z1, and Jet<N> (also the N(N+1)/2
// second derivatives) at zm, and at z0 and z1 for the weighted Hessians
// in the exact mode. The Hermite-Simpson chain rule is written once over
// those, for any f: with M = d zm / d(a, b) and w_i = s_i / cs_i,
//   d2(w.c) = -dt/6 [ d2((w + dt/2 g).f)(z0) (+) d2((w - dt/2 g).f)(z1)
//                     + 4 M^T (sum_i w_i d2 f_i(zm)) M ],
// where g = Jf(zm)^T w restricted to the state rows: zm's state rows
// carry dt/8 (f0 - f1), so fm's second derivatives pick up the dt/8
// curvature of f at both ends. Everything a step needs stays in
// registers.
//
// What bounds it on an H100. By the roofline it is bound by bytes: at
// (K, w, B) = (51, 5, 2048) it reads Z and the multipliers (3.4 MB) and
// writes Dc and O (20.6 MB), 7.2 us at 3.35 TB/s, against ~2,000 flops a
// step of chain rule and products (0.21 GFLOP, 3.1 us at 67 TFLOP/s;
// ops/hs_coupling.py::cost). The plain version is bound by launches:
// ~660 kernels, 0.80 ms replayed in a CUDA graph at one lane and 3.34 ms
// at 2048 on an NVIDIA H100 80GB HBM3 at 700 W, where this kernel takes
// 0.009 and 0.033 ms. At small batches a launch is one short wave, and
// its time is one thread's dependent chain of jets and products. The
// design answers both:
//   * One thread a (lane, step): 104k threads at B = 2048 fill the 132
//     SMs; at B = 64 it is one short launch. A block of T threads takes
//     T - 1 consecutive (lane, node) positions of the flattened batch and
//     one position before them: each thread computes its step, and the
//     bb part it adds to the next node goes to its neighbour through
//     shared memory, so Dc is written without atomics and no step is
//     computed twice but the one a block shares with the block before.
//   * A block's nodes are contiguous in Dc, and their steps in O, so the
//     blocks are staged in shared memory and stored by the whole block,
//     neighbouring threads on neighbouring addresses, not 100-byte
//     strided runs a thread.
//   * The transcendentals and jets of f are computed once a point; the
//     exact mode's Hessians at z0 and z1 are evaluated again after the
//     weights are known, which keeps a single point's second derivatives
//     live at a time.
//
// The arithmetic (the numbers, the models, step_coupling) is plain C++
// as well: compiled without nvcc it builds on a host compiler, which is
// how the CPU tests hold it against the plain version.
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ETOL_HD __host__ __device__ __forceinline__
#else
#define ETOL_HD inline
#endif

namespace etol_hs {

ETOL_HD constexpr int tri(int n) { return n * (n + 1) / 2; }

// Index of (i, j), i <= j, in a packed upper triangle of an n x n matrix.
ETOL_HD int sym(int n, int i, int j) {
  return i <= j ? i * n - i * (i - 1) / 2 + (j - i)
                : j * n - j * (j - 1) / 2 + (i - j);
}

// A value and its N first derivatives.
template <int N>
struct Dual {
  float v;
  float d[N];
};

// A value, its N first derivatives and its second derivatives (packed
// upper triangle).
template <int N>
struct Jet {
  float v;
  float d[N];
  float h[tri(N)];
};

template <int N>
ETOL_HD Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <int N>
ETOL_HD Jet<N> operator*(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  int n = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j, ++n) {
      r.h[n] = a.h[n] * b.v + a.v * b.h[n] + a.d[i] * b.d[j]
               + a.d[j] * b.d[i];
    }
  }
  return r;
}

// phi(a) from phi(a.v), phi'(a.v) and phi''(a.v).
template <int N>
ETOL_HD Dual<N> chain(const Dual<N>& a, float p0, float p1, float) {
  Dual<N> r;
  r.v = p0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = p1 * a.d[i];
  return r;
}

template <int N>
ETOL_HD Jet<N> chain(const Jet<N>& a, float p0, float p1, float p2) {
  Jet<N> r;
  r.v = p0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = p1 * a.d[i];
  int n = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j, ++n) {
      r.h[n] = p1 * a.h[n] + p2 * a.d[i] * a.d[j];
    }
  }
  return r;
}

template <int N>
ETOL_HD Dual<N> sin(const Dual<N>& a) {
  return chain(a, sinf(a.v), cosf(a.v), 0.0f);
}

template <int N>
ETOL_HD Jet<N> sin(const Jet<N>& a) {
  float s = sinf(a.v);
  return chain(a, s, cosf(a.v), -s);
}

template <int N>
ETOL_HD Dual<N> cos(const Dual<N>& a) {
  return chain(a, cosf(a.v), -sinf(a.v), 0.0f);
}

template <int N>
ETOL_HD Jet<N> cos(const Jet<N>& a) {
  float c = cosf(a.v);
  return chain(a, c, -sinf(a.v), -c);
}

// The models: f(x, u, t) -> xdot over any of the number types, as
// etol_tpu_torch/models/dynamics.py writes them. The wrapper's table
// (etol_tpu_torch/ops/hs_coupling.py, models()) gives each its id.

// models/dynamics.py::unicycle: x = [px, py, heading], u = [speed, turn].
struct Unicycle {
  static constexpr int NX = 3, NU = 2;
  template <class T>
  ETOL_HD static void f(const T* x, const T* u, float, T* out) {
    T c = cos(x[2]), s = sin(x[2]);
    out[0] = u[0] * c;
    out[1] = u[0] * s;
    out[2] = u[1];
  }
};

// f at the node z (nx states, then nu controls) on numbers that carry
// the derivatives by each of z's w entries.
template <class M, class T>
ETOL_HD void eval(const float* z, float t, T* out) {
  constexpr int W = M::NX + M::NU;
  T in[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    in[i] = T{};
    in[i].v = z[i];
    in[i].d[i] = 1.0f;
  }
  M::f(in, in + M::NX, t, out);
}

// One step's coupling: Daa and Dbb (packed upper triangles, w x w) and
// Oab (row-major w x w). z0, z1: the step's two nodes; lam, cs: the
// step's multipliers and the defect's row scales (nx each).
template <class M, bool EXACT>
ETOL_HD void step_coupling(const float* z0, const float* z1,
                           const float* lam, const float* cs, float rho,
                           float dt, float t0, float* Daa, float* Dbb,
                           float* Oab) {
  constexpr int NX = M::NX, NU = M::NU, W = NX + NU, TW = tri(W);
  const float t1 = t0 + dt, tm = 0.5f * (t0 + t1);
  const float h8 = dt / 8.0f, h6 = dt / 6.0f;

  // f and its Jacobian at both ends
  float f0[NX], f1[NX], J0[NX][W], J1[NX][W];
  {
    Dual<W> o0[NX], o1[NX];
    eval<M>(z0, t0, o0);
    eval<M>(z1, t1, o1);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      f0[i] = o0[i].v;
      f1[i] = o1[i].v;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        J0[i][j] = o0[i].d[j];
        J1[i][j] = o1[i].d[j];
      }
    }
  }
  // the midpoint
  float zm[W];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    zm[i] = 0.5f * (z0[i] + z1[i]) + h8 * (f0[i] - f1[i]);
  }
#pragma unroll
  for (int i = NX; i < W; ++i) zm[i] = 0.5f * (z0[i] + z1[i]);
  // f at the midpoint; its second derivatives only in the exact mode
  float fm[NX], Jm[NX][W];
  float Hw[TW];  // sum_i w_i d2 f_i(zm)
  float wt[NX];  // w_i = s_i / cs_i
  float c[NX];
  if constexpr (EXACT) {
    Jet<W> om[NX];
    eval<M>(zm, tm, om);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      fm[i] = om[i].v;
#pragma unroll
      for (int j = 0; j < W; ++j) Jm[i][j] = om[i].d[j];
      c[i] = z1[i] - z0[i] - h6 * (f0[i] + 4.0f * fm[i] + f1[i]);
      wt[i] = (lam[i] + rho * (c[i] / cs[i])) / cs[i];
    }
#pragma unroll
    for (int n = 0; n < TW; ++n) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += wt[i] * om[i].h[n];
      Hw[n] = acc;
    }
  } else {
    Dual<W> om[NX];
    eval<M>(zm, tm, om);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      fm[i] = om[i].v;
#pragma unroll
      for (int j = 0; j < W; ++j) Jm[i][j] = om[i].d[j];
    }
  }

  // Ma = d zm / da, Mb = d zm / db: state rows 1/2 E +- dt/8 J, control
  // rows 1/2 E
  float Ma[W][W], Mb[W][W];
#pragma unroll
  for (int r = 0; r < W; ++r) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      float e = (r == q) ? 0.5f : 0.0f;
      Ma[r][q] = r < NX ? e + h8 * J0[r][q] : e;
      Mb[r][q] = r < NX ? e - h8 * J1[r][q] : e;
    }
  }
  // A = dc/da / cs, B = dc/db / cs
  float A[NX][W], Bm[NX][W];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      float ma = 0.0f, mb = 0.0f;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        ma += Jm[i][r] * Ma[r][q];
        mb += Jm[i][r] * Mb[r][q];
      }
      float e = (i == q) ? 1.0f : 0.0f;
      A[i][q] = (-e - h6 * (J0[i][q] + 4.0f * ma)) / cs[i];
      Bm[i][q] = (e - h6 * (J1[i][q] + 4.0f * mb)) / cs[i];
    }
  }
  // the Gauss-Newton products
  {
    int n = 0;
#pragma unroll
    for (int p = 0; p < W; ++p) {
#pragma unroll
      for (int q = p; q < W; ++q, ++n) {
        float aa = 0.0f, bb = 0.0f;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          aa += A[i][p] * A[i][q];
          bb += Bm[i][p] * Bm[i][q];
        }
        Daa[n] = rho * aa;
        Dbb[n] = rho * bb;
      }
    }
#pragma unroll
    for (int p = 0; p < W; ++p) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        float ab = 0.0f;
#pragma unroll
        for (int i = 0; i < NX; ++i) ab += A[i][p] * Bm[i][q];
        Oab[p * W + q] = rho * ab;
      }
    }
  }
  if constexpr (EXACT) {
    // the end weights w +- dt/2 g, g = Jm^T w on the state rows
    float v0[NX], v1[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      float g = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) g += wt[i] * Jm[i][r];
      v0[r] = wt[r] + 0.5f * dt * g;
      v1[r] = wt[r] - 0.5f * dt * g;
    }
    // 4 M^T Hw M over the quadrants: HMa = Hw Ma, HMb = Hw Mb
    float HMa[W][W], HMb[W][W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int m = 0; m < W; ++m) {
          float h = Hw[sym(W, r, m)];
          sa += h * Ma[m][q];
          sb += h * Mb[m][q];
        }
        HMa[r][q] = sa;
        HMb[r][q] = sb;
      }
    }
#pragma unroll
    for (int p = 0; p < W; ++p) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        float ab = 0.0f;
#pragma unroll
        for (int r = 0; r < W; ++r) ab += Ma[r][p] * HMb[r][q];
        Oab[p * W + q] -= h6 * (4.0f * ab);
      }
    }
    {
      Jet<W> o0[NX];
      eval<M>(z0, t0, o0);
      int n = 0;
#pragma unroll
      for (int p = 0; p < W; ++p) {
#pragma unroll
        for (int q = p; q < W; ++q, ++n) {
          float aa = 0.0f, e0 = 0.0f;
#pragma unroll
          for (int r = 0; r < W; ++r) aa += Ma[r][p] * HMa[r][q];
#pragma unroll
          for (int i = 0; i < NX; ++i) e0 += v0[i] * o0[i].h[n];
          Daa[n] -= h6 * (e0 + 4.0f * aa);
        }
      }
    }
    {
      Jet<W> o1[NX];
      eval<M>(z1, t1, o1);
      int n = 0;
#pragma unroll
      for (int p = 0; p < W; ++p) {
#pragma unroll
        for (int q = p; q < W; ++q, ++n) {
          float bb = 0.0f, e1 = 0.0f;
#pragma unroll
          for (int r = 0; r < W; ++r) bb += Mb[r][p] * HMb[r][q];
#pragma unroll
          for (int i = 0; i < NX; ++i) e1 += v1[i] * o1[i].h[n];
          Dbb[n] -= h6 * (e1 + 4.0f * bb);
        }
      }
    }
  }
}

}  // namespace etol_hs

#ifdef __CUDACC__

namespace {

using namespace etol_hs;

// Threads a block: T - 1 (lane, node) positions and the one before them.
constexpr int kThreads = 128;

// Steps of the flattened batch before the (lane, node) position p.
__device__ __forceinline__ long long steps_before(long long p, int K) {
  long long lane = p / K;
  long long k = p - lane * K;
  return lane * (K - 1) + (k < K - 1 ? k : K - 1);
}

template <class M, bool EXACT>
__global__ void __launch_bounds__(kThreads)
hs_coupling_kernel(const float* __restrict__ Z, const float* __restrict__ lam,
                   const float* __restrict__ rho,
                   const float* __restrict__ cs, const float* __restrict__ dt,
                   float* __restrict__ Dc, float* __restrict__ O, int K,
                   int B) {
  constexpr int NX = M::NX, W = NX + M::NU, WW = W * W, TW = tri(W);
  constexpr int T = kThreads;
  static_assert((T * TW + 2 * (T - 1) * WW) * 4 <= 48 * 1024,
                "a block's shared memory");
  __shared__ float xch[T * TW];         // each thread's Dbb
  __shared__ float sD[(T - 1) * WW];    // the block's nodes of Dc
  __shared__ float sO[(T - 1) * WW];    // the block's steps of O

  const int t = threadIdx.x;
  const long long total = (long long)B * K;
  const long long p_lo = (long long)blockIdx.x * (T - 1);
  const long long p = p_lo + t - 1;
  const bool valid = p >= 0 && p < total;
  const long long lane = valid ? p / K : 0;
  const int k = valid ? (int)(p - lane * K) : 0;
  const bool step = valid && k < K - 1;

  float Daa[TW], Dbb[TW], Oab[WW];
#pragma unroll
  for (int i = 0; i < TW; ++i) Daa[i] = Dbb[i] = 0.0f;
  if (step) {
    const float* z0 = Z + p * W;
    const float h = dt[lane];
    step_coupling<M, EXACT>(z0, z0 + W, lam + (lane * (K - 1) + k) * NX,
                            cs + lane * NX, rho[lane], h, (float)k * h, Daa,
                            Dbb, Oab);
  }
#pragma unroll
  for (int i = 0; i < TW; ++i) xch[t * TW + i] = Dbb[i];
  __syncthreads();

  const long long q_lo = steps_before(p_lo, K);
  if (t >= 1 && valid) {
    float* d = sD + (t - 1) * WW;
    const float* prev = xch + (t - 1) * TW;
#pragma unroll
    for (int r = 0; r < W; ++r) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        int n = sym(W, r, q);
        d[r * W + q] = Daa[n] + (k > 0 ? prev[n] : 0.0f);
      }
    }
    if (step) {
      float* o = sO + (steps_before(p, K) - q_lo) * WW;
#pragma unroll
      for (int i = 0; i < WW; ++i) o[i] = Oab[i];
    }
  }
  __syncthreads();

  // the block's nodes of Dc and its steps of O, each one contiguous run
  const long long p_hi = p_lo + (T - 1) < total ? p_lo + (T - 1) : total;
  const long long nD = (p_hi - p_lo) * WW;
  for (long long i = t; i < nD; i += T) Dc[p_lo * WW + i] = sD[i];
  const long long nO = (steps_before(p_hi, K) - q_lo) * WW;
  for (long long i = t; i < nO; i += T) O[q_lo * WW + i] = sO[i];
}

template <class M>
cudaError_t launch(const float* Z, const float* lam, const float* rho,
                   const float* cs, const float* dt, float* Dc, float* O,
                   int K, int B, int exact, cudaStream_t s) {
  const long long total = (long long)B * K;
  const long long blocks = (total + kThreads - 2) / (kThreads - 1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (exact) {
    hs_coupling_kernel<M, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        Z, lam, rho, cs, dt, Dc, O, K, B);
  } else {
    hs_coupling_kernel<M, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        Z, lam, rho, cs, dt, Dc, O, K, B);
  }
  return cudaGetLastError();
}

}  // namespace

// Dc [B, K, w, w] and O [B, K-1, w, w] of the model with id `model`
// (0: the unicycle) from Z [B, K, w], lam [B, K-1, nx], rho [B],
// cs [B, nx] and dt [B], on `stream`; exact != 0 adds the curvature.
// Returns the launch's cudaError.
extern "C" int etol_hs_coupling_f32(int model, const float* Z,
                                    const float* lam, const float* rho,
                                    const float* cs, const float* dt,
                                    float* Dc, float* O, int K, int B,
                                    int exact, void* stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case 0:
      return (int)launch<Unicycle>(Z, lam, rho, cs, dt, Dc, O, K, B, exact,
                                   s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
