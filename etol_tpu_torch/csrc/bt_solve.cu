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
// batches from 64 to 2048 (one wave of blocks at each), where the first
// port, one thread a lane with its factor in device memory, took
// 0.67-1.18 ms.
// One warp starts a shuffle or a shared-memory access only every few
// cycles, so the design counts those, not the arithmetic.
//
// Two kernels, one node step; the wrapper chooses from (K, w) alone:
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
// bt_stream_kernel: the long horizons, whose lane factor does not fit a
//   block's shared memory (w = 4 from K = 1615, w = 5 from 1077, w = 9
//   from 388). It replaces the first port's kernel there, one thread a
//   lane with lane-minor copies, which took 6 us a node at B=1 (12.4 ms at
//   K=2048, w=5) against the shared-memory kernel's 0.7-0.9 us. What
//   bounds it is the same K-long dependent chain, not bytes: at (2048, 5,
//   1) the bytes bound is 0.15 us. The design answers the three things
//   that held that kernel back:
//   * One thread did all of a lane's arithmetic, with a sqrtf and a
//     division a pivot. Here the node step is bt_smem_kernel's, the same
//     code (lane_solve, templated on where the scratch lives): a lane
//     over W threads, rsqrtf pivots, shuffles.
//   * Every pass waited on device memory at every node. Here the lane's
//     factor, Lsub, y and c go to one scratch array in device memory, in
//     the shared-memory kernel's per-lane layout (a node's factor and
//     Lsub one run on 16 bytes), and every sweep that reads them back
//     takes them a chunk of 16 nodes at a time from a shared-memory
//     buffer: the Tensor Memory Accelerator copies the chunk's node runs
//     and its entries of y or c (one bulk copy each, counted in by the
//     buffer's mbarrier) into the other of two buffers while this one is
//     read (StreamLane). A copy thus has 16 node times (~20 us) to land,
//     where a read from L2 or device memory takes well under 1 us.
//     Why chunks and the TMA: with one warp on an SM, what costs is the
//     instructions that start and wait for copies, not their latency.
//     Timed on an H100 sweep by sweep, 16-byte cp.async copies of each
//     node's run, or one bulk copy a node, added more to a sweep node
//     than the shared-memory kernel's whole sweep node takes, and as much
//     one node ahead as eight; copies a chunk of 16 nodes at a time leave
//     a fraction of that. The factor loop only stores (the stores do not
//     wait) and hands W_k round the group through a buffer, and
//     D, O, r are read one node ahead, as in the shared-memory kernel.
//     No load sits on the chain.
//   * The wrapper made lane-minor copies of D, O, r and x. Here they are
//     read and written in their native layout, and the residual's second
//     reading of D and O rides in the first backward sweep.
//   The scratch at (2048, 5, 1) is 0.44 MB and at (2048, 5, 64) 28 MB:
//   it stays in the 50 MB L2 up to about 40 MB.
//
// Interface: plain C, pointers from torch.Tensor.data_ptr(), launched on
// the caller's stream without synchronising; each function returns the
// cudaError_t of its launch. The caller allocates every array.
//   etol_bt_solve_smem_f32: D [B, K, W, W], O [B, K-1, W, W], r [B, K, W]
//     inputs, x [B, K, W] output.
//   etol_bt_solve_stream_f32: the same, and scratch [B, lane_stride]
//     (16-byte aligned, lane_stride >= K (p4(W(W+1)/2) + p4(W*W) + 2W) and
//     a multiple of 4).
#include <cuda_runtime.h>

#include <cstdint>

// the kernels' dynamic shared memory
extern __shared__ float4 etol_bt_smem[];

namespace {

__device__ __forceinline__ float* dyn_smem() {
  return reinterpret_cast<float*>(etol_bt_smem);
}

__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// ---------------------------------------------------------------------
// The lane-split kernels: a lane across W threads of one warp. Their
// node step is one body, lane_solve, templated on where the lane's
// scratch lives: SmemLane (bt_smem_kernel) or StreamLane
// (bt_stream_kernel).
// ---------------------------------------------------------------------

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// A node's packed factor and its Lsub start on 16 bytes (the lane stride
// is a multiple of 4 floats), so that a thread reads them four floats a
// load.
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

// The Tensor Memory Accelerator's bulk copy from device memory to shared
// memory, and the shared-memory barrier (mbarrier) that counts its bytes
// in: the thread that starts a copy announces its bytes on the barrier,
// the copy's completion pays them, and a thread that waits for the
// barrier's phase then sees the copied data.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A lane's scratch: K node runs of the packed factor (1/L_ii in the
// diagonal's slots) and Lsub_k (K-1 used), [K, TWP + W2P], each on 16
// bytes; then y (later x) [K, W] and c (later the correction's forward
// result) [K, W]. A sweep names the arrays it reads by kY and kC.
template <int W>
struct LaneLayout {
  static constexpr int TWP = pad4(W * (W + 1) / 2);
  static constexpr int W2P = pad4(W * W);
  static constexpr int kNode = TWP + W2P;
};

enum Vec { kNoVec = 0, kY = 1, kC = 2 };

// The scratch in shared memory, at float `off` of the block's dynamic
// shared memory (an offset from the array itself, so that every access is
// a shared-memory one): a sweep reads node k where it lies, in one loop
// over the K nodes (kChunk 0).
//   node(k), y(k), c(k): node k's run, its entries of y and c
//   put_w: row i of W_k to its Lsub slot; w_back: where the group reads
//     all of W_k back
//   begin(dir, a, b): a sweep (see sweep()) that reads the thread's
//     entries of the arrays a and b (kY, kC or kNoVec)
//   enter(q): chunk q of the sweep is readable: fac(k), sub(k) (node k's
//     factor and Lsub), a(k), b(k)
template <int W>
struct SmemLane : LaneLayout<W> {
  using A = LaneLayout<W>;
  static constexpr int kChunk = 0;
  int off, K, i, aoff = 0, boff = 0;
  __device__ SmemLane(int off_, int K_, int i_) : off(off_), K(K_), i(i_) {}
  __device__ float* node(int k) const { return dyn_smem() + off + k * A::kNode; }
  __device__ float* vec(int v) const {
    return dyn_smem() + off + K * A::kNode + (v == kC ? K * W : 0);
  }
  __device__ float* y(int k) const { return vec(kY) + k * W; }
  __device__ float* c(int k) const { return vec(kC) + k * W; }
  __device__ void put_w(int k, const float (&Wc)[W]) {
#pragma unroll
    for (int t = 0; t < W; ++t) node(k)[A::TWP + i * W + t] = Wc[t];
  }
  __device__ const float* w_back(int k) const { return node(k) + A::TWP; }
  __device__ void begin(int, int a, int b) {
    aoff = off + K * A::kNode + (a == kC ? K * W : 0);
    boff = off + K * A::kNode + (b == kC ? K * W : 0);
  }
  __device__ const float* fac(int k) const { return node(k); }
  __device__ const float* sub(int k) const { return node(k) + A::TWP; }
  __device__ float a(int k) const { return dyn_smem()[aoff + k * W + i]; }
  __device__ float b(int k) const { return dyn_smem()[boff + k * W + i]; }
};

// The scratch in device memory from `base`, read back in chunks of kChunk
// nodes through two chunk buffers in shared memory (at float `ring` of
// the block's dynamic shared memory). A chunk is the nodes' runs (one
// bulk copy) and the run of each array the sweep reads (y or c, one bulk
// copy each; its start rounded down to 16 bytes), started by the group's
// first thread on its buffer's barrier when the sweep enters the chunk
// before, so a copy has a chunk's time, kChunk nodes, to land. The j-th
// chunk copy of the kernel goes to buffer j % 2, and its waiters ask for
// phase parity (j / 2) & 1. A buffer is refilled only after the whole
// group has passed the __syncwarp on entering the next chunk, so nobody
// still reads it. During the factor loop the first buffer's first two
// node slots take W_k in turns, and the stores to device memory are one
// float each (16-byte stores of the same run, which wait for W_k to come
// back, made the factor loop slower on an H100).
template <int W>
struct StreamLane : LaneLayout<W> {
  using A = LaneLayout<W>;
  static constexpr int kChunk = 16;
  static constexpr int kVec = kChunk * W + 4;
  static constexpr int kBuf = kChunk * A::kNode + 2 * kVec;
  static constexpr int kRing = 4 + 2 * kBuf;  // floats a lane: 2 barriers
  float* base;
  int ring, K, i, nch, dir = 1, j0, k0 = 0, bufo = 0, amis = 0, bmis = 0;
  const float* sa = nullptr;
  const float* sb = nullptr;
  bool active;
  __device__ StreamLane(float* base_, int K_, int ring_, int i_,
                        bool active_)
      : base(base_),
        ring(ring_),
        K(K_),
        i(i_),
        nch((K_ + kChunk - 1) / kChunk),
        j0(-((K_ + kChunk - 1) / kChunk)),
        active(active_) {
    if (active && i == 0) {
      mbar_init(bar(0));
      mbar_init(bar(1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
  }
  __device__ unsigned long long* bar(int j) const {
    return reinterpret_cast<unsigned long long*>(dyn_smem() + ring) + (j & 1);
  }
  __device__ float* buffer(int j) const {
    return dyn_smem() + ring + 4 + (j & 1) * kBuf;
  }
  __device__ float* node(int k) const { return base + k * A::kNode; }
  __device__ float* vec(int v) const {
    return v == kNoVec ? nullptr
                       : base + K * A::kNode + (v == kC ? K * W : 0);
  }
  __device__ float* y(int k) const { return vec(kY) + k * W; }
  __device__ float* c(int k) const { return vec(kC) + k * W; }
  __device__ void put_w(int k, const float (&Wc)[W]) {
    float* stage = buffer(0) + (k & 1) * A::kNode;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      node(k)[A::TWP + i * W + t] = Wc[t];
      stage[i * W + t] = Wc[t];
    }
  }
  __device__ const float* w_back(int k) const {
    return buffer(0) + (k & 1) * A::kNode;
  }
  // the copy number of the sweep's chunk q
  __device__ int copy(int q) const { return j0 + (dir > 0 ? q : nch - 1 - q); }
  __device__ void fetch(int q) {
    if (!(active && i == 0 && q >= 0 && q < nch)) return;
    const int j = copy(q);
    float* dst = buffer(j);
    const int k = q * kChunk;
    const int n = min(kChunk, K - k);
    const unsigned nb = 4 * n * A::kNode;
    const unsigned va = 16 * ((amis + n * W + 3) / 4);
    const unsigned vb = 16 * ((bmis + n * W + 3) / 4);
    mbar_expect(bar(j), nb + (sa ? va : 0) + (sb ? vb : 0));
    bulk_load(dst, node(k), nb, bar(j));
    if (sa) bulk_load(dst + kChunk * A::kNode, sa + k * W - amis, va, bar(j));
    if (sb)
      bulk_load(dst + kChunk * A::kNode + kVec, sb + k * W - bmis, vb,
                bar(j));
  }
  __device__ void begin(int dir_, int a, int b) {
    sa = vec(a);
    sb = vec(b);
    dir = dir_;
    j0 += nch;
    // floats by which a's and b's runs start past a 16-byte boundary
    // (kChunk is a multiple of 4, so every chunk's run starts as the
    // array does)
    amis = (int)((reinterpret_cast<uintptr_t>(sa) & 15) / 4);
    bmis = (int)((reinterpret_cast<uintptr_t>(sb) & 15) / 4);
    // the last sweep's stores, to device memory and to the buffers,
    // before the copies of this one read or overwrite them
    __threadfence_block();
    asm volatile("fence.proxy.async;\n" ::: "memory");
    __syncwarp();
    fetch(dir > 0 ? 0 : nch - 1);
  }
  __device__ void enter(int q) {
    const int j = copy(q);
    if (active) mbar_wait(bar(j), (j >> 1) & 1);
    __syncwarp();
    bufo = ring + 4 + (j & 1) * kBuf;
    k0 = q * kChunk;
    fetch(q + dir);
  }
  __device__ const float* fac(int k) const {
    return dyn_smem() + bufo + (k - k0) * A::kNode;
  }
  __device__ const float* sub(int k) const { return fac(k) + A::TWP; }
  __device__ float a(int k) const {
    return dyn_smem()[bufo + kChunk * A::kNode + amis + (k - k0) * W + i];
  }
  __device__ float b(int k) const {
    return dyn_smem()[bufo + kChunk * A::kNode + kVec + bmis + (k - k0) * W +
                      i];
  }
};

// The nodes of a sweep over all K nodes, in the direction Dir (+1 from
// node 0, -1 from node K-1): body(k) for each node in order. A lane that
// reads in chunks (kChunk > 0) makes chunk q readable before its nodes.
// The shared-memory lane's is one plain loop: the chunk loop around it
// made that kernel 3-15% slower at the paths' shapes, and 44-66% at w = 3
// (timed on an H100 with etol_tpu_torch/kernel_ab.py).
template <int Dir, class Lane, class Body>
__device__ __forceinline__ void sweep(Lane& ln, int K, int a, int b,
                                      Body&& body) {
  constexpr int C = Lane::kChunk;
  ln.begin(Dir, a, b);
  if constexpr (C == 0) {
    if (Dir > 0) {
      for (int k = 0; k < K; ++k) body(k);
    } else {
      for (int k = K - 1; k >= 0; --k) body(k);
    }
  } else {
    const int nch = (K + C - 1) / C;
    for (int c = 0; c < nch; ++c) {
      const int q = Dir > 0 ? c : nch - 1 - c;
      ln.enter(q);
      const int lo = q * C;
      const int hi = min(lo + C, K);
      if (Dir > 0) {
        for (int k = lo; k < hi; ++k) body(k);
      } else {
        for (int k = hi - 1; k >= lo; --k) body(k);
      }
    }
  }
}

// Backward sweep of the first solve, L^T x = y, with the refinement's
// right-hand side
//   c_k = r_k - D_k x_k - O_k x_{k+1} - O_{k-1}^T x_{k-1}
// computed on the way: its loads run one node ahead and its arithmetic
// fills the gaps of the sweep's dependent chain. x_k overwrites y_k in
// place. c_k lacks its last term until x_{k-1} is known, so it waits in
// `pend` for one trip.
template <int W, class Lane>
__device__ __forceinline__ void backward_first(
    Lane& ln, const float* __restrict__ Db, const float* __restrict__ Ob,
    const float* __restrict__ rb, int K, int i, int base, bool active) {
  constexpr int TW = W * (W + 1) / 2;
  float L[TW], inv[W], rhs[W], xk[W], xn[W];
#pragma unroll
  for (int t = 0; t < W; ++t) xn[t] = 0.f;
  float pend = 0.f;
  ResIn<W> in, next;
  load_res<W>(next, Db, Ob, rb, K - 1, K, i);
  sweep<-1>(ln, K, kY, kNoVec, [&](int k) {
    in = next;
    load_res<W>(next, Db, Ob, rb, k - 1, K, i);
    float s = ln.a(k);
    if (k < K - 1) {
      // x_k = L_k^{-T} (y_k - Lsub_k^T x_{k+1}): column i of Lsub_k
      const float* ls = ln.sub(k);
#pragma unroll
      for (int j = 0; j < W; ++j) s -= ls[j * W + i] * xn[j];
    }
    gather<W>(s, base, rhs);
    load_factor<W>(ln.fac(k), L, inv);
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
      if (active) ln.c(k + 1)[i] = done;
    }
    pend = c;
    if (active) ln.y(k)[i] = pick<W>(xk, i);
#pragma unroll
    for (int t = 0; t < W; ++t) xn[t] = xk[t];
  });
  if (active) ln.c(0)[i] = pend;
}

// Forward sweep of the refinement, L y' = c, in place in c's slots
// (thread i reads the c_k[i] it wrote itself in backward_first). Row i of
// Lsub_k is read at node k, for node k+1.
template <int W, class Lane>
__device__ __forceinline__ void forward_refine(Lane& ln, int K, int i,
                                               int base, bool active) {
  constexpr int TW = W * (W + 1) / 2;
  float L[TW], inv[W], rhs[W], yk[W], lrow[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    yk[t] = 0.f;
    lrow[t] = 0.f;
  }
  sweep<1>(ln, K, kC, kNoVec, [&](int k) {
    // c_k - Lsub_{k-1} y'_{k-1}
    float s = ln.a(k);
#pragma unroll
    for (int t = 0; t < W; ++t) s -= lrow[t] * yk[t];
    gather<W>(s, base, rhs);
    load_factor<W>(ln.fac(k), L, inv);
    if (k < K - 1) {
      const float* ls = ln.sub(k) + i * W;
#pragma unroll
      for (int t = 0; t < W; ++t) lrow[t] = ls[t];
    }
    fwd_inv<W>(L, inv, rhs, yk);
    if (active) ln.c(k)[i] = pick<W>(yk, i);
  });
}

// Backward sweep of the refinement: c's slots hold the correction's
// forward result, y's the first solve's x, and x + correction goes out to
// xg.
template <int W, class Lane>
__device__ __forceinline__ void backward_last(Lane& ln,
                                              float* __restrict__ xg, int K,
                                              int i, int base, bool active) {
  constexpr int TW = W * (W + 1) / 2;
  float L[TW], inv[W], rhs[W], xk[W], xn[W];
#pragma unroll
  for (int t = 0; t < W; ++t) xn[t] = 0.f;
  sweep<-1>(ln, K, kC, kY, [&](int k) {
    float s = ln.a(k);
    if (k < K - 1) {
      const float* ls = ln.sub(k);
#pragma unroll
      for (int j = 0; j < W; ++j) s -= ls[j * W + i] * xn[j];
    }
    gather<W>(s, base, rhs);
    load_factor<W>(ln.fac(k), L, inv);
    bwd_inv<W>(L, inv, rhs, xk);
    if (active) xg[k * W + i] = ln.b(k) + pick<W>(xk, i);
#pragma unroll
    for (int t = 0; t < W; ++t) xn[t] = xk[t];
  });
}

// One lane's solve by its group of W threads: the factor with the first
// forward substitution fused in, then the three sweeps.
template <int W, class Lane>
__device__ __forceinline__ void lane_solve(
    Lane& ln, const float* __restrict__ Db, const float* __restrict__ Ob,
    const float* __restrict__ rb, float* __restrict__ xg, int K, int i,
    int base, bool active) {
  constexpr int W2 = W * W;
  constexpr int W2P = pad4(W2);
  constexpr int TW = W * (W + 1) / 2;
  constexpr int TWP = pad4(TW);

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
        if (e % W == i) ln.node(k)[e] = L[e];
#pragma unroll
      for (int t = 0; t < W; ++t)
        if (t == i) ln.y(k)[t] = yprev[t];
    }

    // column i of W_k = L_k^{-1} O_k, which is row i of Lsub_k
    if (k < K - 1) {
      fwd_inv<W>(L, inv, in.o, Wc);
      if (active) ln.put_w(k, Wc);
      // all of W_k back to every thread, four floats a load
      __syncwarp();
      load_vec<W2P, W2>(ln.w_back(k), Wf);
    }
  }
  __syncwarp();

  // ---- first solve: backward sweep, x into y's slots, c on the way ---
  backward_first<W>(ln, Db, Ob, rb, K, i, base, active);
  // ---- refinement: forward sweep L y' = c, in place -------------------
  forward_refine<W>(ln, K, i, base, active);
  // ---- and backward sweep; x + correction goes out --------------------
  backward_last<W>(ln, xg, K, i, base, active);
}

// The group of thread `tid` (threads past the block's last group, and
// groups past the batch, walk along, since the shuffles name the full
// warp, and store nothing; they read a lane whose memory exists).
struct Group {
  int g, base, i;
  bool active;
  int gl;         // a lane of the block whose memory exists
  long long bl;   // a lane of the batch whose inputs exist
  __device__ Group(int tid, int W, int lpb, int B) {
    g = tid / W;
    base = g * W;
    i = tid - base;
    const long long b = (long long)blockIdx.x * lpb + g;
    active = g < lpb && b < B;
    gl = g < lpb ? g : 0;
    bl = active ? b : 0;
  }
};

template <int W>
__global__ void __launch_bounds__(kWarp)
    bt_smem_kernel(const float* __restrict__ D, const float* __restrict__ O,
                   const float* __restrict__ r, float* __restrict__ x, int K,
                   int B, int lpb, int lane_stride) {
  constexpr int W2 = W * W;
  const Group gr(threadIdx.x, W, lpb, B);
  SmemLane<W> ln(gr.gl * lane_stride, K, gr.i);
  lane_solve<W>(ln, D + gr.bl * K * W2, O + gr.bl * (K - 1) * W2,
                r + gr.bl * K * W, x + gr.bl * K * W, K, gr.i, gr.base,
                gr.active);
}

template <int W>
__global__ void __launch_bounds__(kWarp)
    bt_stream_kernel(const float* __restrict__ D,
                     const float* __restrict__ O,
                     const float* __restrict__ r, float* __restrict__ x,
                     float* __restrict__ scratch, int K, int B,
                     long long lane_stride) {
  constexpr int W2 = W * W;
  const Group gr(threadIdx.x, W, kWarp / W, B);
  StreamLane<W> ln(scratch + gr.bl * lane_stride, K,
                   gr.gl * StreamLane<W>::kRing, gr.i, gr.active);
  lane_solve<W>(ln, D + gr.bl * K * W2, O + gr.bl * (K - 1) * W2,
                r + gr.bl * K * W, x + gr.bl * K * W, K, gr.i, gr.base,
                gr.active);
}

// Dynamic shared memory above 48 KB for `kernel`; `granted` is the
// launcher's own record of the bytes granted on each device, so that a
// launch asks again only for more (and a launch recorded into a CUDA
// graph, after one made outside it, only launches).
template <class Kernel>
cudaError_t grant_smem(Kernel kernel, int smem_bytes,
                       int (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem_bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = smem_bytes;
  return err;
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
  static int granted[kMaxDevices] = {};
  cudaError_t err = grant_smem(bt_smem_kernel<W>, smem_bytes, granted);
  if (err != cudaSuccess) return err;
  const int blocks = (B + lpb - 1) / lpb;
  bt_smem_kernel<W><<<blocks, kWarp, smem_bytes, stream>>>(D, O, r, x, K, B,
                                                           lpb, lane_stride);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_stream(const float* D, const float* O, const float* r,
                          float* x, float* scratch, int K, int B,
                          long long lane_stride, int smem_bytes,
                          cudaStream_t stream) {
  using SL = StreamLane<W>;
  constexpr int per_node = SL::kNode + 2 * W;
  constexpr int lpb = kWarp / W;
  if (lane_stride < (long long)K * per_node || lane_stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      smem_bytes != (int)sizeof(float) * lpb * SL::kRing)
    return cudaErrorInvalidValue;
  static int granted[kMaxDevices] = {};
  cudaError_t err = grant_smem(bt_stream_kernel<W>, smem_bytes, granted);
  if (err != cudaSuccess) return err;
  const int blocks = (B + lpb - 1) / lpb;
  bt_stream_kernel<W><<<blocks, kWarp, smem_bytes, stream>>>(
      D, O, r, x, scratch, K, B, lane_stride);
  return cudaGetLastError();
}

}  // namespace

#define ETOL_BT_WIDTHS(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)

extern "C" int etol_bt_solve_smem_f32(const float* D, const float* O,
                                      const float* r, float* x, int K, int W,
                                      int B, int lpb, int lane_stride,
                                      int smem_bytes, void* stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ETOL_BT_CASE(w)                                                   \
  case w:                                                                 \
    return (int)launch_smem<w>(D, O, r, x, K, B, lpb, lane_stride,        \
                               smem_bytes, s);
  switch (W) {
    ETOL_BT_WIDTHS(ETOL_BT_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ETOL_BT_CASE
}

extern "C" int etol_bt_solve_stream_f32(const float* D, const float* O,
                                        const float* r, float* x,
                                        float* scratch, int K, int W, int B,
                                        long long lane_stride, int smem_bytes,
                                        void* stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ETOL_BT_CASE(w)                                                   \
  case w:                                                                 \
    return (int)launch_stream<w>(D, O, r, x, scratch, K, B, lane_stride,  \
                                 smem_bytes, s);
  switch (W) {
    ETOL_BT_WIDTHS(ETOL_BT_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ETOL_BT_CASE
}
