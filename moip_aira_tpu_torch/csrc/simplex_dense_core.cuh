// K5's loop, shared by K5 (simplex_dense.cu: one launch runs a batch of
// lanes, each through this loop once) and K6 (lex_bnb.cu: each lane of a
// lex batch runs this loop at every node of its branch and bound): the
// dense bounded-variable simplex of
// moip_aira_tpu_torch/solver/simplex_dense.py (DenseLPSolver: start, steps
// and finish) for one lane, on a warp, a block or the blocks of a
// thread-block cluster, in float32 or float64.  simplex_dense.cu says what
// it computes, in which order and how each shape runs it.

#pragma once

#include <cooperative_groups.h>

#include <cstddef>

#include "simplex_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int XLA_WINDOW = 32;
constexpr int K5_MAX_THREADS = 256;  // a block of any shape
constexpr int K5_MAX_WARPS = K5_MAX_THREADS / 32;
constexpr int K5_MAX_CLUSTER = 8;    // the portable cluster size
constexpr int K5_PACK_ROWS = 32;     // packed: a row for each warp lane
constexpr int K5_PACK_COLS = 128;    // packed: four columns for each
constexpr int K5_MAX_PACK = 8;       // packed: lanes (warps) a block
// the longest row sum that windows and one chain take
constexpr int K5_MAX_ROWS = XLA_WINDOW * XLA_WINDOW;
// the longest column sum that windows of windows and one chain take
constexpr int K5_MAX_TERMS = XLA_WINDOW * XLA_WINDOW * XLA_WINDOW;

constexpr int SHAPE_PACKED = 0;
constexpr int SHAPE_BLOCK = 1;
constexpr int SHAPE_CLUSTER = 2;
constexpr int SHAPE_GLOBAL = 3;  // a cluster, the tableau in global memory
constexpr int K5_N_SHAPES = 4;

// a published winner's values, and the step's scalars for every thread
constexpr int MAIL_T = 7;  // v, d, c, lo, hi, span, z of the column
constexpr int MAIL_I = 3;  // column, any eligible, at upper
constexpr int HEAD_I = 8;  // p1n, bland, pend, pend_r, run

// the parts of a lane's run that a -DK5_CLOCKS build counts: the start;
// then per step the row terms and row sums of the next step, its phase
// test, pricing (with the last pivot's rank-1 update and the arg-max), the
// objective's nonbasic windows, the ratio test, the row pick, the outcome,
// the basic values' step, the rank-1 update (fused into pricing here, so
// 0), and the time spent in barriers and the cluster's exchange
constexpr int K5_N_PARTS = 11;
enum K5Part {
  P_START, P_ROW_SUMS, P_PHASE, P_PRICING, P_CZV, P_RATIO, P_ROW_PICK,
  P_OUTCOME, P_XB_STEP, P_RANK1, P_BARRIERS
};
#ifdef K5_CLOCKS
__device__ unsigned long long* k5_clocks;
#define K5_CLOCK_DECL \
  unsigned long long clk_[K5_N_PARTS] = {}; long long clk_t_ = clock64();
#define K5_TICK(part)                                  \
  do {                                                 \
    const long long t_ = clock64();                    \
    clk_[part] += (unsigned long long)(t_ - clk_t_);   \
    clk_t_ = t_;                                       \
  } while (0)
#define K5_CLOCK_STORE(on, lane)                                     \
  do {                                                               \
    if ((on) && k5_clocks != nullptr)                                \
      for (int p_ = 0; p_ < K5_N_PARTS; ++p_)                        \
        k5_clocks[(size_t)(lane) * K5_N_PARTS + p_] = clk_[p_];      \
  } while (0)
#else
#define K5_CLOCK_DECL
#define K5_TICK(part) \
  do {                \
  } while (0)
#define K5_CLOCK_STORE(on, lane) \
  do {                           \
  } while (0)
#endif

template <class T>
struct Op;

template <>
struct Op<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
};

template <>
struct Op<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
};

// ---- the windowed order of a sum ---------------------------------------------

__host__ __device__ inline int windows(int L) {
  return (L + XLA_WINDOW - 1) / XLA_WINDOW;
}

__host__ __device__ inline int pad_low(int L) {
  return (windows(L) * XLA_WINDOW - L) / 2;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The first level of xla_sum over L terms: one item, the whole chain, when
// L <= 32, else a window each.
__host__ __device__ inline int items(int L) {
  return L <= XLA_WINDOW ? 1 : windows(L);
}

// The sums read arrays (shared memory) term by term in the plain version's
// order, the terms four or eight at a time ahead of their adds, so a chain
// waits on its adds and not on each term's load.  They take a pointer, not
// a term's expression, so that one copy of each serves every caller and the
// step's code stays small.

// x[0] + x[1] + ... + x[L - 1], term by term from x[0] (L >= 1)
template <class T>
__device__ T chain_arr(const T* x, int L) {
  T acc = x[0];
  int i = 1;
#pragma unroll 2
  for (; i + 4 <= L; i += 4) {
    const T v0 = x[i], v1 = x[i + 1], v2 = x[i + 2], v3 = x[i + 3];
    acc = Op<T>::add(acc, v0);
    acc = Op<T>::add(acc, v1);
    acc = Op<T>::add(acc, v2);
    acc = Op<T>::add(acc, v3);
  }
#pragma unroll 1
  for (; i < L; ++i) acc = Op<T>::add(acc, x[i]);
  return acc;
}

// the chain of xla_dot over at most 32 terms: the first product rounded,
// then fused multiply-adds (L >= 1)
template <class T>
__device__ T fma_chain_arr(const T* a, const T* b, int L) {
  T acc = Op<T>::mul(a[0], b[0]);
  int i = 1;
#pragma unroll 2
  for (; i + 4 <= L; i += 4) {
    const T u0 = a[i], u1 = a[i + 1], u2 = a[i + 2], u3 = a[i + 3];
    const T v0 = b[i], v1 = b[i + 1], v2 = b[i + 2], v3 = b[i + 3];
    acc = Op<T>::fma(u0, v0, acc);
    acc = Op<T>::fma(u1, v1, acc);
    acc = Op<T>::fma(u2, v2, acc);
    acc = Op<T>::fma(u3, v3, acc);
  }
#pragma unroll 1
  for (; i < L; ++i) acc = Op<T>::fma(a[i], b[i], acc);
  return acc;
}

// Window w of a windowed sum over L terms padded `lo` zeros low, its terms
// term(i) for the i of [0, L) it covers, summed in order: padded term k is
// term(32 w + k - lo) inside [0, L), +0 outside.  The padding is added as
// it changes the sum: a window that starts in it starts from +0 (so a first
// term of -0 gives +0, as +0 + -0 does), one that ends in it adds +0 once
// (more +0s change nothing).
template <class T, class F>
__device__ __forceinline__ T window_terms(const F& term, int L, int lo, int w) {
  const int i0 = w * XLA_WINDOW - lo;
  const int e = imin(L, i0 + XLA_WINDOW);
  int i = imax(0, i0);
  T acc = T(0);
  if (i0 >= 0) acc = term(i++);
#pragma unroll 2
  for (; i + 4 <= e; i += 4) {
    const T v0 = term(i), v1 = term(i + 1), v2 = term(i + 2), v3 = term(i + 3);
    acc = Op<T>::add(acc, v0);
    acc = Op<T>::add(acc, v1);
    acc = Op<T>::add(acc, v2);
    acc = Op<T>::add(acc, v3);
  }
#pragma unroll 1
  for (; i < e; ++i) acc = Op<T>::add(acc, term(i));
  if (e < i0 + XLA_WINDOW) acc = Op<T>::add(acc, T(0));
  return acc;
}

// window w of the windowed sum over the L-long axis of x, x[0] its index
// `off` (padded `lo` zeros low)
template <class T>
__device__ T window_arr(const T* x, int L, int lo, int w, int off) {
  return window_terms<T>([&](int i) { return x[i - off]; }, L, lo, w);
}

// item w of xla_sum over the L-long axis of x (the whole chain when
// L <= 32)
template <class T>
__device__ T item_arr(const T* x, int L, int w, int off) {
  if (L <= XLA_WINDOW) return chain_arr(x, L);
  return window_arr(x, L, pad_low(L), w, off);
}

// xla_sum over L terms from its items(L) first-level items s[0..]: the
// item itself, a chain of the windows' sums, or (L > 32^2) the windows of
// the windows' sums, then their chain
template <class T>
__device__ T total_arr(const T* s, int L) {
  if (L <= XLA_WINDOW) return s[0];
  const int nw = windows(L);
  if (nw <= XLA_WINDOW) return chain_arr(s, nw);
  const int lo = pad_low(nw);
  T acc = window_arr(s, nw, lo, 0, 0);
#pragma unroll 1
  for (int w = 1; w < windows(nw); ++w)
    acc = Op<T>::add(acc, window_arr(s, nw, lo, w, 0));
  return acc;
}

// Rows [i, i + 4) of a column that lies `pitch` apart, brought up to date
// by the pending rank-1 update (PEND: row pr becomes rj, every other row
// fma(-alpha[i], rj, T[i, j])) and written back, with their pricing costs.
// Every load comes before every store, so the four rows' loads overlap
// (a store may alias a later load, so a load after it waits).
template <class T, bool PEND>
__device__ __forceinline__ void rows4(T* col, int pitch, int i, int pr, T rj,
                                      const T* alpha, const T* cBe, T (&t)[4],
                                      T (&cb)[4]) {
  T a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t[k] = col[(size_t)(i + k) * pitch];
    cb[k] = cBe[i + k];
    if (PEND) a[k] = alpha[i + k];
  }
  if (PEND) {
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = i + k == pr ? rj : Op<T>::fma(-a[k], rj, t[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) col[(size_t)(i + k) * pitch] = t[k];
  }
}

// Column j's pricing sum cBe . T[:, j] over the m rows of a column that
// lies `pitch` apart, after the pending rank-1 update (PEND) of each of its
// rows, each written back once.  m <= 32: the chain of fused multiply-adds;
// longer: the rounded products in windows of 32 (window_terms' order), then
// the chain of the windows' sums.  Four rows at a time (rows4).
template <class T, bool PEND>
__device__ __forceinline__ T col_dot(T* col, int pitch, int m, int pr, T rj,
                                     const T* alpha, const T* cBe) {
  auto row = [&](int i) -> T {
    T t = col[(size_t)i * pitch];
    if (PEND) {
      t = i == pr ? rj : Op<T>::fma(-alpha[i], rj, t);
      col[(size_t)i * pitch] = t;
    }
    return t;
  };
  T t[4], cb[4];
  if (m <= XLA_WINDOW) {
    T acc = Op<T>::mul(cBe[0], row(0));
    int i = 1;
#pragma unroll 1
    for (; i + 4 <= m; i += 4) {
      rows4<T, PEND>(col, pitch, i, pr, rj, alpha, cBe, t, cb);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = Op<T>::fma(cb[k], t[k], acc);
    }
#pragma unroll 1
    for (; i < m; ++i) acc = Op<T>::fma(cBe[i], row(i), acc);
    return acc;
  }
  const int lo = pad_low(m), nw = windows(m);
  T dsum = T(0);
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    // window_terms over the products cBe[i] T[i, j], four rows at a time
    const int i0 = w * XLA_WINDOW - lo;
    const int e = imin(m, i0 + XLA_WINDOW);
    int i = imax(0, i0);
    T acc = T(0);
    if (i0 >= 0) {
      acc = Op<T>::mul(cBe[i], row(i));
      ++i;
    }
#pragma unroll 1
    for (; i + 4 <= e; i += 4) {
      rows4<T, PEND>(col, pitch, i, pr, rj, alpha, cBe, t, cb);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = Op<T>::add(acc, Op<T>::mul(cb[k], t[k]));
    }
#pragma unroll 1
    for (; i < e; ++i) acc = Op<T>::add(acc, Op<T>::mul(cBe[i], row(i)));
    if (e < i0 + XLA_WINDOW) acc = Op<T>::add(acc, T(0));
    dsum = w == 0 ? acc : Op<T>::add(dsum, acc);
  }
  return dsum;
}

// (a, ia) beats (b, ib): larger value, lower index among equals
template <class T>
__device__ __forceinline__ bool wins(T a, int ia, T b, int ib) {
  return a > b || (a == b && ia < ib);
}

// a column candidate: its score, reduced cost and index, and whether any
// column seen is eligible
template <class T>
struct Cand {
  T v, d;
  int j, any;
};

template <class T>
__device__ __forceinline__ void take(Cand<T>& a, T v, int j, T d, int any) {
  if (wins(v, j, a.v, a.j)) {
    a.v = v;
    a.j = j;
    a.d = d;
  }
  a.any |= any;
}

// the warp's best candidate in every lane (a butterfly: `wins` is a total
// order, so every lane finds the same one)
template <class T>
__device__ __forceinline__ void warp_best(Cand<T>& a) {
  for (int off = 16; off > 0; off >>= 1) {
    const T v = __shfl_xor_sync(FULL, a.v, off);
    const T d = __shfl_xor_sync(FULL, a.d, off);
    const int j = __shfl_xor_sync(FULL, a.j, off);
    const int any = __shfl_xor_sync(FULL, a.any, off);
    take(a, v, j, d, any);
  }
}

template <class T>
__device__ __forceinline__ void warp_argmax_all(T& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (wins(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// ---- the plan's geometry -------------------------------------------------------

__host__ __device__ inline size_t seg(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// A lane's columns split over C blocks by whole windows of the padded
// nc-long sums: wpb windows a block, block r the columns [j0, j1) of the
// windows [w0, w1); the tableau's row pitch (nc on one block).
struct Slice {
  int pitch, wpb, w0, w1, j0, j1;
};

__host__ __device__ inline Slice slice_of(int nc, int C, int r) {
  Slice s{};
  const int nw = items(nc);
  s.wpb = (nw + C - 1) / C;
  s.w0 = imin(nw, r * s.wpb);
  s.w1 = imin(nw, s.w0 + s.wpb);
  if (nc <= XLA_WINDOW) {
    s.j0 = r == 0 ? 0 : nc;
    s.j1 = nc;
  } else {
    const int lo = pad_low(nc);
    s.j0 = imax(0, imin(nc, s.w0 * XLA_WINDOW - lo));
    s.j1 = imax(0, imin(nc, s.w1 * XLA_WINDOW - lo));
  }
  s.pitch = (C == 1 || nc <= XLA_WINDOW) ? nc : s.wpb * XLA_WINDOW;
  return s;
}

// Where each array of a lane lives in its shared memory (a block's, or a
// warp's part of it in the packed shape), as byte offsets, each 16-byte
// aligned.  The wrapper's dense_loop_smem_bytes counts the same.
struct Layout {
  size_t tab, c, lo, hi, zlo, zup, span, z, cz, fre, inb, atu;
  size_t xB, bl, bh, cBb, cB1, alpha, ratio, t1, t2, prod, basis, below, above;
  size_t rsum, czall, ccol, slot_t, slot_i, mail_t, mail_i, head_i, head_t;
  size_t total;
};

__host__ __device__ inline Layout k5_layout(int shape, int m, int nc, int C,
                                            int dsize) {
  Layout L{};
  size_t off = 0;
  auto take_b = [&](size_t bytes) {
    const size_t at = off;
    off += seg(bytes);
    return at;
  };
  const int pitch = slice_of(nc, C, 0).pitch;
  const size_t col = (size_t)pitch * dsize, row = (size_t)m * dsize;
  const int warps = shape == SHAPE_PACKED ? 0 : K5_MAX_WARPS;
  const bool cl = shape == SHAPE_CLUSTER || shape == SHAPE_GLOBAL;
  const int mail = cl ? 2 * C : 0;
  L.tab = take_b(shape == SHAPE_GLOBAL ? 0 : (size_t)m * col);
  L.c = take_b(col);
  L.lo = take_b(col);
  L.hi = take_b(col);
  L.zlo = take_b(col);
  L.zup = take_b(col);
  L.span = take_b(col);
  L.z = take_b(col);
  L.cz = take_b(col);
  L.fre = take_b(pitch);
  L.inb = take_b(pitch);
  L.atu = take_b(pitch);
  L.xB = take_b(row);
  L.bl = take_b(row);
  L.bh = take_b(row);
  L.cBb = take_b(row);
  L.cB1 = take_b(row);
  L.alpha = take_b(row);
  L.ratio = take_b(row);
  L.t1 = take_b(row);
  L.t2 = take_b(row);
  L.prod = take_b(row);
  L.basis = take_b((size_t)m * sizeof(int));
  L.below = take_b(m);
  L.above = take_b(m);
  L.rsum = take_b((size_t)3 * items(m) * dsize);
  L.czall = take_b((size_t)2 * items(nc) * dsize);
  L.ccol = take_b(cl ? (size_t)2 * C * m * dsize : 0);
  L.slot_t = take_b((size_t)2 * warps * dsize);
  L.slot_i = take_b((size_t)2 * warps * sizeof(int));
  L.mail_t = take_b((size_t)mail * MAIL_T * dsize);
  L.mail_i = take_b((size_t)mail * MAIL_I * sizeof(int));
  L.head_i = take_b(HEAD_I * sizeof(int));
  L.head_t = take_b(2 * (size_t)dsize);
  L.total = off;
  return L;
}

// a block's dynamic shared bytes under a plan: P lanes' parts in the packed
// shape, else one lane's (its slice on a cluster)
__host__ __device__ inline size_t k5_smem_bytes(int shape, int m, int nc, int C,
                                                int P, int dsize) {
  const size_t lane = k5_layout(shape, m, nc, C, dsize).total;
  return shape == SHAPE_PACKED ? (size_t)P * lane : lane;
}

// ---- the plan's launch ---------------------------------------------------------

// 0 if a launch of the plan (shape, C blocks a lane, `threads` a block, P
// lanes a block in the packed shape) can run `batch` lanes of m rows and
// n + m columns, else cudaErrorInvalidValue.
inline int check_plan(int shape, int m, int n, int batch, int C, int threads,
                      int P) {
  const int nc = n + m;
  if (m <= 0 || n < 0 || batch <= 0 || nc > K5_MAX_TERMS || m > K5_MAX_ROWS ||
      shape < 0 || shape >= K5_N_SHAPES)
    return (int)cudaErrorInvalidValue;
  if (shape == SHAPE_PACKED) {
    if (m > K5_PACK_ROWS || nc > K5_PACK_COLS || P < 1 || P > K5_MAX_PACK ||
        threads != 32 * P || C != 1)
      return (int)cudaErrorInvalidValue;
  } else {
    const Slice last = slice_of(nc, C, C - 1);
    if (threads < 32 || threads > K5_MAX_THREADS || threads % 32 != 0 ||
        (shape == SHAPE_BLOCK && C != 1) ||
        (shape != SHAPE_BLOCK && (C < 2 || C > K5_MAX_CLUSTER ||
                                  nc <= XLA_WINDOW || last.j1 <= last.j0)))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The launch configuration of the plan for `batch` lanes with `bytes`
// dynamic shared bytes a block: a block per P lanes (packed), else C blocks
// a lane, in clusters of C.
inline void plan_config(int shape, int batch, int C, int threads, int P,
                        size_t bytes, cudaStream_t stream,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  const int blocks = shape == SHAPE_PACKED ? (batch + P - 1) / P : batch * C;
  cfg->gridDim = dim3((unsigned)blocks, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The launch configuration of `kern`, a kernel's instantiation for `shape`,
// for a checked plan (check_plan) with `bytes` dynamic shared bytes a
// block: 0, or the CUDA error the launch would meet.  The kernel's
// shared-memory limit is raised to the card's opt-in once per device, on
// its first use there (`raised`, per device and shape, is the kernel's).
template <class Kernel>
int shape_config(Kernel kern, bool (*raised)[K5_N_SHAPES], int shape,
                 int batch, int C, int threads, int P, size_t bytes,
                 cudaStream_t stream, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr) {
  const int cap = dynamic_smem_cap();
  if (cap <= 0 || bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  const int slot = device_slot();
  if (slot < 0 || !raised[slot][shape]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (e != cudaSuccess) return (int)e;
    if (slot >= 0) raised[slot][shape] = true;
  }
  plan_config(shape, batch, C, threads, P, bytes, stream, cfg, attr);
  return 0;
}

// How many clusters of the configured launch of `kern` the card holds at
// once (cudaOccupancyMaxActiveClusters; blocks for clusters of 1), or
// minus the CUDA error.
template <class Kernel>
int active_clusters(Kernel kern, const cudaLaunchConfig_t* cfg) {
  int count = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&count, (const void*)kern, cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// ---- the loop ------------------------------------------------------------------

template <int SHAPE>
__device__ __forceinline__ void lane_sync() {
  if constexpr (SHAPE == SHAPE_PACKED)
    __syncwarp();
  else
    __syncthreads();
}

template <int SHAPE>
__device__ __forceinline__ int lane_sync_or(int v) {
  if constexpr (SHAPE == SHAPE_PACKED)
    return __any_sync(FULL, v);
  else
    return __syncthreads_or(v);
}

// What one lane's run of the loop gives back in every thread of its warp,
// block or cluster: its status (RUNNING turned ITER_LIMIT), the objective
// c . z and the steps it took.
template <class T>
struct LaneResult {
  int status;
  T obj;
  int iters;
};

// One lane's whole loop, start, steps and finish, on the calling warp
// (packed), block (block) or the `csize` blocks of its cluster (cluster,
// global), block rank r owning the columns of slice_of(nc, csize, r).  `base`
// is the lane's part of the shared memory (k5_layout's arrays; a warp's part
// in the packed shape); in the global shape `tab` is the block's tableau
// slice (m x pitch) in global memory, else null.  c, lo and hi are the
// lane's nc-long rows, read at the start only (global or shared memory,
// written before the call); an inactive lane (!act) takes no step and
// reports INFEASIBLE.  The finish writes the lane's structural x and
// at-upper flags, each block its slice, and its basis (rank 0), as row `row`
// of x_o (rows of n), atu_o (nc) and basis_o (m) where the pointers are not
// null, and returns the LaneResult to every thread; every block computes the
// objective, so each has the same result.  (The outputs are addressed at the
// finish from `row`, so that no pointer of them stays live through the
// steps.)  `row` is also the lane's row of k5_clocks in a -DK5_CLOCKS build.
template <class T, int SHAPE>
__device__ __forceinline__ LaneResult<T> dense_lane(
    unsigned char* base, const T* __restrict__ W, int m, int n, int csize,
    const T* cb, const T* lob, const T* hib, bool act, int max_iters, T ft,
    T ct, T pt, T prog, int stall_limit, T* tab_g, T* x_o, long long* basis_o,
    unsigned char* atu_o, int row) {
  constexpr bool PK = SHAPE == SHAPE_PACKED;
  constexpr bool CL = SHAPE == SHAPE_CLUSTER || SHAPE == SHAPE_GLOBAL;
  const int nc = n + m;
  const int C = CL ? csize : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int rank = 0;
  if constexpr (CL) rank = (int)cg::this_cluster().block_rank();
  const int tid = PK ? lane : threadIdx.x;
  const int nt = PK ? 32 : blockDim.x;
  const bool w0 = PK || warp == 0;  // the warp that runs the rows
  const T INF = T(INFINITY);
  const Slice sl = slice_of(nc, C, rank);
  const int pitch = sl.pitch, j0 = sl.j0, wr = sl.j1 - sl.j0;
  const int nwl = sl.w1 - sl.w0;  // windows of the column sums here
  const int nim = items(m), ninc = items(nc);
  const Layout L = k5_layout(SHAPE, m, nc, C, (int)sizeof(T));
  auto at = [&](size_t off) { return reinterpret_cast<T*>(base + off); };
  T* tab = SHAPE == SHAPE_GLOBAL ? tab_g : at(L.tab);
  T* c = at(L.c);
  T* lo = at(L.lo);
  T* hi = at(L.hi);
  T* zlo = at(L.zlo);
  T* zup = at(L.zup);
  T* span = at(L.span);
  T* z = at(L.z);
  T* cz = at(L.cz);  // c[j] zv(j), the nonbasic objective's terms
  unsigned char* fre = base + L.fre;
  unsigned char* inb = base + L.inb;
  unsigned char* atu = base + L.atu;
  T* xB = at(L.xB);
  T* bl = at(L.bl);
  T* bh = at(L.bh);
  T* cBb = at(L.cBb);  // each row's cost c[basis]
  T* cB1 = at(L.cB1);  // each row's phase-1 cost
  T* alpha = at(L.alpha);
  T* ratio = at(L.ratio);
  T* t1 = at(L.t1);
  T* t2 = at(L.t2);
  T* prod = at(L.prod);
  int* basis = reinterpret_cast<int*>(base + L.basis);
  unsigned char* below = base + L.below;
  unsigned char* above = base + L.above;
  T* rsum = at(L.rsum);      // [3][nim]: the row sums' items
  T* czall = at(L.czall);    // [2][ninc]: the nonbasic objective's items
  T* ccol = at(L.ccol);      // [2][C][m]: the published columns
  T* slot_t = at(L.slot_t);  // [warps][2]: each warp's winner: v, d
  int* slot_i = reinterpret_cast<int*>(base + L.slot_i);  // j, any
  T* mail_t = at(L.mail_t);  // [2][C][MAIL_T]
  int* mail_i = reinterpret_cast<int*>(base + L.mail_i);  // [2][C][MAIL_I]
  int* head_i = reinterpret_cast<int*>(base + L.head_i);
  T* head_t = at(L.head_t);
  const bool clocked = rank == 0 && tid == 0;
  (void)clocked;
  K5_CLOCK_DECL

  // a nonbasic column's value (0 for a basic one) under the current flags;
  // jj is the column's place in this block's slice
  auto zv = [&](int jj) -> T {
    return inb[jj] ? T(0) : (atu[jj] ? zup[jj] : zlo[jj]);
  };

  // ---- start: the lane's constants and the logical basis -----------------
  int empty = 0;
  for (int j = tid; j < nc; j += nt)
    empty |= lob[j] > Op<T>::add(hib[j], ft);  // an empty box is INFEASIBLE
  for (int jj = tid; jj < wr; jj += nt) {
    const int j = j0 + jj;
    const T l = lob[j], h = hib[j];
    const bool fl = isfinite(l), fh = isfinite(h);
    c[jj] = cb[j];
    lo[jj] = l;
    hi[jj] = h;
    fre[jj] = !fl && !fh;
    const T zl = fl ? l : (fh ? h : T(0));
    zlo[jj] = zl;
    zup[jj] = fh ? h : zl;
    span[jj] = (fl && fh) ? Op<T>::sub(h, l) : INF;
    const bool up = j < n && !fl && fh;
    inb[jj] = j >= n;
    atu[jj] = up;
    cz[jj] = Op<T>::mul(c[jj], j >= n ? T(0) : (up ? zup[jj] : zl));
  }
  // xB = -T0 z0 with T0 = -W, every block of a cluster on all columns from
  // global memory: first the items (row i, window w) into the tableau's
  // space, then each row's total
  {
    auto z0 = [&](int j) -> T {
      if (j >= n) return T(0);
      const T l = lob[j], h = hib[j];
      return isfinite(l) ? l : (isfinite(h) ? h : T(0));
    };
    T* part = tab;
    const int lo_nc = pad_low(nc);
#pragma unroll 1
    for (int e = tid; e < m * ninc; e += nt) {
      const int i = e / ninc, w = e - i * ninc;
      const T* Wi = W + (size_t)i * nc;
      // global loads, four terms ahead of the chain
      T acc;
      if (nc <= XLA_WINDOW) {
        acc = Op<T>::mul(-Wi[0], z0(0));
        int j = 1;
#pragma unroll 1
        for (; j + 4 <= nc; j += 4) {
          T a[4], zj[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            a[k] = -Wi[j + k];
            zj[k] = z0(j + k);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) acc = Op<T>::fma(a[k], zj[k], acc);
        }
#pragma unroll 1
        for (; j < nc; ++j) acc = Op<T>::fma(-Wi[j], z0(j), acc);
      } else {
        acc = window_terms<T>([&](int j) { return Op<T>::mul(-Wi[j], z0(j)); }, nc,
                              lo_nc, w);
      }
      part[e] = acc;
    }
    empty = lane_sync_or<SHAPE>(empty);
    for (int i = tid; i < m; i += nt) {
      xB[i] = -total_arr(part + (size_t)i * ninc, nc);
      basis[i] = n + i;
      bl[i] = lob[n + i];
      bh[i] = hib[n + i];
      cBb[i] = cb[n + i];
    }
    lane_sync<SHAPE>();
  }
  for (int i = 0; i < m; ++i)
    for (int jj = tid; jj < pitch; jj += nt)
      tab[(size_t)i * pitch + jj] = jj < wr ? -W[(size_t)i * nc + j0 + jj] : T(0);

  // Warp 0 keeps the lane's state in registers, alike in its every thread
  // (and in warp 0 of every block of a cluster); the other threads read
  // what they need from head_i / head_t after the step's last barrier.
  int status = (empty || !act) ? INFEASIBLE : RUNNING;
  int it = 0, stall = 0, stall_e = 0;
  bool p1 = true, p1n = true;
  T last = INF, last_e = INF, infeas = T(0), cbx = T(0);

  // The row terms of the step about to start (below/above, the phase-1
  // costs, the infeasibilities and c_B x_B), its three row sums side by side
  // and its phase test; warp 0 only.  m <= 32: a row a thread, the sums as
  // shuffle chains every thread runs alike; longer: a thread an item (a
  // window of one sum), then every thread the totals.
  auto rows_and_sums = [&]() {
    T t1v = T(0), t2v = T(0), cbv = T(0), xv = T(0);
    for (int i = lane; i < m; i += 32) {
      const T x = xB[i], l = bl[i], h = bh[i], cbi = cBb[i];
      const bool bw = x < Op<T>::sub(l, ft), ab = x > Op<T>::add(h, ft);
      below[i] = bw;
      above[i] = ab;
      t1v = bw ? Op<T>::sub(l, x) : T(0);
      t2v = ab ? Op<T>::sub(x, h) : T(0);
      cbv = cbi;
      xv = x;
      cB1[i] = Op<T>::sub(T(ab), T(bw));
      t1[i] = t1v;
      t2[i] = t2v;
      prod[i] = Op<T>::mul(cbi, x);
    }
    T s_lo, s_hi;
    if (m <= XLA_WINDOW) {
      s_lo = __shfl_sync(FULL, t1v, 0);
      s_hi = __shfl_sync(FULL, t2v, 0);
      cbx = Op<T>::mul(__shfl_sync(FULL, cbv, 0), __shfl_sync(FULL, xv, 0));
      int i = 1;
#pragma unroll 1
      for (; i + 4 <= m; i += 4) {  // four rows' shuffles ahead of their sums
        T a[4], bb[4], u[4], v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[k] = __shfl_sync(FULL, t1v, i + k);
          bb[k] = __shfl_sync(FULL, t2v, i + k);
          u[k] = __shfl_sync(FULL, cbv, i + k);
          v[k] = __shfl_sync(FULL, xv, i + k);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_lo = Op<T>::add(s_lo, a[k]);
          s_hi = Op<T>::add(s_hi, bb[k]);
          cbx = Op<T>::fma(u[k], v[k], cbx);
        }
      }
#pragma unroll 1
      for (; i < m; ++i) {
        const T a = __shfl_sync(FULL, t1v, i), bb = __shfl_sync(FULL, t2v, i);
        const T u = __shfl_sync(FULL, cbv, i), v = __shfl_sync(FULL, xv, i);
        s_lo = Op<T>::add(s_lo, a);
        s_hi = Op<T>::add(s_hi, bb);
        cbx = Op<T>::fma(u, v, cbx);
      }
    } else {
      __syncwarp();
      for (int e = lane; e < 3 * nim; e += 32) {
        const int sidx = e / nim, w = e - sidx * nim;
        rsum[e] = item_arr(sidx == 0 ? t1 : (sidx == 1 ? t2 : prod), m, w, 0);
      }
      __syncwarp();
      s_lo = total_arr(rsum, m);
      s_hi = total_arr(rsum + nim, m);
      cbx = total_arr(rsum + 2 * nim, m);
    }
    K5_TICK(P_ROW_SUMS);
    infeas = Op<T>::add(s_lo, s_hi);
    p1n = p1 && infeas > ft;  // phase 1 ends once feasible
    const bool entered = p1 && !p1n;
    stall_e = entered ? 0 : stall;
    last_e = entered ? INF : last;
    __syncwarp();  // the row flags and costs, for every thread of warp 0
    K5_TICK(P_PHASE);
  };
  // what the other threads read after the step's last barrier
  auto publish_head = [&](bool pend, int pend_r, T den) {
    if (lane == 0) {
      head_i[0] = p1n;
      head_i[1] = stall >= stall_limit;  // Bland, by the count the step starts with
      head_i[2] = pend;
      head_i[3] = pend_r;
      head_i[4] = status == RUNNING && it < max_iters;
      head_t[0] = den;
    }
  };
  lane_sync<SHAPE>();  // the tableau and the row state are in place
  K5_TICK(P_START);
  if (w0) {
    rows_and_sums();
    publish_head(false, 0, T(1));
  }
  lane_sync<SHAPE>();
  K5_TICK(P_BARRIERS);

  int par = 0;  // the parity of the step's published buffers
  // ---- the steps ----------------------------------------------------------
  while (head_i[4]) {
    const bool sp1n = head_i[0] != 0, bland = head_i[1] != 0;
    const bool pend = head_i[2] != 0;
    const int pr = head_i[3];
    const T den = head_t[0];
    const T* cBe = sp1n ? cB1 : cBb;

    // pricing: the last pivot's rank-1 update of each column, then its
    // reduced cost, eligibility and score; past the columns, the windows
    // of the objective's nonbasic part (with the step's starting flags)
    Cand<T> best{-INF, T(0), INT_MAX, 0};
    const int nitems = wr + (sp1n ? 0 : nwl);
    for (int item = tid; item < nitems; item += nt) {
      if (item < wr) {
        const int jj = item;
        T* col = tab + jj;
        // the column's own values first: the loads after its stores wait
        const T cj = c[jj];
        const bool nb = !inb[jj], fr = fre[jj], up = atu[jj];
        const T dsum =
            pend ? col_dot<T, true>(col, pitch, m, pr,
                                    Op<T>::div(col[(size_t)pr * pitch], den),
                                    alpha, cBe)
                 : col_dot<T, false>(col, pitch, m, pr, T(0), alpha, cBe);
        const int j = j0 + jj;
        const T d = Op<T>::sub(sp1n ? T(0) : cj, dsum);
        const T ad = fabs(d);
        const bool el = nb && (fr ? ad > ct : (up ? d : -d) > ct);
        const T score = el ? (bland ? -T(j) : ad) : (bland ? T(-BIG) : T(-1));
        take(best, score, j, d, (int)el);
      } else {
        K5_TICK(P_PRICING);
        const int w = sl.w0 + (item - wr);
        const T s = item_arr(cz, nc, w, j0);
        T* dst = czall + (size_t)par * ninc + w;
        if constexpr (CL) {
          for (int rk = 0; rk < C; ++rk)
            *cg::this_cluster().map_shared_rank(dst, (unsigned)rk) = s;
        } else {
          *dst = s;
        }
        K5_TICK(P_CZV);
      }
    }
    K5_TICK(P_PRICING);
    warp_best(best);
    if constexpr (!PK) {
      if (lane == 0) {
        slot_t[2 * warp] = best.v;
        slot_t[2 * warp + 1] = best.d;
        slot_i[2 * warp] = best.j;
        slot_i[2 * warp + 1] = best.any;
      }
    }
    K5_TICK(P_PRICING);
    lane_sync<SHAPE>();
    K5_TICK(P_BARRIERS);
    if constexpr (!PK) {
      best = Cand<T>{slot_t[0], slot_t[1], slot_i[0], slot_i[1]};
      for (int wp = 1; wp < (nt >> 5); ++wp)
        take(best, slot_t[2 * wp], slot_i[2 * wp], slot_t[2 * wp + 1],
             slot_i[2 * wp + 1]);
    }
    // the winner's column and values: local on one block or warp, else
    // published into every block of the cluster beside the windows' sums
    int q = 0, astride = 1, win = 0;
    T dq = T(0), cq = T(0), loq = T(0), hiq = T(0), spanq = T(0), zq = T(0);
    bool anyq = false, atuq = false;
    const T* acol = nullptr;
    if constexpr (CL) {
      cg::cluster_group cluster = cg::this_cluster();
      const int qb = best.j;
      const bool have = qb != INT_MAX;
      const int jq = have ? qb - j0 : 0;
      if (have) {
        for (int e = tid; e < C * m; e += nt) {
          const int rk = e / m, i = e - rk * m;
          T* dst = ccol + ((size_t)par * C + rank) * m + i;
          *cluster.map_shared_rank(dst, (unsigned)rk) = tab[(size_t)i * pitch + jq];
        }
      }
      if (tid < C) {
        T* mt = cluster.map_shared_rank(
            mail_t + ((size_t)par * C + rank) * MAIL_T, (unsigned)tid);
        int* mi = cluster.map_shared_rank(
            mail_i + ((size_t)par * C + rank) * MAIL_I, (unsigned)tid);
        mt[0] = best.v;
        mt[1] = best.d;
        mt[2] = have ? c[jq] : T(0);
        mt[3] = have ? lo[jq] : T(0);
        mt[4] = have ? hi[jq] : T(0);
        mt[5] = have ? span[jq] : T(0);
        mt[6] = have ? zv(jq) : T(0);
        mi[0] = qb;
        mi[1] = best.any;
        mi[2] = have ? atu[jq] : 0;
      }
      cluster.sync();
      K5_TICK(P_BARRIERS);
      if (w0) {
        const T* mt = mail_t + (size_t)par * C * MAIL_T;
        const int* mi = mail_i + (size_t)par * C * MAIL_I;
        int any = mi[1];
        for (int rk = 1; rk < C; ++rk) {
          if (wins(mt[rk * MAIL_T], mi[rk * MAIL_I], mt[win * MAIL_T],
                   mi[win * MAIL_I]))
            win = rk;
          any |= mi[rk * MAIL_I + 1];
        }
        q = mi[win * MAIL_I];
        dq = mt[win * MAIL_T + 1];
        cq = mt[win * MAIL_T + 2];
        loq = mt[win * MAIL_T + 3];
        hiq = mt[win * MAIL_T + 4];
        spanq = mt[win * MAIL_T + 5];
        zq = mt[win * MAIL_T + 6];
        anyq = any != 0;
        atuq = mi[win * MAIL_I + 2] != 0;
        acol = ccol + ((size_t)par * C + win) * m;
      }
    } else if (w0) {
      q = best.j;
      dq = best.d;
      cq = c[q];
      loq = lo[q];
      hiq = hi[q];
      spanq = span[q];
      zq = zv(q);
      anyq = best.any != 0;
      atuq = atu[q] != 0;
      acol = tab + q;
      astride = pitch;
    }

    if (w0) {
      // the ratio test, the rows strided over warp 0
      const T sigma = dq < T(0) ? T(1) : T(-1);  // up on d < 0
      T mn = INF;
      for (int i = lane; i < m; i += 32) {
        const T a = acol[(size_t)i * astride];
        const T x = xB[i], l = bl[i], h = bh[i];
        const bool bw = below[i], ab = above[i];
        const T eta = Op<T>::mul(-sigma, a);
        const T ae = fabs(eta);
        const bool ng = eta < T(0);
        const T num = ng ? Op<T>::sub(x, ab ? h : l) : Op<T>::sub(bw ? l : h, x);
        const bool valid = ae > pt && !(ng ? bw : ab);
        const T r = valid ? Op<T>::div(num, ae) : INF;
        const T rc = r < T(0) ? T(0) : r;
        alpha[i] = a;
        ratio[i] = rc;
        mn = fmin(mn, rc);
      }
      for (int off = 16; off > 0; off >>= 1)
        mn = fmin(mn, __shfl_xor_sync(FULL, mn, off));
      K5_TICK(P_RATIO);
      // the least ratio and, among the rows tied with it, the one of
      // largest |eta| (Bland: the lowest basic column)
      const T tie = Op<T>::add(mn, ft);
      T pv = -INF;
      int r = INT_MAX;
      for (int i = lane; i < m; i += 32) {
        const T ae = fabs(Op<T>::mul(-sigma, alpha[i]));
        const T pick = ratio[i] <= tie ? (bland ? -T(basis[i]) : ae)
                                       : (bland ? T(-BIG) : T(-1));
        if (wins(pick, i, pv, r)) {
          pv = pick;
          r = i;
        }
      }
      warp_argmax_all(pv, r);
      __syncwarp();  // every row's alpha and ratio, for row r's
      K5_TICK(P_ROW_PICK);

      // the step's outcome, the bound flags, the objective watermark
      const bool row_blocks = mn < spanq;
      const T theta = row_blocks ? ratio[r] : spanq;
      const int code = p1n ? 1 : 0;  // INFEASIBLE = 1, OPTIMAL = 0
      status = anyq ? (isfinite(theta) ? RUNNING : UNBOUNDED - code) : code;
      const bool moves = status == RUNNING;
      const bool do_pivot = moves && row_blocks, do_flip = moves && !row_blocks;
      const int p_col = basis[r];
      const T piv = alpha[r];
      const bool leave_up = Op<T>::mul(-sigma, piv) < T(0) ? above[r] : !below[r];
      const T newval = Op<T>::add(zq, Op<T>::mul(sigma, theta));
      if (lane == 0) {
        const int pq = p_col - j0, qq = q - j0;
        const bool hp = pq >= 0 && pq < wr, hq = qq >= 0 && qq < wr;
        if (do_pivot) {
          if (hp) {
            atu[pq] = leave_up;
            inb[pq] = 0;
          }
          if (hq) inb[qq] = 1;
        } else if (hq) {
          atu[qq] = atuq ^ do_flip;
        }
        if (do_pivot && hp) cz[pq] = Op<T>::mul(c[pq], zv(pq));
        if (hq) cz[qq] = Op<T>::mul(c[qq], zv(qq));
      }
      T czv = T(0);
      if (!p1n)
        czv = total_arr(czall + (size_t)par * ninc, nc);
      const T cur = p1n ? infeas : Op<T>::add(cbx, czv);
      const bool progressed = cur < Op<T>::sub(last_e, prog);
      stall = progressed ? 0 : stall_e + 1;
      last = cur < last_e ? cur : last_e;
      p1 = p1n;
      it += 1;
      __syncwarp();  // row r's basis, bounds and cost are read
      K5_TICK(P_OUTCOME);

      // the step: basic values along eta; a pivot's row takes q's value,
      // bounds and cost (its rank-1 update waits for the next pricing)
      if (moves) {
        for (int i = lane; i < m; i += 32) {
          const T eta = Op<T>::mul(-sigma, alpha[i]);
          T v = (m <= XLA_WINDOW && i == 0)
                    ? Op<T>::add(xB[0], Op<T>::mul(eta, theta))
                    : Op<T>::fma(eta, theta, xB[i]);
          if (do_pivot && i == r) {
            v = newval;
            basis[i] = q;
            bl[i] = loq;
            bh[i] = hiq;
            cBb[i] = cq;
          }
          xB[i] = v;
        }
      }
      K5_TICK(P_XB_STEP);
      if (status == RUNNING && it < max_iters) rows_and_sums();
      publish_head(do_pivot, r, fabs(piv) > T(0) ? piv : T(1));
    }
    par ^= 1;
    lane_sync<SHAPE>();
    K5_TICK(P_BARRIERS);
  }

  // ---- finish -------------------------------------------------------------
  for (int jj = tid; jj < wr; jj += nt) z[jj] = zv(jj);
  lane_sync<SHAPE>();
  for (int i = tid; i < m; i += nt) {
    const int bq = basis[i] - j0;
    if (bq >= 0 && bq < wr) z[bq] = xB[i];
  }
  lane_sync<SHAPE>();
  // the objective c . z: a chain of fused multiply-adds on one block when
  // nc <= 32, else the rounded products c z (in place of z once written
  // out), each window's sum into every block's buffer of the next parity,
  // which no block reads before the cluster barrier below
  for (int jj = tid; jj < wr; jj += nt) {
    const int j = j0 + jj;
    if (x_o != nullptr && j < n) x_o[(size_t)row * n + j] = z[jj];
    if (atu_o != nullptr) atu_o[(size_t)row * nc + j] = atu[jj];
    if (nc > XLA_WINDOW) z[jj] = Op<T>::mul(c[jj], z[jj]);
  }
  T* fin = czall + (size_t)par * ninc;
  if (nc > XLA_WINDOW) {
    lane_sync<SHAPE>();
    for (int wl = tid; wl < nwl; wl += nt) {
      const int w = sl.w0 + wl;
      const T s = window_arr(z, nc, pad_low(nc), w, j0);
      if constexpr (CL) {
        for (int rk = 0; rk < C; ++rk)
          *cg::this_cluster().map_shared_rank(fin + w, (unsigned)rk) = s;
      } else {
        fin[w] = s;
      }
    }
  }
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    lane_sync<SHAPE>();
  if (rank == 0 && basis_o != nullptr)
    for (int i = tid; i < m; i += nt) basis_o[(size_t)row * m + i] = basis[i];
  if (tid == 0) {  // in warp 0, which holds the lane's state
    head_i[5] = status == RUNNING ? ITER_LIMIT : status;
    head_i[6] = it;
    head_t[1] = nc > XLA_WINDOW ? total_arr(fin, nc) : fma_chain_arr(c, z, nc);
  }
  K5_CLOCK_STORE(clocked, row);
  lane_sync<SHAPE>();
  return LaneResult<T>{head_i[5], head_t[1], head_i[6]};
}

}  // namespace
