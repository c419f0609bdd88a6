// K5 on Hopper: the whole loop of the dense bounded-variable simplex of
// moip_aira_tpu_torch/solver/simplex_dense.py (DenseLPSolver: start, steps
// and finish) in one launch, one block a lane, in float32 or float64.
//
// This kernel replaces no Pallas kernel: the JAX package runs this solver
// (moip_aira_tpu/solver/simplex_jax.py) under XLA, for the lex backend
// (backend="jax", float64) and the wave's XLA engine (engine="xla", float32
// and float64).  Its plain version, which the tests and chip_smoke.py hold
// it against bit for bit, is DenseLPSolver on the CPU.
//
// What it computes, per lane: the tableau T = B^-1 [A | -I] (m x nc), from
// the logical basis (T = -W); composite phase 1, Dantzig pricing that turns
// into Bland's rule after stall_limit steps without a material objective
// improvement (a watermark), a bounded ratio test with bound flips and a
// largest-|pivot| tie-break, and the rank-1 update; then the structural x,
// the objective, the basis and the at-upper flags.  A lane whose loop
// condition fails stops, which is what the plain version's lock-step loop
// does to it (its state is frozen).  Ties go to the first index, as
// torch.argmax and jnp.argmax break them.
//
// The order of every operation is the plain version's, written out, which
// is the order XLA's CPU backend computes simplex_jax in:
//   * a sum of at most XLA_WINDOW (32) terms runs term by term from the
//     first; a longer one is cut into windows of 32 terms, zero-padded
//     pad / 2 low and the rest high, each window summed so, then the
//     windows' sums the same way (xla_sum);
//   * a sum of products of at most 32 terms is a chain of fused
//     multiply-adds from the first product, rounded (xla_dot); a longer one
//     sums the rounded products by xla_sum;
//   * the rank-1 update T -= colv (x) row and the basic values' step
//     xB + eta theta are fused multiply-adds, except row 0 of the step when
//     m <= 32, whose product is rounded apart;
//   * every other operation is rounded on its own (__fadd_rn / __dadd_rn,
//     __fmul_rn / __dmul_rn, IEEE division), so the build's flags (nvcc
//     contracts a * b + c in plain code) change nothing here.
//
// What bounds it on this card: each step reads the tableau twice (pricing,
// the alpha column) and rewrites it once, but at the lanes the fronts send
// (tens) a step is a chain of dependent latencies: pricing is one column's
// chain of m fused multiply-adds a thread, the infeasibility and objective
// sums, the row pick and the step itself are serial in the plain version's
// order, and between them sit about nine block barriers.  What the design
// does about it: everything of a lane stays in one block for the whole
// loop, so a step costs no launch and no host read (the plain version's
// PyTorch loop takes 140-300 small kernels and one host read a step); the
// tableau stays in shared memory when it fits (2AP20 in float64, 148.5 KB)
// and in a per-lane global scratch otherwise (2AP40); the three serial
// row sums run side by side on three warps; the first level of a long
// column sum runs a window a thread.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsimplex_dense.so simplex_dense.cu

#include <cstddef>

#include "simplex_common.cuh"

namespace {

constexpr int XLA_WINDOW = 32;
constexpr int K5_MIN_THREADS = 128;  // warps 0-2 run the serial row sums
constexpr int K5_MAX_THREADS = 512;
// the longest sum xla_sum<2> takes: windows of windows of windows
constexpr int K5_MAX_TERMS = XLA_WINDOW * XLA_WINDOW * XLA_WINDOW;

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

// x(0) + x(1) + ... + x(L - 1), term by term from x(0)
template <class T, class F>
__device__ T chain_sum(const F& x, int L) {
  T acc = x(0);
  for (int i = 1; i < L; ++i) acc = Op<T>::add(acc, x(i));
  return acc;
}

// window w of a windowed sum over L terms padded `lo` zeros low: padded
// term k is x(k - lo) inside [0, L) and +0 outside
template <class T, class F>
__device__ T window_sum(const F& x, int L, int lo, int w) {
  T acc = T(0);
  for (int k = 0; k < XLA_WINDOW; ++k) {
    const int i = w * XLA_WINDOW + k - lo;
    const T v = (i >= 0 && i < L) ? x(i) : T(0);
    acc = k == 0 ? v : Op<T>::add(acc, v);
  }
  return acc;
}

__host__ __device__ inline int windows(int L) {
  return (L + XLA_WINDOW - 1) / XLA_WINDOW;
}

__host__ __device__ inline int pad_low(int L) {
  return (windows(L) * XLA_WINDOW - L) / 2;
}

// xla_sum of x(0..L), L <= 32^(D+1), on one thread
template <int D, class T, class F>
__device__ T xla_sum(const F& x, int L) {
  if constexpr (D == 0) {
    return chain_sum<T>(x, L);
  } else {
    if (L <= XLA_WINDOW) return chain_sum<T>(x, L);
    const int lo = pad_low(L);
    auto win = [&](int w) { return window_sum<T>(x, L, lo, w); };
    return xla_sum<D - 1, T>(win, windows(L));
  }
}

// xla_dot of a(i) b(i) over i < L, on one thread
template <class T, class A, class B>
__device__ T xla_dot(const A& a, const B& b, int L) {
  if (L > XLA_WINDOW)
    return xla_sum<2, T>([&](int i) { return Op<T>::mul(a(i), b(i)); }, L);
  T acc = Op<T>::mul(a(0), b(0));
  for (int i = 1; i < L; ++i) acc = Op<T>::fma(a(i), b(i), acc);
  return acc;
}

// xla_sum of x(0..L) by the whole block into *out: the first level's
// windows one a thread, the windows' sums on thread 0.  Ends with a barrier.
template <class T, class F>
__device__ void block_xla_sum(const F& x, int L, T* wsum, T* out) {
  if (L <= XLA_WINDOW) {
    if (threadIdx.x == 0) *out = chain_sum<T>(x, L);
  } else {
    const int nw = windows(L), lo = pad_low(L);
    for (int w = threadIdx.x; w < nw; w += blockDim.x)
      wsum[w] = window_sum<T>(x, L, lo, w);
    __syncthreads();
    if (threadIdx.x == 0)
      *out = xla_sum<1, T>([&](int w) { return wsum[w]; }, nw);
  }
  __syncthreads();
}

// (a, ia) beats (b, ib): larger value, lower index among equals
template <class T>
__device__ __forceinline__ bool wins(T a, int ia, T b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <class T>
__device__ __forceinline__ void warp_argmax_t(T& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (wins(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Where each array of a lane lives in the block's dynamic shared memory,
// as byte offsets, each 16-byte aligned; `tab` (the tableau) only when it
// sits there.  The wrapper's dense_loop_smem_bytes counts the same.
struct Layout {
  size_t tab, c, lo, hi, zlo, zup, span, col;
  size_t xB, bl, bh, alpha, ratio, cB, cBb, t1, t2, wsum;
  size_t basis, inb, atu, fre, below, above, total;
};

__host__ __device__ inline Layout k5_layout(int m, int nc, int dsize,
                                            bool t_smem) {
  Layout L{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = (off + bytes + 15) & ~static_cast<size_t>(15);
    return at;
  };
  const size_t col = (size_t)nc * dsize, row = (size_t)m * dsize;
  L.tab = take(t_smem ? (size_t)m * nc * dsize : 0);
  L.c = take(col);
  L.lo = take(col);
  L.hi = take(col);
  L.zlo = take(col);
  L.zup = take(col);
  L.span = take(col);
  L.col = take(col);
  L.xB = take(row);
  L.bl = take(row);
  L.bh = take(row);
  L.alpha = take(row);
  L.ratio = take(row);
  L.cB = take(row);
  L.cBb = take(row);
  L.t1 = take(row);
  L.t2 = take(row);
  L.wsum = take((size_t)windows(nc) * dsize);
  L.basis = take((size_t)m * sizeof(int));
  L.inb = take(nc);
  L.atu = take(nc);
  L.fre = take(nc);
  L.below = take(m);
  L.above = take(m);
  L.total = off;
  return L;
}

template <class T>
struct LaneScalars {
  T infeas_lo, infeas_hi, cbx, czv, infeas, last, last_e, theta, newval, obj;
  T rmin;
  int q, r, status, it, stall, stall_e;
  bool p1, p1n, any_elig, moves, do_pivot, run;
  T red_v[MAX_WARPS];
  int red_i[MAX_WARPS];
};

template <class T>
__global__ void __launch_bounds__(K5_MAX_THREADS)
    simplex_dense_kernel(const T* __restrict__ W, int m, int n,
                         const T* __restrict__ c_g, const T* __restrict__ lo_g,
                         const T* __restrict__ hi_g,
                         const unsigned char* __restrict__ active,
                         int max_iters, T ft, T ct, T pt, T prog,
                         int stall_limit, int t_smem, T* t_scratch,
                         int* status_o, T* obj_o, T* x_o, long long* basis_o,
                         unsigned char* atu_o, int* iters_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LaneScalars<T> s;
  const int nc = n + m;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T INF = T(INFINITY);
  const Layout L = k5_layout(m, nc, (int)sizeof(T), t_smem != 0);
  T* tab = t_smem ? reinterpret_cast<T*>(smem + L.tab)
                  : t_scratch + (size_t)b * m * nc;
  T* c = reinterpret_cast<T*>(smem + L.c);
  T* lo = reinterpret_cast<T*>(smem + L.lo);
  T* hi = reinterpret_cast<T*>(smem + L.hi);
  T* zlo = reinterpret_cast<T*>(smem + L.zlo);
  T* zup = reinterpret_cast<T*>(smem + L.zup);
  T* span = reinterpret_cast<T*>(smem + L.span);
  T* col = reinterpret_cast<T*>(smem + L.col);  // d, then the pivot row, z
  T* xB = reinterpret_cast<T*>(smem + L.xB);
  T* bl = reinterpret_cast<T*>(smem + L.bl);
  T* bh = reinterpret_cast<T*>(smem + L.bh);
  T* alpha = reinterpret_cast<T*>(smem + L.alpha);
  T* ratio = reinterpret_cast<T*>(smem + L.ratio);
  T* cB = reinterpret_cast<T*>(smem + L.cB);
  T* cBb = reinterpret_cast<T*>(smem + L.cBb);
  T* t1 = reinterpret_cast<T*>(smem + L.t1);
  T* t2 = reinterpret_cast<T*>(smem + L.t2);
  T* wsum = reinterpret_cast<T*>(smem + L.wsum);
  int* basis = reinterpret_cast<int*>(smem + L.basis);
  unsigned char* inb = smem + L.inb;
  unsigned char* atu = smem + L.atu;
  unsigned char* fre = smem + L.fre;
  unsigned char* below = smem + L.below;
  unsigned char* above = smem + L.above;
  // a nonbasic column's value (0 for a basic one) under the current flags
  auto zv = [&](int j) -> T {
    return inb[j] ? T(0) : (atu[j] ? zup[j] : zlo[j]);
  };

  // ---- start: the lane's constants and the logical basis -----------------
  const T* cb = c_g + (size_t)b * nc;
  const T* lob = lo_g + (size_t)b * nc;
  const T* hib = hi_g + (size_t)b * nc;
  int empty = 0;
  for (int j = tid; j < nc; j += nt) {
    const T l = lob[j], h = hib[j];
    const bool fl = isfinite(l), fh = isfinite(h);
    c[j] = cb[j];
    lo[j] = l;
    hi[j] = h;
    fre[j] = !fl && !fh;
    const T zl = fl ? l : (fh ? h : T(0));
    zlo[j] = zl;
    zup[j] = fh ? h : zl;
    span[j] = (fl && fh) ? Op<T>::sub(h, l) : INF;
    inb[j] = j >= n;
    atu[j] = j < n && !fl && fh;
    empty |= l > Op<T>::add(h, ft);  // an empty box is INFEASIBLE
  }
  for (size_t e = tid; e < (size_t)m * nc; e += nt) tab[e] = -W[e];
  for (int i = tid; i < m; i += nt) basis[i] = n + i;
  empty = __syncthreads_or(empty);
  for (int i = tid; i < m; i += nt)
    xB[i] = -xla_dot<T>([&](int j) { return tab[(size_t)i * nc + j]; }, zv,
                        nc);
  if (tid == 0) {
    const bool skip = empty || (active != nullptr && !active[b]);
    s.status = skip ? INFEASIBLE : RUNNING;
    s.p1 = true;
    s.stall = 0;
    s.last = INF;
    s.it = 0;
    s.run = s.status == RUNNING && 0 < max_iters;
  }
  __syncthreads();

  // ---- the steps ----------------------------------------------------------
  while (s.run) {
    const bool bland = s.stall >= stall_limit;  // the count the step starts with
    for (int i = tid; i < m; i += nt) {
      const int bi = basis[i];
      const T l = lo[bi], h = hi[bi], x = xB[i];
      const bool bw = x < Op<T>::sub(l, ft), ab = x > Op<T>::add(h, ft);
      bl[i] = l;
      bh[i] = h;
      below[i] = bw;
      above[i] = ab;
      t1[i] = bw ? Op<T>::sub(l, x) : T(0);
      t2[i] = ab ? Op<T>::sub(x, h) : T(0);
      cBb[i] = c[bi];
    }
    __syncthreads();
    // three serial row sums side by side, one a warp
    if (tid == 0) s.infeas_lo = xla_sum<2, T>([&](int i) { return t1[i]; }, m);
    if (tid == 32) s.infeas_hi = xla_sum<2, T>([&](int i) { return t2[i]; }, m);
    if (tid == 64)
      s.cbx = xla_dot<T>([&](int i) { return cBb[i]; },
                         [&](int i) { return xB[i]; }, m);
    __syncthreads();
    if (tid == 0) {
      const T infeas = Op<T>::add(s.infeas_lo, s.infeas_hi);
      const bool p1n = s.p1 && infeas > ft;  // phase 1 ends once feasible
      const bool entered = s.p1 && !p1n;
      s.infeas = infeas;
      s.p1n = p1n;
      s.stall_e = entered ? 0 : s.stall;
      s.last_e = entered ? INF : s.last;
    }
    __syncthreads();
    const bool p1n = s.p1n;
    for (int i = tid; i < m; i += nt)
      cB[i] = p1n ? Op<T>::sub(T(above[i]), T(below[i])) : cBb[i];
    __syncthreads();

    // pricing, a column a thread: d, eligibility and the entering column
    T best = -INF;
    int bestj = INT_MAX;
    int any = 0;
    for (int j = tid; j < nc; j += nt) {
      const T dsum = xla_dot<T>([&](int i) { return cB[i]; },
                                [&](int i) { return tab[(size_t)i * nc + j]; },
                                m);
      const T d = Op<T>::sub(p1n ? T(0) : c[j], dsum);
      col[j] = d;
      const T ad = fabs(d);
      const bool el = !inb[j] && (fre[j] ? ad > ct : (atu[j] ? d : -d) > ct);
      const T score = el ? (bland ? -T(j) : ad) : (bland ? T(-BIG) : T(-1));
      any |= el;
      if (wins(score, j, best, bestj)) {
        best = score;
        bestj = j;
      }
    }
    warp_argmax_t(best, bestj);
    if ((tid & 31) == 0) {
      s.red_v[tid >> 5] = best;
      s.red_i[tid >> 5] = bestj;
    }
    any = __syncthreads_or(any);
    if (tid < 32) {
      const int nw = nt >> 5;
      best = tid < nw ? s.red_v[tid] : -INF;
      bestj = tid < nw ? s.red_i[tid] : INT_MAX;
      warp_argmax_t(best, bestj);
      if (tid == 0) {
        s.q = bestj;
        s.any_elig = any != 0;
      }
    }
    // the objective's nonbasic part, with the step's starting flags
    if (!p1n)
      block_xla_sum<T>([&](int j) { return Op<T>::mul(c[j], zv(j)); }, nc,
                       wsum, &s.czv);
    __syncthreads();

    // the ratio test, a row a thread
    const int q = s.q;
    const T sigma = col[q] < T(0) ? T(1) : T(-1);  // up on d < 0
    for (int i = tid; i < m; i += nt) {
      const T a = tab[(size_t)i * nc + q];
      alpha[i] = a;
      const T eta = Op<T>::mul(-sigma, a);
      const T ae = fabs(eta);
      const bool ng = eta < T(0);
      const T num = ng ? Op<T>::sub(xB[i], above[i] ? bh[i] : bl[i])
                       : Op<T>::sub(below[i] ? bl[i] : bh[i], xB[i]);
      const bool valid = ae > pt && !(ng ? below[i] : above[i]);
      const T r = valid ? Op<T>::div(num, ae) : INF;
      ratio[i] = r < T(0) ? T(0) : r;
    }
    __syncthreads();
    // the least ratio and, among the rows tied with it, the one of largest
    // |eta| (Bland: the lowest basic column), on warp 0
    if (tid < 32) {
      T mn = INF;
      for (int i = tid; i < m; i += 32) mn = fmin(mn, ratio[i]);
      for (int off = 16; off > 0; off >>= 1)
        mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      const T tie = Op<T>::add(mn, ft);
      T pv = -INF;
      int pi = INT_MAX;
      for (int i = tid; i < m; i += 32) {
        const T ae = fabs(Op<T>::mul(-sigma, alpha[i]));
        const T pick = ratio[i] <= tie ? (bland ? -T(basis[i]) : ae)
                                       : (bland ? T(-BIG) : T(-1));
        if (wins(pick, i, pv, pi)) {
          pv = pick;
          pi = i;
        }
      }
      warp_argmax_t(pv, pi);
      if (tid == 0) {
        s.r = pi;
        s.rmin = mn;
      }
    }
    __syncthreads();

    // the step's outcome, the bound flags, the objective watermark
    if (tid == 0) {
      const int r = s.r;
      const T flip = span[q];
      const bool row_blocks = s.rmin < flip;
      const T theta = row_blocks ? ratio[r] : flip;
      const int code = p1n ? 1 : 0;  // INFEASIBLE = 1, OPTIMAL = 0
      const int status = s.any_elig
                             ? (isfinite(theta) ? RUNNING : UNBOUNDED - code)
                             : code;
      const bool moves = status == RUNNING;
      const bool do_pivot = moves && row_blocks, do_flip = moves && !row_blocks;
      const int p_col = basis[r];
      const bool leave_up =
          Op<T>::mul(-sigma, alpha[r]) < T(0) ? above[r] : !below[r];
      const T zq = zv(q);
      if (do_pivot)
        atu[p_col] = leave_up;
      else
        atu[q] = atu[q] ^ do_flip;
      s.newval = Op<T>::add(zq, Op<T>::mul(sigma, theta));
      s.theta = theta;
      s.moves = moves;
      s.do_pivot = do_pivot;
      if (do_pivot) {
        basis[r] = q;
        inb[p_col] = 0;
        inb[q] = 1;
      }
      const T cur = p1n ? s.infeas : Op<T>::add(s.cbx, s.czv);
      const bool progressed = cur < Op<T>::sub(s.last_e, prog);
      s.stall = progressed ? 0 : s.stall_e + 1;
      s.last = cur < s.last_e ? cur : s.last_e;
      s.p1 = p1n;
      s.it += 1;
      s.status = status;
      s.run = status == RUNNING && s.it < max_iters;
    }
    __syncthreads();

    // the step: basic values along eta; a pivot's rank-1 update
    if (s.moves) {
      const T theta = s.theta;
      const int r = s.r;
      const bool do_pivot = s.do_pivot;
      for (int i = tid; i < m; i += nt) {
        const T eta = Op<T>::mul(-sigma, alpha[i]);
        T v = (m <= XLA_WINDOW && i == 0)
                  ? Op<T>::add(xB[0], Op<T>::mul(eta, theta))
                  : Op<T>::fma(eta, theta, xB[i]);
        if (do_pivot && i == r) v = s.newval;
        xB[i] = v;
      }
      if (do_pivot) {
        const T piv = alpha[r];
        const T den = fabs(piv) > T(0) ? piv : T(1);
        for (int j = tid; j < nc; j += nt)
          col[j] = Op<T>::div(tab[(size_t)r * nc + j], den);
        __syncthreads();
        for (int j = tid; j < nc; j += nt) {
          const T rj = col[j];
          for (int i = 0; i < m; ++i) {
            T* t = tab + (size_t)i * nc + j;
            *t = i == r ? rj : Op<T>::fma(-alpha[i], rj, *t);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- finish -------------------------------------------------------------
  for (int j = tid; j < nc; j += nt) col[j] = zv(j);
  __syncthreads();
  for (int i = tid; i < m; i += nt) col[basis[i]] = xB[i];
  __syncthreads();
  if (nc > XLA_WINDOW) {
    block_xla_sum<T>([&](int j) { return Op<T>::mul(c[j], col[j]); }, nc,
                     wsum, &s.obj);
  } else {
    if (tid == 0)
      s.obj = xla_dot<T>([&](int j) { return c[j]; },
                         [&](int j) { return col[j]; }, nc);
    __syncthreads();
  }
  for (int j = tid; j < nc; j += nt) {
    if (j < n) x_o[(size_t)b * n + j] = col[j];
    atu_o[(size_t)b * nc + j] = atu[j];
  }
  for (int i = tid; i < m; i += nt) basis_o[(size_t)b * m + i] = basis[i];
  if (tid == 0) {
    status_o[b] = s.status == RUNNING ? ITER_LIMIT : s.status;
    obj_o[b] = s.obj;
    iters_o[b] = s.it;
  }
}

// Checks the launch and raises the kernel's shared-memory limit to the
// card's opt-in once per device: 0, or the CUDA error the launch would meet.
template <class T>
int k5_prepare(int m, int n, int threads, int t_smem, size_t* bytes) {
  static bool raised[MAX_DEVICES] = {};
  const int nc = n + m;
  if (m <= 0 || n < 0 || nc > K5_MAX_TERMS || threads < K5_MIN_THREADS ||
      threads > K5_MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int cap = dynamic_smem_cap();
  *bytes = k5_layout(m, nc, (int)sizeof(T), t_smem != 0).total;
  if (cap <= 0 || *bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  const int slot = device_slot();
  if (slot < 0 || !raised[slot]) {
    cudaError_t e = cudaFuncSetAttribute(
        simplex_dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cap);
    if (e != cudaSuccess) return (int)e;
    if (slot >= 0) raised[slot] = true;
  }
  return 0;
}

template <class T>
int k5_launch(const void* W, int m, int n, int batch, const void* c,
              const void* lo, const void* hi, const void* active,
              int max_iters, double feas_tol, double cost_tol,
              double pivot_tol, double progress_tol, int stall_limit,
              int threads, int t_smem, void* t_scratch, void* status,
              void* obj, void* x, void* basis, void* at_upper, void* iters,
              void* stream) {
  size_t bytes = 0;
  const int err = k5_prepare<T>(m, n, threads, t_smem, &bytes);
  if (err) return err;
  if (!t_smem && t_scratch == nullptr) return (int)cudaErrorInvalidValue;
  simplex_dense_kernel<T>
      <<<batch, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(W), m, n, static_cast<const T*>(c),
          static_cast<const T*>(lo), static_cast<const T*>(hi),
          static_cast<const unsigned char*>(active), max_iters,
          static_cast<T>(feas_tol), static_cast<T>(cost_tol),
          static_cast<T>(pivot_tol), static_cast<T>(progress_tol),
          stall_limit, t_smem, static_cast<T*>(t_scratch),
          static_cast<int*>(status), static_cast<T*>(obj),
          static_cast<T*>(x), static_cast<long long*>(basis),
          static_cast<unsigned char*>(at_upper), static_cast<int*>(iters));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared bytes a block may opt into on the current card, which
// the launch plan reads (it sets STATIC_SMEM_RESERVE of them aside for
// static shared memory).  Returns 0 or a CUDA error.
int simplex_dense_smem_optin(int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// A block's dynamic shared bytes for m rows, n structural columns, values
// of `dsize` bytes and the tableau in shared memory or not (for the
// wrapper's check of its own arithmetic).
long long simplex_dense_smem_bytes(int m, int n, int dsize, int t_smem) {
  return (long long)k5_layout(m, n + m, dsize, t_smem != 0).total;
}

// Launches K5 on `stream`, one block of `threads` a lane, in float32 (dsize
// 4) or float64 (8); returns 0 on success, else the CUDA error (a launch
// that does not fit is refused before it).  All pointers are device
// pointers: W (m, n+m), c/lo/hi (batch, n+m) in the dtype, active (batch)
// bytes or null, t_scratch (batch, m, n+m) in the dtype when the tableau is
// not in shared memory (t_smem 0); outputs status/iters (batch) i32, obj
// (batch) and x (batch, n) in the dtype, basis (batch, m) i64, at_upper
// (batch, n+m) bytes.
int simplex_dense_launch(int dsize, const void* W, int m, int n, int batch,
                         const void* c, const void* lo, const void* hi,
                         const void* active, int max_iters, double feas_tol,
                         double cost_tol, double pivot_tol,
                         double progress_tol, int stall_limit, int threads,
                         int t_smem, void* t_scratch, void* status, void* obj,
                         void* x, void* basis, void* at_upper, void* iters,
                         void* stream) {
  if (batch <= 0) return 0;
  if (dsize == 4)
    return k5_launch<float>(W, m, n, batch, c, lo, hi, active, max_iters,
                            feas_tol, cost_tol, pivot_tol, progress_tol,
                            stall_limit, threads, t_smem, t_scratch, status,
                            obj, x, basis, at_upper, iters, stream);
  if (dsize == 8)
    return k5_launch<double>(W, m, n, batch, c, lo, hi, active, max_iters,
                             feas_tol, cost_tol, pivot_tol, progress_tol,
                             stall_limit, threads, t_smem, t_scratch, status,
                             obj, x, basis, at_upper, iters, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
