// K1 on Hopper: a batched bounded-variable primal simplex, one LP per block.
//
// Replaces moip_aira_tpu/solver/pallas_lp.py::make_pallas_lp_batch (the
// Pallas TPU kernel).  Its plain PyTorch version, which the tests and
// chip_smoke.py hold this kernel against, is
// moip_aira_tpu_torch/solver/simplex_torch.py::dense_lp_batch_ref.
//
// What it computes, per lane: the tableau T = B^-1 [A | -I] (m x nc, f32),
// cold from the logical basis (T = -W) or warm from a given basis by a
// Gauss-Jordan rebuild with greedy partial pivoting (a singular warm basis
// falls back to cold); then composite phase 1, Dantzig pricing that turns
// into Bland's rule after STALL_LIMIT pivots without progress, a ratio test
// with bound flips and a largest-|pivot| tie-break, and a rank-1 update.
// Ties break on the first of equal maxima, as jnp.argmax and torch.argmax do:
// lowest column in pricing, lowest row in the ratio test (lowest basic column
// id under Bland), lowest row-major entry in the rebuild.
//
// What bounds it on this card: every pivot reads the whole m x nc tableau
// twice (pricing, then the rank-1 update) and writes it once, so a lane is
// bound by shared-memory bandwidth (L2 bandwidth when the tableau is too big
// for shared memory), plus the latency of what a pivot serialises: three
// block reductions (pricing argmax, ratio min, row pick) and two short sums
// over the m rows (phase-1 infeasibility, objective).
// What the design does about it: one thread block per lane, so a lane leaves
// its pivot loop on its own and no lane waits for the slowest of a chunk
// (the TPU kernel ran a chunk of lanes in lock step); the tableau sits in
// dynamic shared memory whenever it fits (2AP20's 42 x 442 is 74 KB, two
// blocks per SM), else in a global scratch slice per lane; threads own
// columns, so pricing and the rank-1 update touch consecutive addresses and
// need no synchronisation inside the update; the block is as narrow as the
// tableau allows (32 to 256 threads), which keeps reductions short on tiny
// LPs.  Every sum runs in index order and every multiply-add is rounded
// twice (no fused multiply-add), exactly as the plain PyTorch version
// computes them, so kernel and plain version take the same pivots bit for
// bit instead of two f32 paths that may part ways on degenerate LPs.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdense_simplex.so dense_simplex.cu

#include "simplex_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// dynamic shared bytes: the tableau (when it lives there) plus the vectors
size_t vector_bytes(int m, int nc) {
  return sizeof(float) * (4 * (size_t)nc + 7 * (size_t)m) +
         sizeof(int) * (2 * (size_t)nc + 2 * (size_t)m);
}

size_t tableau_bytes(int m, int nc) { return sizeof(float) * (size_t)m * nc; }

template <bool SMEM_T>
__global__ void __launch_bounds__(MAX_THREADS)
    dense_simplex_kernel(const float* __restrict__ W, int m, int n,
                         const float* __restrict__ c_g,
                         const float* __restrict__ lo_g,
                         const float* __restrict__ hi_g,
                         const int* __restrict__ wb_g,
                         const int* __restrict__ wa_g, int max_iters,
                         float feas_tol, float cost_tol, float pivot_tol,
                         float* __restrict__ T_g, int* __restrict__ status_o,
                         float* __restrict__ obj_o, float* __restrict__ x_o,
                         int* __restrict__ basis_o, int* __restrict__ atup_o,
                         int* __restrict__ iters_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch red;
  __shared__ int s_status, s_stall, s_iters;
  __shared__ float s_last, s_sum;

  const int nc = n + m;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane_off = (size_t)b * nc;

  float* p = reinterpret_cast<float*>(smem_raw);
  float* T = p;
  if (SMEM_T) {
    p += (size_t)m * nc;
  } else {
    T = T_g + (size_t)b * m * nc;
  }
  float* c = p;
  p += nc;
  float* lo = p;
  p += nc;
  float* hi = p;
  p += nc;
  float* d = p;  // reduced costs; the solution z at the end
  p += nc;
  float* xB = p;
  p += m;
  float* bl = p;
  p += m;
  float* bh = p;
  p += m;
  float* cB = p;
  p += m;
  float* cB1 = p;  // phase-1 basic costs; the unassigned-row mask in the rebuild
  p += m;
  float* alpha = p;  // entering (or rebuild pivot) column
  p += m;
  float* ratio = p;
  p += m;
  int* ip = reinterpret_cast<int*>(p);
  int* basis = ip;
  ip += m;
  int* hits_up = ip;
  ip += m;
  int* inb = ip;
  ip += nc;
  int* atup = ip;  // at-upper flags; the remaining-column mask in the rebuild

  for (int j = tid; j < nc; j += nt) {
    c[j] = c_g[lane_off + j];
    lo[j] = lo_g[lane_off + j];
    hi[j] = hi_g[lane_off + j];
  }
  const bool warm = wb_g[(size_t)b * m] >= 0;
  for (int e = tid; e < m * nc; e += nt) T[e] = warm ? W[e] : -W[e];
  for (int i = tid; i < m; i += nt) basis[i] = n + i;

  // ---- warm start: Gauss-Jordan rebuild of B^-1 W ------------------------
  bool use_warm = false;
  if (warm) {
    for (int j = tid; j < nc; j += nt) atup[j] = 0;
    for (int i = tid; i < m; i += nt) cB1[i] = 1.0f;
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
      const int w = wb_g[(size_t)b * m + i];
      if (w >= 0 && w < nc) atup[w] = 1;
    }
    __syncthreads();
    bool ok = true;
    for (int step = 0; step < m; ++step) {
      float best = -INFINITY;
      int arg = INT_MAX;
      for (int e = tid; e < m * nc; e += nt) {
        const int i = e / nc, j = e - (e / nc) * nc;
        const float s = fabsf(T[e]) * cB1[i] * (float)atup[j];
        if (beats(s, e, best, arg)) {
          best = s;
          arg = e;
        }
      }
      block_argmax(best, arg, &red);
      const int r = arg / nc, cb = arg - (arg / nc) * nc;
      const float piv = T[arg];
      // every thread reads the pivot before a thread that gives up resets
      // T to the cold tableau below
      __syncthreads();
      // the largest remaining score decides (as in revised_simplex.cu): when
      // it is 0 the arg-max lands on entry (0, 0), which may be an assigned
      // row's, and the basis is singular
      if (!(best > GJ_PIVOT_TOL)) {
        ok = false;
        break;
      }
      for (int i = tid; i < m; i += nt) alpha[i] = T[i * nc + cb];
      __syncthreads();
      for (int j = tid; j < nc; j += nt) {
        const float rd = T[r * nc + j] / piv;
        for (int i = 0; i < m; ++i) {
          const float cv = i == r ? piv - 1.0f : alpha[i];
          T[i * nc + j] = __fsub_rn(T[i * nc + j], __fmul_rn(cv, rd));
        }
      }
      __syncthreads();
      if (tid == 0) {
        cB1[r] = 0.0f;
        atup[cb] = 0;
        basis[r] = cb;
      }
      __syncthreads();
    }
    use_warm = ok;
    if (!ok) {
      for (int e = tid; e < m * nc; e += nt) T[e] = -W[e];
      for (int i = tid; i < m; i += nt) basis[i] = n + i;
    }
  }
  __syncthreads();

  // ---- basis bookkeeping and the basic solution --------------------------
  for (int j = tid; j < nc; j += nt) inb[j] = 0;
  __syncthreads();
  for (int i = tid; i < m; i += nt) inb[basis[i]] = 1;
  __syncthreads();
  bool empty = false;
  for (int j = tid; j < nc; j += nt) {
    const bool fhi = isfinite(hi[j]);
    if (use_warm)
      atup[j] = (wa_g[lane_off + j] > 0) && !inb[j];
    else
      atup[j] = (j < n) && !isfinite(lo[j]) && fhi && !inb[j];
    d[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
    empty |= lo[j] > hi[j] + feas_tol;
  }
  for (int i = tid; i < m; i += nt) {
    bl[i] = lo[basis[i]];
    bh[i] = hi[basis[i]];
    cB[i] = c[basis[i]];
  }
  empty = __syncthreads_or(empty);
  for (int i = tid; i < m; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < nc; ++j)
      acc = __fadd_rn(acc, __fmul_rn(T[i * nc + j], d[j]));
    xB[i] = -acc;
  }
  if (tid == 0) {
    s_status = empty ? INFEASIBLE : RUNNING;
    s_stall = 0;
    s_iters = 0;
    s_last = INFINITY;
  }
  __syncthreads();

  // ---- pivot loop --------------------------------------------------------
  for (int it = 0; it < max_iters && s_status == RUNNING; ++it) {
    // phase-1 infeasibility of the basic solution (ratio[] holds each
    // row's share until the ratio test overwrites it)
    for (int i = tid; i < m; i += nt) {
      const float x = xB[i], l = bl[i], h = bh[i];
      const bool below = x < l - feas_tol, above = x > h + feas_tol;
      ratio[i] = __fadd_rn(below ? l - x : 0.0f, above ? x - h : 0.0f);
      cB1[i] = below ? -1.0f : (above ? 1.0f : 0.0f);
    }
    __syncthreads();
    if (tid == 0) s_sum = seq_sum(ratio, m);
    __syncthreads();
    const float infeas_sum = s_sum;
    const bool phase1 = infeas_sum > feas_tol;
    const bool bland = s_stall >= STALL_LIMIT;
    const float* cBe = phase1 ? cB1 : cB;

    // pricing: one column per thread
    float best = -INFINITY;
    int q = INT_MAX;
    bool any = false;
    for (int j = tid; j < nc; j += nt) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i)
        acc = __fadd_rn(acc, __fmul_rn(cBe[i], T[i * nc + j]));
      float dj = -acc;
      if (!phase1) dj += c[j];
      d[j] = dj;
      const bool nb = !inb[j], at = atup[j] != 0;
      const bool fr = !isfinite(lo[j]) && !isfinite(hi[j]);
      const bool el = nb && (((!at || fr) && dj < -cost_tol) ||
                             ((at || fr) && dj > cost_tol));
      any |= el;
      const float sc = bland ? (el ? -(float)j : -BIG) : (el ? fabsf(dj) : -1.0f);
      if (beats(sc, j, best, q)) {
        best = sc;
        q = j;
      }
    }
    const bool any_elig = __syncthreads_or(any);
    block_argmax(best, q, &red);

    // entering column and ratio test: one row per thread
    const float dq = d[q];
    const bool fr_q = !isfinite(lo[q]) && !isfinite(hi[q]);
    const bool up_q = !inb[q] && (!atup[q] || fr_q) && dq < -cost_tol;
    const float sigma = up_q ? 1.0f : -1.0f;
    float rpart = INFINITY;
    for (int i = tid; i < m; i += nt) {
      const float a = T[i * nc + q];
      alpha[i] = a;
      const float eta = -sigma * a;
      const float x = xB[i], l = bl[i], h = bh[i];
      const bool below = x < l - feas_tol, above = x > h + feas_tol;
      const bool moving = fabsf(eta) > pivot_tol;
      const bool fl = isfinite(l), fh = isfinite(h);
      const float se = moving ? eta : 1.0f;
      float rt = INFINITY;
      bool hu = false;
      if (moving && !below && !above && eta < 0.0f && fl) rt = (x - l) / (-se);
      if (moving && !below && !above && eta > 0.0f && fh) {
        rt = (h - x) / se;
        hu = true;
      }
      if (moving && below && eta > 0.0f) rt = (l - x) / se;
      if (moving && above && eta < 0.0f) {
        rt = (x - h) / (-se);
        hu = true;
      }
      rt = fmaxf(rt, 0.0f);
      ratio[i] = rt;
      hits_up[i] = hu;
      rpart = fminf(rpart, rt);
    }
    const float rmin = block_min(rpart, &red);
    float pbest = -INFINITY;
    int r = INT_MAX;
    for (int i = tid; i < m; i += nt) {
      const bool tied = ratio[i] <= rmin + feas_tol;
      const float pk = bland ? (tied ? -(float)basis[i] : -BIG)
                             : (tied ? fabsf(alpha[i]) : -1.0f);
      if (beats(pk, i, pbest, r)) {
        pbest = pk;
        r = i;
      }
    }
    block_argmax(pbest, r, &red);

    // the step, decided identically by every thread from shared state
    const float lo_q = lo[q], hi_q = hi[q];
    const bool flo_q = isfinite(lo_q), fhi_q = isfinite(hi_q);
    const float lo_q0 = flo_q ? lo_q : 0.0f, hi_q0 = fhi_q ? hi_q : 0.0f;
    const float flip_theta = (flo_q && fhi_q) ? hi_q0 - lo_q0 : INFINITY;
    const bool row_blocks = rmin < flip_theta;
    const float theta = row_blocks ? ratio[r] : flip_theta;
    int new_status = RUNNING;
    if (!any_elig)
      new_status = phase1 ? INFEASIBLE : OPTIMAL;
    else if (!isfinite(theta))
      new_status = phase1 ? INFEASIBLE : UNBOUNDED;
    const bool stepping = new_status == RUNNING;
    const bool do_pivot = stepping && row_blocks;
    const bool do_flip = stepping && !row_blocks;
    const bool atq = atup[q] != 0;
    const float piv = alpha[r];
    const int p_col = basis[r];
    const bool leave_up = hits_up[r] != 0;
    __syncthreads();  // every thread has read the shared state it needs

    if (do_pivot) {
      const float safe_piv = fabsf(piv) > PIVOT_FLOOR ? piv : 1.0f;
      for (int j = tid; j < nc; j += nt) {
        const float rd = T[r * nc + j] / safe_piv;
        for (int i = 0; i < m; ++i) {
          const float cv = i == r ? piv - 1.0f : alpha[i];
          T[i * nc + j] = __fsub_rn(T[i * nc + j], __fmul_rn(cv, rd));
        }
      }
    }
    if (do_pivot || do_flip) {
      float zq = atq ? hi_q0 : lo_q0;
      if (!flo_q && !fhi_q) zq = 0.0f;
      for (int i = tid; i < m; i += nt) {
        xB[i] = (do_pivot && i == r)
                    ? __fadd_rn(zq, __fmul_rn(sigma, theta))
                    : __fadd_rn(xB[i], __fmul_rn(-sigma * alpha[i], theta));
      }
    }
    if (tid == 0) {
      if (do_flip) atup[q] = !atq;
      if (do_pivot) {
        atup[p_col] = leave_up;
        inb[p_col] = 0;
        inb[q] = 1;
        basis[r] = q;
        bl[r] = lo_q;
        bh[r] = hi_q;
        cB[r] = c[q];
      }
    }
    __syncthreads();

    // objective progress and the stall counter
    if (tid == 0) {
      float cur = infeas_sum;
      if (!phase1) {
        cur = 0.0f;
        for (int i = 0; i < m; ++i)
          cur = __fadd_rn(cur, __fmul_rn(cB[i], xB[i]));
      }
      s_stall = cur < s_last - 1e-9f ? 0 : s_stall + 1;
      s_last = cur;
      s_status = new_status;
      s_iters += 1;
    }
    __syncthreads();
  }

  // ---- finalize ----------------------------------------------------------
  for (int j = tid; j < nc; j += nt)
    d[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
  __syncthreads();
  for (int i = tid; i < m; i += nt) d[basis[i]] += xB[i];
  __syncthreads();
  for (int j = tid; j < nc; j += nt) {
    if (j < n) x_o[(size_t)b * n + j] = d[j];
    atup_o[lane_off + j] = atup[j];
  }
  for (int i = tid; i < m; i += nt) basis_o[(size_t)b * m + i] = basis[i];
  if (tid == 0) {
    float obj = 0.0f;
    for (int j = 0; j < nc; ++j) obj = __fadd_rn(obj, __fmul_rn(c[j], d[j]));
    status_o[b] = s_status == RUNNING ? ITER_LIMIT : s_status;
    obj_o[b] = obj;
    iters_o[b] = s_iters;
  }
}

}  // namespace

extern "C" {

// 1 when the lane's tableau fits in dynamic shared memory, 0 when the caller
// must pass a global scratch of batch * m * (n + m) floats, -1 when even the
// per-lane vectors do not fit (the kernel cannot take the shape).
int dense_simplex_tableau_in_smem(int m, int n) {
  const int nc = n + m;
  const size_t cap = (size_t)max_dynamic_smem();
  if (vector_bytes(m, nc) + tableau_bytes(m, nc) <= cap) return 1;
  if (vector_bytes(m, nc) <= cap) return 0;
  return -1;
}

// Launches one block per lane on `stream`; returns cudaGetLastError() after
// the launch (0 on success).  All pointers are device pointers: W (m, n+m),
// c/lo/hi (batch, n+m) f32, wb (batch, m) i32 with -1 = cold, wa (batch, n+m)
// i32; outputs status/iters (batch) i32, obj (batch) f32, x (batch, n) f32,
// basis (batch, m) i32, at_upper (batch, n+m) i32.  T_scratch is ignored
// when the tableau lives in shared memory.
int dense_simplex_launch(const void* W, int m, int n, int batch,
                         const void* c, const void* lo, const void* hi,
                         const void* wb, const void* wa, int max_iters,
                         float feas_tol, float cost_tol, float pivot_tol,
                         void* T_scratch, void* status, void* obj, void* x,
                         void* basis, void* at_upper, void* iters,
                         void* stream) {
  if (batch <= 0) return 0;
  const int nc = n + m;
  const int where = dense_simplex_tableau_in_smem(m, n);
  if (where < 0) return (int)cudaErrorInvalidValue;
  if (where == 0 && T_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool smem_t = where == 1;
  const size_t bytes =
      vector_bytes(m, nc) + (smem_t ? tableau_bytes(m, nc) : 0);
  int threads = ((nc + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  auto kern = smem_t ? dense_simplex_kernel<true> : dense_simplex_kernel<false>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<batch, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), m, n, static_cast<const float*>(c),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const int*>(wb), static_cast<const int*>(wa), max_iters,
      feas_tol, cost_tol, pivot_tol, static_cast<float*>(T_scratch),
      static_cast<int*>(status), static_cast<float*>(obj),
      static_cast<float*>(x), static_cast<int*>(basis),
      static_cast<int*>(at_upper), static_cast<int*>(iters));
  return (int)cudaGetLastError();
}

}  // extern "C"
