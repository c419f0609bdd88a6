// The revised-simplex core shared by K2 (revised_simplex.cu, one LP per
// block) and K3 (bb_fragment.cu, a B&B subtree per block): the warm-basis
// rebuild, the basic solution, and the sub-steps of one pivot.  Each
// function is called by every thread of the block; results that all threads
// need come back through shared memory, so the whole block takes the same
// branch.  Every sum runs in index order with each product and each sum
// rounded on its own (__fmul_rn, __fadd_rn), as the plain PyTorch versions
// (simplex_torch.revised_lp_batch_ref, bb_torch.fragment_batch_ref) compute
// them, so kernel and plain version take the same pivots bit for bit.

#pragma once

#include "simplex_common.cuh"

namespace {

// A lane's revised-simplex state.  W is the shared system (m x nc, global);
// c, lo and hi the lane's costs and the bounds its pricing sees; BI its
// basis inverse (m x m); the m-vectors and the per-column flags as named.
struct RevLane {
  int m, n, nc;
  const float* W;
  const float* c;
  const float* lo;
  const float* hi;
  float* BI;
  float* xB;
  float* bl;
  float* bh;
  float* cB;
  float* cB1;     // phase-1 basic costs
  float* y;       // c_B^T B^-1; W z_N at the start
  float* alpha;   // entering column; the rebuild's pivot column
  float* ratio;   // each row's phase-1 infeasibility, then its ratio
  float* rowdiv;  // pivot row of B^-1 over the pivot
  float* wq;      // W[:, q]; the rebuild's pivot row of P1 over the pivot
  int* basis;
  int* hits_up;
  unsigned char* inb;
  unsigned char* atup;
  Scratch* red;
};

// One pivot's outcome, the same in every thread.
struct RevStep {
  int status;  // RUNNING, or the status the pivot found
  int q;       // entering column
  int r;       // leaving row
  bool do_pivot;
  bool do_flip;
};

// Warm start: gather the basis columns W[:, wb[t]] into P1 (m x m) and turn
// [P1 | -I] (BI holds -I on entry) into [I | -B^-1] by Gauss-Jordan, each
// step on the (unassigned row, remaining entry) of largest |P1|, the first
// in row-major order on ties; row r of the winner is assigned to column
// wb[t].  A remainder with no entry above GJ_PIVOT_TOL is a singular basis:
// returns false and the caller starts cold.  On success BI holds B^-1 and
// basis the rebuilt basis.
__device__ bool rev_warm_rebuild(const RevLane& L, const int* wb, float* P1,
                                 unsigned char* unassigned,
                                 unsigned char* remaining) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = L.m, nc = L.nc, mm = m * m;
  for (int e = tid; e < mm; e += nt) {
    const int j = e / m, t = e - (e / m) * m;
    const int w = wb[t];
    P1[e] = (w >= 0 && w < nc) ? L.W[(size_t)j * nc + w] : 0.0f;
  }
  for (int i = tid; i < m; i += nt) {
    unassigned[i] = 1;
    remaining[i] = 1;
  }
  __syncthreads();
  bool ok = true;
  for (int step = 0; step < m; ++step) {
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int e = tid; e < mm; e += nt) {
      const int i = e / m, t = e - (e / m) * m;
      const float s = (unassigned[i] && remaining[t]) ? fabsf(P1[e]) : 0.0f;
      if (beats(s, e, best, arg)) {
        best = s;
        arg = e;
      }
    }
    block_argmax(best, arg, L.red);
    if (!(best > GJ_PIVOT_TOL)) {
      ok = false;
      break;
    }
    const int r = arg / m, tb = arg - (arg / m) * m;
    const float piv = P1[arg];
    for (int i = tid; i < m; i += nt) {
      L.alpha[i] = P1[i * m + tb];
      L.wq[i] = P1[r * m + i] / piv;
      L.rowdiv[i] = L.BI[r * m + i] / piv;
    }
    __syncthreads();
    for (int e = tid; e < mm; e += nt) {
      const int i = e / m, j = e - (e / m) * m;
      const float cv = i == r ? piv - 1.0f : L.alpha[i];
      P1[e] = __fsub_rn(P1[e], __fmul_rn(cv, L.wq[j]));
      L.BI[e] = __fsub_rn(L.BI[e], __fmul_rn(cv, L.rowdiv[j]));
    }
    __syncthreads();
    if (tid == 0) {
      L.basis[r] = wb[tb];
      unassigned[r] = 0;
      remaining[tb] = 0;
    }
    __syncthreads();
  }
  // [I | -B^-1] gives B^-1; a singular basis starts cold (B = -I)
  for (int e = tid; e < mm; e += nt) {
    const int i = e / m;
    L.BI[e] = ok ? -L.BI[e] : ((e - i * m) == i ? -1.0f : 0.0f);
  }
  if (!ok)
    for (int i = tid; i < m; i += nt) L.basis[i] = L.n + i;
  return ok;
}

// The basic solution xB = -B^-1 (W z) of the nonbasic values z (nc).
__device__ void rev_basic_solution(const RevLane& L, const float* z) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = L.m, nc = L.nc;
  for (int j = tid; j < m; j += nt) {  // y = W z_N
    float acc = 0.0f;
    for (int k = 0; k < nc; ++k)
      acc = __fadd_rn(acc, __fmul_rn(L.W[(size_t)j * nc + k], z[k]));
    L.y[j] = acc;
  }
  __syncthreads();
  for (int i = tid; i < m; i += nt) {  // xB = -B^-1 (W z_N)
    float acc = 0.0f;
    for (int k = 0; k < m; ++k)
      acc = __fadd_rn(acc, __fmul_rn(L.BI[i * m + k], L.y[k]));
    L.xB[i] = -acc;
  }
  __syncthreads();
}

// Phase-1 infeasibility of the basic solution: each row's share in ratio[]
// (until the ratio test overwrites it), the phase-1 costs in cB1[], and
// their in-order sum, returned to every thread through *s_sum.
__device__ float rev_infeasibility(const RevLane& L, float feas_tol,
                                   float* s_sum) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L.m; i += nt) {
    const float x = L.xB[i], l = L.bl[i], h = L.bh[i];
    const bool below = x < l - feas_tol, above = x > h + feas_tol;
    L.ratio[i] = __fadd_rn(below ? l - x : 0.0f, above ? x - h : 0.0f);
    L.cB1[i] = below ? -1.0f : (above ? 1.0f : 0.0f);
  }
  __syncthreads();
  if (tid == 0) *s_sum = seq_sum(L.ratio, L.m);
  __syncthreads();
  return *s_sum;
}

// c_B^T x_B in index order (meaningful in thread 0; the caller reads it
// there).
__device__ float rev_basic_objective(const RevLane& L) {
  float cur = 0.0f;
  for (int i = 0; i < L.m; ++i)
    cur = __fadd_rn(cur, __fmul_rn(L.cB[i], L.xB[i]));
  return cur;
}

// One iteration of the bounded revised simplex after rev_infeasibility:
// pricing, the entering column, the ratio test with bound flips, and the
// step (the rank-1 update of B^-1 and the basis bookkeeping) unless the LP
// ended.  *s_dq is a shared float for the entering column's reduced cost.
__device__ RevStep rev_pivot(const RevLane& L, bool phase1, bool bland,
                             float feas_tol, float cost_tol, float pivot_tol,
                             float* s_dq) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = L.m, nc = L.nc, mm = m * m;
  const float* W = L.W;
  const float* c = L.c;
  const float* lo = L.lo;
  const float* hi = L.hi;
  float* BI = L.BI;
  float* xB = L.xB;
  float* bl = L.bl;
  float* bh = L.bh;
  const float* cBe = phase1 ? L.cB1 : L.cB;

  // y = cB_eff^T B^-1: one column of B^-1 per thread
  for (int j = tid; j < m; j += nt) {
    float acc = 0.0f;
    for (int i = 0; i < m; ++i)
      acc = __fadd_rn(acc, __fmul_rn(cBe[i], BI[i * m + j]));
    L.y[j] = acc;
  }
  __syncthreads();

  // pricing d = c - y W: one column of W per thread
  float best = -INFINITY, best_d = 0.0f;
  int q = INT_MAX;
  bool any = false;
  for (int j = tid; j < nc; j += nt) {
    float acc = 0.0f;
    for (int k = 0; k < m; ++k)
      acc = __fadd_rn(acc, __fmul_rn(L.y[k], W[(size_t)k * nc + j]));
    float dj = -acc;
    if (!phase1) dj = __fadd_rn(dj, c[j]);
    const bool nb = !L.inb[j], at = L.atup[j] != 0;
    const bool fr = !isfinite(lo[j]) && !isfinite(hi[j]);
    const bool el = nb && (((!at || fr) && dj < -cost_tol) ||
                           ((at || fr) && dj > cost_tol));
    any |= el;
    const float sc = bland ? (el ? -(float)j : -BIG) : (el ? fabsf(dj) : -1.0f);
    if (beats(sc, j, best, q)) {
      best = sc;
      q = j;
      best_d = dj;
    }
  }
  const int my_q = q;
  const bool any_elig = __syncthreads_or(any);
  block_argmax(best, q, L.red);
  if (my_q == q) *s_dq = best_d;  // the thread that priced column q
  for (int k = tid; k < m; k += nt) L.wq[k] = W[(size_t)k * nc + q];
  __syncthreads();

  // entering column alpha = B^-1 W[:, q] and the ratio test: one row per
  // thread
  const float dq = *s_dq;
  const bool fr_q = !isfinite(lo[q]) && !isfinite(hi[q]);
  const bool up_q = !L.inb[q] && (!L.atup[q] || fr_q) && dq < -cost_tol;
  const float sigma = up_q ? 1.0f : -1.0f;
  float rpart = INFINITY;
  for (int i = tid; i < m; i += nt) {
    float a = 0.0f;
    for (int k = 0; k < m; ++k)
      a = __fadd_rn(a, __fmul_rn(BI[i * m + k], L.wq[k]));
    L.alpha[i] = a;
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
    L.ratio[i] = rt;
    L.hits_up[i] = hu;
    rpart = fminf(rpart, rt);
  }
  const float rmin = block_min(rpart, L.red);
  float pbest = -INFINITY;
  int r = INT_MAX;
  for (int i = tid; i < m; i += nt) {
    const bool tied = L.ratio[i] <= rmin + feas_tol;
    const float pk = bland ? (tied ? -(float)L.basis[i] : -BIG)
                           : (tied ? fabsf(L.alpha[i]) : -1.0f);
    if (beats(pk, i, pbest, r)) {
      pbest = pk;
      r = i;
    }
  }
  block_argmax(pbest, r, L.red);

  // the step, decided identically by every thread from shared state
  const float lo_q = lo[q], hi_q = hi[q];
  const bool flo_q = isfinite(lo_q), fhi_q = isfinite(hi_q);
  const float lo_q0 = flo_q ? lo_q : 0.0f, hi_q0 = fhi_q ? hi_q : 0.0f;
  const float flip_theta = (flo_q && fhi_q) ? hi_q0 - lo_q0 : INFINITY;
  const bool row_blocks = rmin < flip_theta;
  const float theta = row_blocks ? L.ratio[r] : flip_theta;
  int new_status = RUNNING;
  if (!any_elig)
    new_status = phase1 ? INFEASIBLE : OPTIMAL;
  else if (!isfinite(theta))
    new_status = phase1 ? INFEASIBLE : UNBOUNDED;
  const bool stepping = new_status == RUNNING;
  const bool do_pivot = stepping && row_blocks;
  const bool do_flip = stepping && !row_blocks;
  const bool atq = L.atup[q] != 0;
  const float piv = L.alpha[r];
  const int p_col = L.basis[r];
  const bool leave_up = L.hits_up[r] != 0;

  if (do_pivot) {
    // product-form update: divide by safe_piv, eliminate with piv - 1
    const float safe_piv = fabsf(piv) > PIVOT_FLOOR ? piv : 1.0f;
    for (int j = tid; j < m; j += nt) L.rowdiv[j] = BI[r * m + j] / safe_piv;
    __syncthreads();
    for (int e = tid; e < mm; e += nt) {
      const int i = e / m, j = e - (e / m) * m;
      const float cv = i == r ? piv - 1.0f : L.alpha[i];
      BI[e] = __fsub_rn(BI[e], __fmul_rn(cv, L.rowdiv[j]));
    }
  }
  if (do_pivot || do_flip) {
    float zq = atq ? hi_q0 : lo_q0;
    if (!flo_q && !fhi_q) zq = 0.0f;
    for (int i = tid; i < m; i += nt) {
      xB[i] = (do_pivot && i == r)
                  ? __fadd_rn(zq, __fmul_rn(sigma, theta))
                  : __fadd_rn(xB[i], __fmul_rn(-sigma * L.alpha[i], theta));
    }
  }
  __syncthreads();  // every thread is done with basis[r], atup[q], ...
  if (tid == 0) {
    if (do_flip) L.atup[q] = !atq;
    if (do_pivot) {
      L.atup[p_col] = leave_up;
      L.inb[p_col] = 0;
      L.inb[q] = 1;
      L.basis[r] = q;
      const float lb = flo_q ? lo_q : -BIG, hb = fhi_q ? hi_q : BIG;
      bl[r] = lb <= -BIG / 2 ? -INFINITY : lb;
      bh[r] = hb >= BIG / 2 ? INFINITY : hb;
      L.cB[r] = c[q];
    }
  }
  __syncthreads();
  return RevStep{new_status, q, r, do_pivot, do_flip};
}

}  // namespace
