// The revised-simplex core shared by K2 (revised_simplex.cu, one LP per
// thread-block cluster) and K3 (bb_fragment.cu, a B&B subtree per cluster):
// the warm-basis rebuild, the basic solution, and the sub-steps of one
// pivot.  Each function is called by every thread of the block; results that
// all threads need come back through shared memory or a reduction that hands
// every thread the same value, so the whole block takes the same branch.
// Every sum runs in index order with each product and each sum rounded on
// its own (__fmul_rn, __fadd_rn), as the plain PyTorch versions
// (simplex_torch.revised_lp_batch_ref, bb_torch.fragment_batch_ref) compute
// them, so kernel and plain version take the same pivots bit for bit.
//
// Pricing may be split by columns across the blocks of a cluster
// (RevSplit): each block prices its own column range and the blocks' winners
// are combined through distributed shared memory.  Everything else a pivot
// does is m-sized and every block of the cluster repeats it identically, so
// each block keeps its own B^-1.  K2 and K3 split pricing alike.

#pragma once

#include <cooperative_groups.h>

#include "simplex_common.cuh"

namespace {

namespace cg = cooperative_groups;

// warps of the largest block K2 and K3 launch (512 threads)
constexpr int MAX_REV_WARPS = 16;

// A pricing winner: score, column, its reduced cost, and whether any column
// was eligible.  Also a block's entry in its cluster's mailbox.
struct RevCand {
  float v;
  int i;
  float d;
  int any;
};

// Each warp's partial result of the pivot's three block reductions, one
// array per reduction so that no two consecutive ones share storage; `red`
// serves rev_warm_rebuild.
struct RevScratch {
  Scratch red;
  RevCand pc[MAX_REV_WARPS];  // pricing
  float mv[MAX_REV_WARPS];    // least ratio
  float rv[MAX_REV_WARPS];    // leaving row: score
  int ri[MAX_REV_WARPS];      // leaving row: index
};

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
  float* y;       // c_B^T B^-1; W z_N at the start
  float* alpha;   // entering column; the rebuild's pivot column
  float* ratio;   // each row's phase-1 infeasibility, then its ratio
  float* rowdiv;  // each row's phase-1 cost, then the pivot row of B^-1 / piv
  float* wq;      // W[:, q]; the rebuild's pivot row of P1 over the pivot
  int* basis;
  int* hits_up;
  unsigned char* inb;
  unsigned char* atup;
  RevScratch* rs;
};

// One pivot's outcome, the same in every thread.
struct RevStep {
  int status;  // RUNNING, or the status the pivot found
  int q;       // entering column
  int r;       // leaving row
  bool do_pivot;
  bool do_flip;
};

// This block's share of pricing: the columns [j0, j1) of W, with the slice
// in shared memory (row k at ws + k * ld, column j at j - j0) or, when ws is
// null, read from W.  Block `rank` of a cluster of csize owns columns
// [rank * ld, rank * ld + ld), so column q lives in block q / ld.  `mail`
// is this block's two mailboxes (pivots alternate between them).
struct RevSplit {
  int j0, j1, ld;
  const float* ws;
  int csize;
  RevCand* mail;
};

// ---- reductions that hand every thread the same result -------------------
// Each warp reduces towards lane 0 and broadcasts lane 0's value, so every
// lane holds the same winner; every warp then reduces the same per-warp
// partials the same way.  One barrier each.

__device__ __forceinline__ void warp_cand(RevCand& a) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, a.v, off);
    const int oi = __shfl_down_sync(0xffffffffu, a.i, off);
    const float od = __shfl_down_sync(0xffffffffu, a.d, off);
    const int oa = __shfl_down_sync(0xffffffffu, a.any, off);
    if (beats(ov, oi, a.v, a.i)) {
      a.v = ov;
      a.i = oi;
      a.d = od;
    }
    a.any |= oa;
  }
  a.v = __shfl_sync(0xffffffffu, a.v, 0);
  a.i = __shfl_sync(0xffffffffu, a.i, 0);
  a.d = __shfl_sync(0xffffffffu, a.d, 0);
  a.any = __shfl_sync(0xffffffffu, a.any, 0);
}

__device__ RevCand rev_block_cand(RevCand a, RevCand* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_cand(a);
  if (lane == 0) part[warp] = a;
  __syncthreads();
  RevCand b{-INFINITY, INT_MAX, 0.0f, 0};
  if (lane < nw) b = part[lane];
  warp_cand(b);
  return b;
}

__device__ float rev_block_min(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  v = __shfl_sync(0xffffffffu, v, 0);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float b = lane < nw ? part[lane] : INFINITY;
  for (int off = 16; off > 0; off >>= 1)
    b = fminf(b, __shfl_down_sync(0xffffffffu, b, off));
  return __shfl_sync(0xffffffffu, b, 0);
}

__device__ void rev_block_argmax(float& v, int& i, float* pv, int* pi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    pv[warp] = v;
    pi[warp] = i;
  }
  __syncthreads();
  v = lane < nw ? pv[lane] : -INFINITY;
  i = lane < nw ? pi[lane] : INT_MAX;
  warp_argmax(v, i);
  v = __shfl_sync(0xffffffffu, v, 0);
  i = __shfl_sync(0xffffffffu, i, 0);
}

// The cluster's winner from each block's: every block posts its winner in
// its mailbox, and after the cluster barrier every warp reads the csize
// mailboxes (distributed shared memory) and reduces them alike.  `beats` is
// a total order on (score, column), so this is the whole row's arg-max.
// Two mailboxes alternate: a block posts into one only after the barrier
// of the pivot in between, which every reader of its last contents passed.
__device__ RevCand rev_cluster_cand(RevCand win, const RevSplit& S,
                                    int parity) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) S.mail[parity] = win;
  cluster.sync();
  const int lane = threadIdx.x & 31;
  RevCand b{-INFINITY, INT_MAX, 0.0f, 0};
  if (lane < S.csize)
    b = *cluster.map_shared_rank(S.mail + parity, (unsigned)lane);
  warp_cand(b);
  return b;
}

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
    block_argmax(best, arg, &L.rs->red);
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

// row i's share of the phase-1 infeasibility, and its phase-1 cost
__device__ __forceinline__ float rev_row_infeasibility(const RevLane& L, int i,
                                                       float feas_tol,
                                                       float* cost) {
  const float x = L.xB[i], l = L.bl[i], h = L.bh[i];
  const bool below = x < l - feas_tol, above = x > h + feas_tol;
  *cost = below ? -1.0f : (above ? 1.0f : 0.0f);
  return __fadd_rn(below ? l - x : 0.0f, above ? x - h : 0.0f);
}

// c_B^T x_B in index order (meaningful in thread 0; the caller reads it
// there).
__device__ float rev_basic_objective(const RevLane& L) {
  float cur = 0.0f;
  for (int i = 0; i < L.m; ++i)
    cur = __fadd_rn(cur, __fmul_rn(L.cB[i], L.xB[i]));
  return cur;
}

// What a pivot of K2 and K3 needs before pricing, behind two barriers,
// while the phase is not yet known.  First each row's phase-1 cost (into
// rowdiv) and infeasibility (into ratio; both free until the ratio test),
// one row a thread; then, side by side: y for both phases -- c_B^T B^-1
// into y and the phase-1 costs' y into alpha (free until the entering
// column) -- the in-order phase-1 sum into *s_sum and, when want_obj,
// c_B^T x_B into *s_obj.  Work slot s runs on thread s mod nt: slots
// [0, m) are phase 2's y, slots [mw, mw + m) phase 1's (mw is m rounded up
// to a warp, so that no warp runs a chain of each kind one after the
// other), slot 2 mw the phase-1 sum and slot 2 mw + 32 the objective, so
// with nt >= 2 mw + 64 the four chains run in warps of their own.
// rev_pivot then prices with the y of the phase.
__device__ void rev_pivot_start(const RevLane& L, float feas_tol,
                                bool want_obj, float* s_sum, float* s_obj) {
  const int tid = threadIdx.x, nt = blockDim.x, m = L.m;
  const int mw = 32 * ((m + 31) / 32);
  float* cost = L.rowdiv;
  float* infeas = L.ratio;
  for (int i = tid; i < m; i += nt)
    infeas[i] = rev_row_infeasibility(L, i, feas_tol, &cost[i]);
  __syncthreads();
  for (int s = tid; s < 2 * mw; s += nt) {
    const float* cv = s < m ? L.cB : cost;
    const int j = s < m ? s : s - mw;
    if (s < m || (s >= mw && s < mw + m)) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i)
        acc = __fadd_rn(acc, __fmul_rn(cv[i], L.BI[i * m + j]));
      (s < m ? L.y : L.alpha)[j] = acc;
    }
  }
  if (tid == (2 * mw) % nt) *s_sum = seq_sum(infeas, m);
  if (want_obj && tid == (2 * mw + 32) % nt) *s_obj = rev_basic_objective(L);
  __syncthreads();
}

// Price U columns at once, column base + u * nt of the slice for u < U: U
// independent chains of m multiply-adds, k the outer loop, so the loads and
// adds of U columns are in flight together; each chain sums in index order.
template <int U, bool W_SMEM>
__device__ __forceinline__ void rev_price_cols(const RevLane& L,
                                               const RevSplit& S,
                                               const float* yv, int base,
                                               bool phase1, bool bland,
                                               float cost_tol, RevCand& best) {
  const int nt = blockDim.x, m = L.m;
  // column base + u nt of row k at p0 + k pitch + u nt: one base pointer
  // (an array of per-column pointers went to local memory)
  const float* p0 = W_SMEM ? S.ws + base : L.W + S.j0 + base;
  const int pitch = W_SMEM ? S.ld : L.nc;
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.0f;
  for (int k = 0; k < m; ++k) {
    const float yk = yv[k];
    const float* row = p0 + (size_t)k * pitch;
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc[u] = __fadd_rn(acc[u], __fmul_rn(yk, row[u * nt]));
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = S.j0 + base + u * nt;
    float dj = -acc[u];
    if (!phase1) dj = __fadd_rn(dj, L.c[j]);
    const bool nb = !L.inb[j], at = L.atup[j] != 0;
    const bool fr = !isfinite(L.lo[j]) && !isfinite(L.hi[j]);
    const bool el = nb && (((!at || fr) && dj < -cost_tol) ||
                           ((at || fr) && dj > cost_tol));
    best.any |= el;
    const float sc =
        bland ? (el ? -(float)j : -BIG) : (el ? fabsf(dj) : -1.0f);
    if (beats(sc, j, best.v, best.i)) {
      best.v = sc;
      best.i = j;
      best.d = dj;
    }
  }
}

// This thread's best column of the block's slice against yv: its columns
// tid, tid + nt, ... priced four, then two, then one at a time.
template <bool W_SMEM>
__device__ RevCand rev_price(const RevLane& L, const RevSplit& S,
                             const float* yv, bool phase1, bool bland,
                             float cost_tol) {
  const int nt = blockDim.x;
  const int w = S.j1 - S.j0;
  RevCand best{-INFINITY, INT_MAX, 0.0f, 0};
  int base = threadIdx.x;
  for (; base + 3 * nt < w; base += 4 * nt)
    rev_price_cols<4, W_SMEM>(L, S, yv, base, phase1, bland, cost_tol, best);
  if (base + nt < w) {
    rev_price_cols<2, W_SMEM>(L, S, yv, base, phase1, bland, cost_tol, best);
    base += 2 * nt;
  }
  if (base < w)
    rev_price_cols<1, W_SMEM>(L, S, yv, base, phase1, bland, cost_tol, best);
  return best;
}

// One iteration of the bounded revised simplex after rev_pivot_start:
// pricing (this block's columns, combined across the cluster), the
// entering column, the ratio test with bound flips, and the step (the
// rank-1 update of B^-1 and the basis bookkeeping) unless the LP ended.
// `parity` picks the cluster mailbox (alternate it from pivot to pivot).
// Four block barriers, and one cluster barrier when the cluster has more
// than one block.
template <bool W_SMEM>
__device__ RevStep rev_pivot(const RevLane& L, const RevSplit& S, bool phase1,
                             bool bland, float feas_tol, float cost_tol,
                             float pivot_tol, int parity) {
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
  // rev_pivot_start's y of the phase
  const float* yv = phase1 ? L.alpha : L.y;

  // pricing d = c - y W over this block's columns, then the cluster's winner
  RevCand win = rev_block_cand(
      rev_price<W_SMEM>(L, S, yv, phase1, bland, cost_tol), L.rs->pc);
  if (S.csize > 1) win = rev_cluster_cand(win, S, parity);
  const int q = win.i;
  const float dq = win.d;
  const bool any_elig = win.any != 0;
  // W[:, q] from the slice of the block that owns q, else from W
  if (W_SMEM) {
    const int owner = q / S.ld;
    const float* src = S.ws;
    if (S.csize > 1)
      src = cg::this_cluster().map_shared_rank(const_cast<float*>(S.ws),
                                               (unsigned)owner);
    const int jq = q - owner * S.ld;
    for (int k = tid; k < m; k += nt) L.wq[k] = src[(size_t)k * S.ld + jq];
  } else {
    for (int k = tid; k < m; k += nt) L.wq[k] = W[(size_t)k * nc + q];
  }
  __syncthreads();

  // entering column alpha = B^-1 W[:, q] and the ratio test: one row per
  // thread
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
  const float rmin = rev_block_min(rpart, L.rs->mv);
  // the rows this thread wrote above: no barrier needed to read them
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
  rev_block_argmax(pbest, r, L.rs->rv, L.rs->ri);

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

  // product-form update: divide by safe_piv, eliminate with piv - 1
  const float safe_piv = fabsf(piv) > PIVOT_FLOOR ? piv : 1.0f;
  if (do_pivot)
    for (int j = tid; j < m; j += nt) L.rowdiv[j] = BI[r * m + j] / safe_piv;
  // rowdiv is ready, and every thread has read basis[r], atup[q], ... above,
  // so thread 0's bookkeeping below races with nothing
  __syncthreads();
  if (do_pivot) {
    // element e = i m + j, stepped by nt without a division per element
    const int di = nt / m, dj = nt - (nt / m) * m;
    int i = tid / m, j = tid - (tid / m) * m;
    for (int e = tid; e < mm; e += nt) {
      const float cv = i == r ? piv - 1.0f : L.alpha[i];
      BI[e] = __fsub_rn(BI[e], __fmul_rn(cv, L.rowdiv[j]));
      i += di;
      j += dj;
      if (j >= m) {
        j -= m;
        ++i;
      }
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
