// K3 on Hopper: batched branch-and-bound fragments, a depth-first B&B
// subtree of up to F nodes per block.
//
// Replaces moip_aira_tpu/solver/pallas_bb.py::make_pallas_bb_batch (the
// Pallas TPU kernel).  Its plain PyTorch version, which the tests and
// chip_smoke.py hold this kernel against, is
// moip_aira_tpu_torch/solver/bb_torch.py::fragment_batch_ref.
//
// What it computes, per lane: from the root box (c, lo, hi) and an optional
// warm root basis, a depth-first walk that solves each node's LP relaxation
// with K2's revised simplex (revised_core.cuh: the rebuild, the basic
// solution, pricing, the ratio test, the rank-1 update of B^-1), carrying
// B^-1 from node to node.  Each tick is one step of the lane's state
// machine, in this order: restart (xB = -B^-1 (W z_N) for a fresh node),
// one pivot, the node transition (log the record, then prune, adopt a leaf
// or branch on the most fractional basic integer column), one backtrack
// pop.  Every node is logged (8 scalars, the basis, the at-upper flags
// packed 32 to an int32 word) for the host audit (solver/bb_audit.py), which
// replays the walk and certifies every claim in f64: the kernel speculates
// in f32, the audit is the proof.  The decisions follow pallas_bb.py: the
// noise-stall and phase-1 stall exits, the per-node cap node_iters, the
// integral-objective bound ceil(objv - 1e-4), most-fractional branching with
// the nearer child first, the depth limit D - 1 and the node budget
// par[2]; a singular warm root starts cold (the rule of K2's rebuild).
//
// What bounds it on this card: a node's pivots, as in K2 (per pivot m * nc
// multiply-adds of pricing against the L2-resident W plus about 3 m^2 on
// B^-1), and the serial parts of a tick: thread 0 runs the mode decision,
// the node transition (objective sums over m and nc terms, the
// most-fractional scan) and the stack, and every section ends at a block
// barrier.  What the design does about it: one block per lane, so a lane
// walks its own tree and leaves when done, and only filled lanes launch (no
// lock step across lanes, unlike the TPU's chunk loop); B^-1, the warm block
// P1, the node bounds and the flags sit in shared memory when they fit
// (2AP40: about 80 KB), B^-1 alone when only it fits, else a global scratch
// slice per lane: one template parameter chosen by shape; the stack, the
// m-vectors and the lane's scalars are always in shared memory; the records
// go straight to global memory.  Thread 0 decides each tick's mode and
// writes it to shared memory before a barrier, so the whole block takes the
// same branch.  Every sum is taken in index order with __fmul_rn/__fadd_rn,
// exactly as the plain version sums it, so both walk the same tree bit for
// bit.  Tensor-core pricing, several lanes per block and TMA are not used
// yet.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbb_fragment.so bb_fragment.cu

#include "revised_core.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr float INT_TOL = 1e-4f;

constexpr int ACT_BRANCH = 0;
constexpr int ACT_PRUNE = 1;
constexpr int ACT_INFEAS = 2;
constexpr int ACT_LEAF = 3;
constexpr int ACT_ITERLIM = 4;

constexpr int MODE_PIVOT = 0;
constexpr int MODE_TRANS = 1;
constexpr int MODE_BACK = 2;
constexpr int MODE_DONE = 3;

constexpr int LS_EXHAUSTED = 0;
constexpr int LS_BUDGET = 1;
constexpr int LS_TICKS = 3;

constexpr int N_FIELDS = 8;  // F_STATUS .. F_PHASE1, as bb_torch.py
constexpr int PACK = 32;     // at-upper columns per int32 word
constexpr int ROW_VECTORS = 11;  // float vectors of m entries per lane

size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }
size_t square_bytes(int m) { return sizeof(float) * (size_t)m * m; }
// the node bounds clo/chi (f32) and the flags inb/atup (bytes)
size_t column_bytes(int nc) { return (2 * sizeof(float) + 2) * (size_t)nc; }

// LAYOUT 2: B^-1, P1, the node bounds and the flags in shared memory; 1:
// B^-1 in shared memory, the rest in the global scratch; 0: all of them in
// the global scratch.  The m-vectors, the stack and the rebuild's masks are
// always in shared memory.
size_t bb_smem_bytes(int layout, int m, int nc, int D) {
  size_t b = sizeof(float) * (ROW_VECTORS * (size_t)m + 3 * (size_t)D) +
             sizeof(int) * (2 * (size_t)m + D) + 2 * (size_t)D + 2 * (size_t)m;
  if (layout >= 1) b += square_bytes(m);
  if (layout == 2) b += square_bytes(m) + column_bytes(nc);
  return round16(b);
}

// per-lane global scratch: the nonbasic values z (nc f32), then whatever
// the layout keeps out of shared memory
size_t bb_scratch_bytes(int layout, int m, int nc) {
  size_t b = sizeof(float) * (size_t)nc;
  if (layout < 1) b += square_bytes(m);
  if (layout < 2) b += square_bytes(m) + column_bytes(nc);
  return round16(b);
}

// word w of the packed at-upper flags: bit k is column PACK * w + k
__device__ __forceinline__ int pack_word(const unsigned char* atup, int nc,
                                         int w) {
  unsigned v = 0u;
  for (int k = 0; k < PACK; ++k) {
    const int j = PACK * w + k;
    if (j < nc && atup[j]) v |= 1u << k;
  }
  return (int)v;
}

template <int LAYOUT>
// the register budget of one 512-thread block an SM (128 a thread)
__global__ void __launch_bounds__(MAX_THREADS, 1)
    bb_fragment_kernel(const float* __restrict__ W,
                       const float* __restrict__ intm, int m, int n,
                       const float* __restrict__ c_g,
                       const float* __restrict__ lo_g,
                       const float* __restrict__ hi_g,
                       const float* __restrict__ par_g,
                       const int* __restrict__ wb_g,
                       const int* __restrict__ wa_g, int F, int D,
                       int node_iters, int max_ticks, int stall_exit,
                       int p1_stall, float feas_tol, float cost_tol,
                       float pivot_tol, unsigned char* __restrict__ scratch_g,
                       long long lane_scratch, float* __restrict__ best_o,
                       float* __restrict__ bestx_o, int* __restrict__ nlog_o,
                       int* __restrict__ lstate_o, int* __restrict__ iters_o,
                       int* __restrict__ ticks_o, float* __restrict__ lgs_o,
                       int* __restrict__ lgb_o, int* __restrict__ lga_o,
                       int* __restrict__ fb_o, int* __restrict__ fa_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ RevScratch rs;
  __shared__ int s_mode, s_lpstat, s_restart, s_stall, s_niter, s_titer,
      s_ticks, s_ncnt, s_depth, s_lstate, s_rec, s_adopt;
  __shared__ float s_lobj, s_best, s_sum;

  const int nc = n + m;
  const int pw = (nc + PACK - 1) / PACK;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane_off = (size_t)b * nc;
  const int mm = m * m;
  const float* c = c_g + lane_off;
  const float* par = par_g + (size_t)b * 4;
  const int* wb = wb_g + (size_t)b * m;

  // ---- memory: floats, then ints, then bytes -----------------------------
  unsigned char* gs = scratch_g + (size_t)b * (size_t)lane_scratch;
  float* z = reinterpret_cast<float*>(gs);  // nonbasic values
  gs += sizeof(float) * nc;
  float* sp = reinterpret_cast<float*>(smem_raw);
  float* BI;
  float* P1;
  float* clo;  // the node's bounds
  float* chi;
  if (LAYOUT >= 1) {
    BI = sp;
    sp += mm;
  } else {
    BI = reinterpret_cast<float*>(gs);
    gs += sizeof(float) * mm;
  }
  if (LAYOUT == 2) {
    P1 = sp;
    sp += mm;
    clo = sp;
    sp += nc;
    chi = sp;
    sp += nc;
  } else {
    P1 = reinterpret_cast<float*>(gs);
    gs += sizeof(float) * mm;
    clo = reinterpret_cast<float*>(gs);
    gs += sizeof(float) * nc;
    chi = reinterpret_cast<float*>(gs);
    gs += sizeof(float) * nc;
  }
  float* xB = sp;
  sp += m;
  float* bl = sp;
  sp += m;
  float* bh = sp;
  sp += m;
  float* cB = sp;
  sp += m;
  float* cB1 = sp;
  sp += m;
  float* y = sp;
  sp += m;
  float* alpha = sp;
  sp += m;
  float* ratio = sp;
  sp += m;
  float* rowdiv = sp;
  sp += m;
  float* wq = sp;
  sp += m;
  float* cIb = sp;  // integrality of each basic column
  sp += m;
  float* st_fl = sp;  // the stack: branching floor, old bounds
  sp += D;
  float* st_ol = sp;
  sp += D;
  float* st_oh = sp;
  sp += D;
  int* ip = reinterpret_cast<int*>(sp);
  int* basis = ip;
  ip += m;
  int* hits_up = ip;
  ip += m;
  int* st_j = ip;  // the stack: branching column
  ip += D;
  unsigned char* bp = reinterpret_cast<unsigned char*>(ip);
  unsigned char* inb;
  unsigned char* atup;
  if (LAYOUT == 2) {
    inb = bp;
    bp += nc;
    atup = bp;
    bp += nc;
  } else {
    inb = gs;
    gs += nc;
    atup = gs;
    gs += nc;
  }
  unsigned char* st_state = bp;  // 1 = the second child is under way
  bp += D;
  unsigned char* st_dir = bp;  // 1 = the down child went first
  bp += D;
  unsigned char* unassigned = bp;
  bp += m;
  unsigned char* remaining = bp;

  const RevLane L{m,  n,   nc,    W,     c,      clo, chi,   BI,
                  xB, bl,  bh,    cB,    cB1,    y,   alpha, ratio,
                  rowdiv, wq, basis, hits_up, inb, atup, &rs};

  // the node bounds change on one column at a time: thread 0 writes them
  // and their basic-row mirrors
  auto set_bounds = [&](int j, float nlo, float nhi) {
    clo[j] = nlo;
    chi[j] = nhi;
    for (int i = 0; i < m; ++i)
      if (basis[i] == j) {
        bl[i] = nlo;
        bh[i] = nhi;
      }
  };

  // ---- init: the root basis, warm by K2's rebuild ------------------------
  const bool active = par[3] > 0.5f;
  const bool obj_int = par[1] > 0.5f;
  const float budget = par[2];
  const float eps_l = obj_int ? 1e-6f : 1e-9f;
  for (int j = tid; j < nc; j += nt) {
    clo[j] = lo_g[lane_off + j];
    chi[j] = hi_g[lane_off + j];
  }
  for (int e = tid; e < mm; e += nt) {
    const int i = e / m;
    BI[e] = (e - i * m) == i ? -1.0f : 0.0f;
  }
  for (int i = tid; i < m; i += nt) basis[i] = n + i;
  __syncthreads();
  bool use_warm = false;
  if (wb[0] >= 0) use_warm = rev_warm_rebuild(L, wb, P1, unassigned, remaining);
  __syncthreads();
  for (int j = tid; j < nc; j += nt) inb[j] = 0;
  __syncthreads();
  for (int i = tid; i < m; i += nt) inb[basis[i]] = 1;
  __syncthreads();
  for (int j = tid; j < nc; j += nt) {
    if (use_warm)
      atup[j] = (wa_g[lane_off + j] > 0) && !inb[j];
    else
      atup[j] = (j < n) && !isfinite(clo[j]) && isfinite(chi[j]) && !inb[j];
  }
  for (int i = tid; i < m; i += nt) {
    const int col = basis[i];
    const float l = clo[col], h = chi[col];
    // the reference's sentinels: +-inf read as +-BIG, then back
    const float ls = isfinite(l) ? l : (l > 0.0f ? BIG : -BIG);
    const float hs = isfinite(h) ? h : (h > 0.0f ? BIG : -BIG);
    bl[i] = ls <= -BIG ? -INFINITY : ls;
    bh[i] = hs >= BIG ? INFINITY : hs;
    cB[i] = c[col];
    cIb[i] = intm[col];
    xB[i] = 0.0f;
  }
  if (tid == 0) {
    s_best = par[0];
    s_mode = active ? MODE_PIVOT : MODE_DONE;
    s_lstate = active ? LS_TICKS : LS_EXHAUSTED;
    s_restart = active;
    s_lpstat = RUNNING;
    s_lobj = INFINITY;
    s_stall = s_niter = s_titer = s_ticks = s_ncnt = s_depth = 0;
  }
  __syncthreads();

  for (int tick = 0; tick < max_ticks; ++tick) {
    if (s_mode == MODE_DONE) break;
    if (tid == 0) s_ticks += 1;

    // ---- 1. restart: the LP of a fresh node -------------------------------
    if (s_restart) {
      bool emp = false;
      for (int j = tid; j < nc; j += nt) {
        z[j] = nonbasic_value(inb[j], atup[j], clo[j], chi[j]);
        emp |= clo[j] > chi[j] + feas_tol;
      }
      emp = __syncthreads_or(emp);
      rev_basic_solution(L, z);
      if (tid == 0) {
        s_lpstat = emp ? INFEASIBLE : RUNNING;
        s_mode = emp ? MODE_TRANS : MODE_PIVOT;
        s_niter = 0;
        s_stall = 0;
        s_lobj = INFINITY;
        s_restart = 0;
      }
      __syncthreads();
    }

    // ---- 2. one simplex pivot for PIVOT lanes -----------------------------
    // (phase 1 of the current xB is logged by a transition in this tick)
    float infeas_sum = 0.0f;
    bool phase1 = false;
    if (s_mode != MODE_BACK) {
      infeas_sum = rev_infeasibility(L, feas_tol, &s_sum);
      phase1 = infeas_sum > feas_tol;
    }
    if (s_mode == MODE_PIVOT && s_lpstat == RUNNING) {
      const RevStep st =
          rev_pivot<false>(L, rev_whole(L), phase1, s_stall >= STALL_LIMIT,
                           feas_tol, cost_tol, pivot_tol, 0, false);
      if (tid == 0) {
        if (st.do_pivot) cIb[st.r] = intm[st.q];
        const float cur = phase1 ? infeas_sum : rev_basic_objective(L);
        s_stall = cur < s_lobj - 1e-9f ? 0 : s_stall + 1;
        s_lobj = cur;
        s_niter += 1;
        s_titer += 1;
        int lp = st.status;
        // noise-stall exit: phase-2 pivots without progress sit on the
        // optimal face; claim OPTIMAL for the audit to check
        if (lp == RUNNING && !phase1 && s_stall >= stall_exit) lp = OPTIMAL;
        if (p1_stall > 0 && lp == RUNNING && phase1 && s_stall >= p1_stall)
          lp = ITER_LIMIT;
        if (lp == RUNNING && s_niter >= node_iters) lp = ITER_LIMIT;
        s_lpstat = lp;
        if (lp != RUNNING) s_mode = MODE_TRANS;
      }
      __syncthreads();
    }

    // ---- 3. node transition -----------------------------------------------
    if (s_mode == MODE_TRANS) {
      for (int j = tid; j < nc; j += nt)
        z[j] = nonbasic_value(inb[j], atup[j], clo[j], chi[j]);
      __syncthreads();
      if (tid == 0) {
        float s2 = 0.0f;
        for (int j = 0; j < nc; ++j) s2 = __fadd_rn(s2, __fmul_rn(c[j], z[j]));
        const float objv = __fadd_rn(rev_basic_objective(L), s2);
        // UNBOUNDED in a node of a bounded MIP is f32 trouble: the host
        // re-opens the node
        const int lst = s_lpstat == UNBOUNDED ? ITER_LIMIT : s_lpstat;
        const float bnd = obj_int ? ceilf(__fsub_rn(objv, INT_TOL)) : objv;
        // the most fractional basic integer column, the first on ties (a
        // NaN counts as the largest, as torch.argmax counts it)
        float frmax = -INFINITY;
        int rstar = 0;
        for (int i = 0; i < m; ++i) {
          const float x = xB[i];
          const float fr = __fmul_rn(fabsf(__fsub_rn(x, rintf(x))), cIb[i]);
          if (fr > frmax || (isnan(fr) && !isnan(frmax))) {
            frmax = fr;
            rstar = i;
          }
        }
        const int jbr = basis[rstar];
        const float xval = xB[rstar];
        const float fl = floorf(__fadd_rn(xval, INT_TOL));
        int act;
        if (lst == INFEASIBLE)
          act = ACT_INFEAS;
        else if (lst == ITER_LIMIT)
          act = ACT_ITERLIM;
        else if (bnd >= __fsub_rn(s_best, eps_l))
          act = ACT_PRUNE;
        else if (frmax <= INT_TOL)
          act = ACT_LEAF;
        else
          act = ACT_BRANCH;
        // depth-limited branches: the host re-opens the node
        if (act == ACT_BRANCH && s_depth >= D - 1) act = ACT_ITERLIM;
        const bool down_first = __fsub_rn(xval, fl) <= 0.5f;

        const int rec = s_ncnt;
        if (rec < F) {
          float* o = lgs_o + ((size_t)b * F + rec) * N_FIELDS;
          o[0] = (float)lst;
          o[1] = objv;
          o[2] = (float)jbr;
          o[3] = fl;
          o[4] = down_first ? 1.0f : 0.0f;
          o[5] = (float)act;
          o[6] = (float)s_niter;
          o[7] = phase1 ? 1.0f : 0.0f;
        }
        s_rec = rec < F ? rec : -1;
        s_ncnt = rec + 1;

        // leaf adoption
        s_adopt = act == ACT_LEAF && objv < __fsub_rn(s_best, eps_l);
        if (s_adopt) s_best = objv;

        // descend on branch: push, then the first child's bounds (down:
        // x_j <= fl, up: x_j >= fl + 1)
        const bool br = act == ACT_BRANCH;
        if (br) {
          const int d = s_depth;
          const float ol = clo[jbr], oh = chi[jbr];
          st_j[d] = jbr;
          st_fl[d] = fl;
          st_ol[d] = ol;
          st_oh[d] = oh;
          st_state[d] = 0;
          st_dir[d] = down_first;
          if (down_first)
            set_bounds(jbr, ol, fl);
          else
            set_bounds(jbr, __fadd_rn(fl, 1.0f), oh);
          s_depth = d + 1;
        }
        if ((float)s_ncnt >= budget) {
          s_mode = MODE_DONE;
          s_lstate = LS_BUDGET;
        } else if (br) {
          s_mode = MODE_PIVOT;
          s_restart = 1;
        } else {
          s_mode = MODE_BACK;
        }
      }
      __syncthreads();
      // the record's basis and at-upper flags; the adopted leaf's point
      const int rec = s_rec;
      if (rec >= 0) {
        const size_t r0 = (size_t)b * F + rec;
        for (int i = tid; i < m; i += nt) lgb_o[r0 * m + i] = basis[i];
        for (int w = tid; w < pw; w += nt) lga_o[r0 * pw + w] = pack_word(atup, nc, w);
      }
      if (s_adopt) {
        for (int j = tid; j < nc; j += nt) bestx_o[lane_off + j] = z[j];
        __syncthreads();
        for (int i = tid; i < m; i += nt) bestx_o[lane_off + basis[i]] = xB[i];
      }
      __syncthreads();
    }

    // ---- 4. one backtrack pop ---------------------------------------------
    if (s_mode == MODE_BACK) {
      __syncthreads();  // every thread has read s_mode before thread 0 writes
      if (tid == 0) {
        if (s_depth == 0) {
          s_mode = MODE_DONE;
          s_lstate = LS_EXHAUSTED;
        } else {
          const int t = s_depth - 1;
          if (st_state[t]) {  // both children done: restore and pop
            set_bounds(st_j[t], st_ol[t], st_oh[t]);
            s_depth = t;
          } else {  // the sibling: down first => up, up first => down
            if (st_dir[t])
              set_bounds(st_j[t], __fadd_rn(st_fl[t], 1.0f), st_oh[t]);
            else
              set_bounds(st_j[t], st_ol[t], st_fl[t]);
            st_state[t] = 1;
            s_restart = 1;
            s_mode = MODE_PIVOT;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- outputs (a lane stopped by ticks keeps LS_TICKS) --------------------
  __syncthreads();
  for (int i = tid; i < m; i += nt) fb_o[(size_t)b * m + i] = basis[i];
  for (int w = tid; w < pw; w += nt) fa_o[(size_t)b * pw + w] = pack_word(atup, nc, w);
  if (tid == 0) {
    best_o[b] = s_best;
    nlog_o[b] = s_ncnt;
    lstate_o[b] = s_lstate;
    iters_o[b] = s_titer;
    ticks_o[b] = s_ticks;
  }
}

}  // namespace

extern "C" {

// Where a lane's B^-1, warm block P1, node bounds and flags live for an LP
// of m rows and n structural columns with a stack of D entries: 2 all in
// shared memory, 1 B^-1 in shared memory and the rest in the global
// scratch, 0 all in the global scratch, -1 when even the m-vectors and the
// stack do not fit (the kernel cannot take the shape).
int bb_fragment_layout(int m, int n, int D) {
  const int nc = n + m;
  const size_t cap = (size_t)max_dynamic_smem();
  for (int layout = 2; layout >= 0; --layout)
    if (bb_smem_bytes(layout, m, nc, D) <= cap) return layout;
  return -1;
}

// Bytes of global scratch one lane needs in ``layout``.
long long bb_fragment_scratch_bytes(int layout, int m, int n) {
  return (long long)bb_scratch_bytes(layout, m, n + m);
}

// Launches one block per lane on `stream`; returns cudaGetLastError() after
// the launch (0 on success).  All pointers are device pointers: W (m, n+m)
// f32, intm (n+m) f32 integrality flags (0 on the logical columns), c/lo/hi
// (batch, n+m) f32, par (batch, 4) f32, wb (batch, m) i32 with -1 = cold,
// wa (batch, n+m) i32; scratch (batch * bb_fragment_scratch_bytes) bytes;
// outputs best (batch) f32, bestx (batch, n+m) f32, nlog/lstate/iters/ticks
// (batch) i32, lg_scal (batch, F, 8) f32, lg_basis (batch, F, m) i32,
// lg_atup (batch, F, PW) i32, fin_basis (batch, m) i32, fin_atup (batch, PW)
// i32, PW = ceil((n+m) / 32).  bestx and the three logs must come in
// zeroed: the kernel writes only adopted points and logged records.
int bb_fragment_launch(const void* W, const void* intm, int m, int n,
                       int batch, const void* c, const void* lo,
                       const void* hi, const void* par, const void* wb,
                       const void* wa, int F, int D, int node_iters,
                       int max_ticks, int stall_exit, int p1_stall,
                       float feas_tol, float cost_tol, float pivot_tol,
                       void* scratch, void* best, void* bestx, void* nlog,
                       void* lstate, void* iters, void* ticks, void* lg_scal,
                       void* lg_basis, void* lg_atup, void* fin_basis,
                       void* fin_atup, void* stream) {
  if (batch <= 0) return 0;
  const int nc = n + m;
  const int layout = bb_fragment_layout(m, n, D);
  if (layout < 0 || scratch == nullptr || F <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = bb_smem_bytes(layout, m, nc, D);
  int threads = ((nc + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  auto kern = layout == 2   ? bb_fragment_kernel<2>
              : layout == 1 ? bb_fragment_kernel<1>
                            : bb_fragment_kernel<0>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<batch, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(intm), m, n,
      static_cast<const float*>(c), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(par),
      static_cast<const int*>(wb), static_cast<const int*>(wa), F, D,
      node_iters, max_ticks, stall_exit, p1_stall, feas_tol, cost_tol,
      pivot_tol, static_cast<unsigned char*>(scratch),
      (long long)bb_scratch_bytes(layout, m, nc), static_cast<float*>(best),
      static_cast<float*>(bestx), static_cast<int*>(nlog),
      static_cast<int*>(lstate), static_cast<int*>(iters),
      static_cast<int*>(ticks), static_cast<float*>(lg_scal),
      static_cast<int*>(lg_basis), static_cast<int*>(lg_atup),
      static_cast<int*>(fin_basis), static_cast<int*>(fin_atup));
  return (int)cudaGetLastError();
}

}  // extern "C"
