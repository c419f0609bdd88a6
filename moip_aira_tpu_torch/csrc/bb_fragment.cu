// K3 on Hopper: batched branch-and-bound fragments, a depth-first B&B
// subtree of up to F nodes per lane, each lane on a thread-block cluster.
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
// What bounds it on this card: a lane's pivots, one after another, as in K2
// (per pivot m * nc multiply-adds of pricing plus about 3 m^2 on B^-1, as
// serial chains of m dependent adds in index order), and the serial parts
// of a tick; the fragment fronts launch a few tens to a few hundred lanes,
// so most SMs would idle with one block a lane.  What the design does about
// it, after K2's (revised_simplex.cu): a lane runs on a cluster of C blocks
// (1 <= C <= 8) on C SMs.  Block r owns W's columns [r w, r w + w),
// w = ceil(nc / C), loads that slice into its shared memory once per launch
// when it fits (2AP20: all of W at C = 1; 2AP40: 138 KB at C = 4) and
// prices it every pivot; the blocks' winners meet through the core's
// distributed-shared-memory mailboxes (one cluster barrier a pivot; the
// mailbox parity flips on every pivot, in every block alike).  Every block
// repeats all the rest identically on its own copy of the lane's state --
// B^-1, xB, the node bounds and flags, the stack, the tick's mode -- so
// every block takes the same branch at every tick and the cluster leaves
// the tick loop together; block 0 alone writes the records, the adopted
// point and the lane's outputs, and each block keeps its own nonbasic
// values z.  A last cluster barrier keeps every block's shared memory alive
// for its readers.  Inside a block a pivot starts with K2's fused step
// (rev_pivot_start: y for both phases, the phase-1 sum and the objective
// side by side); the objective a phase-2 pivot leaves feeds the stall
// counter at the start of the next pivot, or at once when the noise-stall
// exit may fire.  The restart and the node's closing objective sum W z_N
// and c . z_N over the columns whose z is non-zero, in index order (a zero
// term adds +0 to a sum that is never -0, so the value is the full sum's).
// Shared memory holds, as the plan (solver/cuda_bb.py::bb_launch_plan)
// says and in this order of priority: B^-1, the W slice, the node bounds
// and flags, the warm block P1; the m-vectors, the stack and the lane's
// scalars always; the rest lives in a per-block global scratch slice.
// Every sum is taken in index order with __fmul_rn/__fadd_rn, exactly as
// the plain version sums it, so both walk the same tree bit for bit.
//
// Built with -DBB_TICK_CLOCKS (tools/k3_cluster_bench.py only), block 0 of
// each lane also counts the SM cycles of each part of a tick.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbb_fragment.so bb_fragment.cu

#include "revised_core.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
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
constexpr int ROW_VECTORS = 10;  // float vectors of m entries per lane

#ifdef BB_TICK_CLOCKS
// the parts of a tick: restart, pivot start (y, the phase-1 sum), pivot,
// transition, backtrack; per lane the cycles of each, then their counts
constexpr int N_PARTS = 5;
__device__ unsigned long long* bb_clocks;
#endif

size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }
size_t square_bytes(int m) { return sizeof(float) * (size_t)m * m; }
// the node bounds clo/chi (f32) and the flags inb/atup (bytes)
size_t column_bytes(int nc) { return (2 * sizeof(float) + 2) * (size_t)nc; }
__host__ __device__ int slice_width(int nc, int C) { return (nc + C - 1) / C; }

// What is always in shared memory: the m-vectors, the stack and the
// rebuild's masks.
size_t base_bytes(int m, int D) {
  return sizeof(float) * (ROW_VECTORS * (size_t)m + 3 * (size_t)D) +
         sizeof(int) * (2 * (size_t)m + D) + 2 * (size_t)D + 2 * (size_t)m;
}

// A block's dynamic shared bytes under a plan (solver/cuda_bb.py's
// bb_smem_bytes computes the same).
size_t bb_smem_bytes(int m, int nc, int D, int C, bool bi, bool w, bool col,
                     bool p1) {
  size_t b = base_bytes(m, D);
  if (bi) b += square_bytes(m);
  if (w) b += sizeof(float) * (size_t)m * slice_width(nc, C);
  if (col) b += column_bytes(nc);
  if (p1) b += square_bytes(m);
  return round16(b);
}

// A block's global scratch: the nonbasic values z (nc f32) and the index
// list of their non-zero columns (nc i32), then whatever the plan keeps out
// of shared memory.
size_t bb_scratch_bytes(int m, int nc, bool bi, bool col, bool p1) {
  size_t b = (sizeof(float) + sizeof(int)) * (size_t)nc;
  if (!bi) b += square_bytes(m);
  if (!p1) b += square_bytes(m);
  if (!col) b += column_bytes(nc);
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

// The columns j < nc with z[j] != 0, in ascending order, into idx; returns
// their count to every thread.  Thread t reads only the z[j] it wrote in a
// loop `for (j = t; j < nc; j += nt)`, so z needs no barrier before this.
__device__ int nonzero_columns(const float* z, int nc, int* idx,
                               int* s_warp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  int total = 0;
  for (int base = 0; base < nc; base += nt) {
    const int j = base + tid;
    const bool nz = j < nc && z[j] != 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = total, all = total;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += s_warp[w];
      all += s_warp[w];
    }
    if (nz) idx[before + __popc(mask & ((1u << lane) - 1u))] = j;
    total = all;
    __syncthreads();  // idx complete; s_warp free for the next round
  }
  return total;
}

// xB = -B^-1 (W z_N) over the cnt non-zero columns idx of z, each row's sum
// in index order; W's row j at Wr + j * pitch.
__device__ void basic_solution_nz(const RevLane& L, const float* z,
                                  const int* idx, int cnt, const float* Wr,
                                  int pitch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = L.m;
  for (int j = tid; j < m; j += nt) {  // y = W z_N
    const float* row = Wr + (size_t)j * pitch;
    float acc = 0.0f;
    for (int t = 0; t < cnt; ++t) {
      const int k = idx[t];
      acc = __fadd_rn(acc, __fmul_rn(row[k], z[k]));
    }
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

// BI_S: B^-1 in shared memory; W_S: the block's W slice in shared memory
// (else pricing reads W); COL_S: the node bounds and flags in shared memory;
// p1_smem: the warm block P1 in shared memory.  What is not in shared
// memory lives in the block's global scratch.  Blocks blockIdx.x =
// lane * csize + rank form the lane's cluster.
template <bool BI_S, bool W_S, bool COL_S>
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
                       float pivot_tol, int csize, int p1_smem,
                       unsigned char* __restrict__ scratch_g,
                       long long block_scratch, float* __restrict__ best_o,
                       float* __restrict__ bestx_o, int* __restrict__ nlog_o,
                       int* __restrict__ lstate_o, int* __restrict__ iters_o,
                       int* __restrict__ ticks_o, float* __restrict__ lgs_o,
                       int* __restrict__ lgb_o, int* __restrict__ lga_o,
                       int* __restrict__ fb_o, int* __restrict__ fa_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ RevScratch rs;
  __shared__ RevCand mail[2];
  __shared__ int s_warp[MAX_REV_WARPS];
  __shared__ int s_mode, s_lpstat, s_restart, s_stall, s_niter, s_titer,
      s_ticks, s_ncnt, s_depth, s_lstate, s_rec, s_adopt, s_pend;
  __shared__ float s_lobj, s_best, s_sum, s_obj;

  const int nc = n + m;
  const int pw = (nc + PACK - 1) / PACK;
  const int blk = blockIdx.x;
  const int b = blk / csize, rank = blk - (blk / csize) * csize;
  const bool lead = rank == 0;  // writes the lane's records and outputs
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane_off = (size_t)b * nc;
  const int mm = m * m;
  const float* c = c_g + lane_off;
  const float* par = par_g + (size_t)b * 4;
  const int* wb = wb_g + (size_t)b * m;
  const int width = slice_width(nc, csize);
  const int j0 = min(nc, rank * width), j1 = min(nc, j0 + width);

  // ---- memory: floats, then ints, then bytes -----------------------------
  unsigned char* gs = scratch_g + (size_t)blk * (size_t)block_scratch;
  float* z = reinterpret_cast<float*>(gs);  // nonbasic values
  gs += sizeof(float) * nc;
  int* nzi = reinterpret_cast<int*>(gs);  // z's non-zero columns
  gs += sizeof(int) * nc;
  float* sp = reinterpret_cast<float*>(smem_raw);
  float* BI;
  float* ws = nullptr;
  float* clo;  // the node's bounds
  float* chi;
  float* P1;
  if (BI_S) {
    BI = sp;
    sp += mm;
  } else {
    BI = reinterpret_cast<float*>(gs);
    gs += sizeof(float) * mm;
  }
  if (W_S) {
    ws = sp;
    sp += (size_t)m * width;
  }
  if (COL_S) {
    clo = sp;
    sp += nc;
    chi = sp;
    sp += nc;
  }
  if (p1_smem) {
    P1 = sp;
    sp += mm;
  } else {
    P1 = reinterpret_cast<float*>(gs);
    gs += sizeof(float) * mm;
  }
  if (!COL_S) {
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
  if (COL_S) {
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

  const RevLane L{m,  n,  nc,    W,     c,      clo,    chi,    BI,
                  xB, bl, bh,    cB,    y,      alpha,  ratio,  rowdiv,
                  wq, basis, hits_up, inb, atup, &rs};
  const RevSplit S{j0, j1, width, ws, csize, mail};
  // the restart reads W's rows from shared memory when the block holds all
  // of W
  const float* Wr = (W_S && csize == 1) ? ws : W;
  const int wpitch = (W_S && csize == 1) ? width : nc;

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

  // ---- init: the W slice, the root basis (warm by K2's rebuild) ----------
  if (W_S) {
    const int wr = j1 - j0;
    for (int e = tid; e < m * width; e += nt) {
      const int k = e / width, jj = e - (e / width) * width;
      ws[e] = jj < wr ? W[(size_t)k * nc + j0 + jj] : 0.0f;
    }
  }
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
    s_pend = 0;
    s_stall = s_niter = s_titer = s_ticks = s_ncnt = s_depth = 0;
  }
  __syncthreads();

#ifdef BB_TICK_CLOCKS
  unsigned long long clk[2 * N_PARTS] = {};
  long long t_mark = clock64();
  auto mark = [&](int part) {
    const long long now = clock64();
    clk[part] += (unsigned long long)(now - t_mark);
    clk[N_PARTS + part] += 1;
    t_mark = now;
  };
#define BB_MARK(part) \
  if (tid == 0) mark(part)
#else
#define BB_MARK(part)
#endif

  int parity = 0;  // the cluster mailbox of the next pivot
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
      const int cnt = nonzero_columns(z, nc, nzi, s_warp);
      basic_solution_nz(L, z, nzi, cnt, Wr, wpitch);
      if (tid == 0) {
        s_lpstat = emp ? INFEASIBLE : RUNNING;
        s_mode = emp ? MODE_TRANS : MODE_PIVOT;
        s_niter = 0;
        s_stall = 0;
        s_lobj = INFINITY;
        s_pend = 0;
        s_restart = 0;
      }
      __syncthreads();
      BB_MARK(0);
    }

    // ---- 2. one simplex pivot for PIVOT lanes -----------------------------
    // (phase 1 of the current xB is logged by a transition in this tick)
    float infeas_sum = 0.0f;
    bool phase1 = false;
    if (s_mode != MODE_BACK) {
      // y for both phases, the phase-1 sum and, when the last pivot's
      // objective is pending, c_B^T x_B
      const bool pend = s_pend != 0;
      rev_pivot_start(L, feas_tol, pend, &s_sum, &s_obj);
      infeas_sum = s_sum;
      phase1 = infeas_sum > feas_tol;
      BB_MARK(1);
      if (s_mode == MODE_PIVOT && s_lpstat == RUNNING) {
        // the stall counter with the last pivot's objective
        int stall = s_stall;
        float lobj = s_lobj;
        if (pend) {
          const float cur = s_obj;
          stall = cur < lobj - 1e-9f ? 0 : stall + 1;
          lobj = cur;
        }
        const RevStep st =
            rev_pivot<W_S>(L, S, phase1, stall >= STALL_LIMIT, feas_tol,
                           cost_tol, pivot_tol, parity);
        parity ^= 1;
        if (tid == 0) {
          if (st.do_pivot) cIb[st.r] = intm[st.q];
          int lp = st.status;
          // this pivot's objective: phase 1's is the sum before it; phase
          // 2's waits for the next pivot's start unless the noise-stall
          // exit may fire now (a closed LP's stall counter is never read)
          const bool defer =
              !phase1 && !(lp == RUNNING && stall + 1 >= stall_exit);
          if (!defer) {
            const float cur = phase1 ? infeas_sum : rev_basic_objective(L);
            stall = cur < lobj - 1e-9f ? 0 : stall + 1;
            lobj = cur;
          }
          s_niter += 1;
          s_titer += 1;
          // noise-stall exit: phase-2 pivots without progress sit on the
          // optimal face; claim OPTIMAL for the audit to check
          if (lp == RUNNING && !phase1 && stall >= stall_exit) lp = OPTIMAL;
          if (p1_stall > 0 && lp == RUNNING && phase1 && stall >= p1_stall)
            lp = ITER_LIMIT;
          if (lp == RUNNING && s_niter >= node_iters) lp = ITER_LIMIT;
          s_stall = stall;
          s_lobj = lobj;
          s_pend = defer && lp == RUNNING;
          s_lpstat = lp;
          if (lp != RUNNING) s_mode = MODE_TRANS;
        }
        __syncthreads();
        BB_MARK(2);
      }
    }

    // ---- 3. node transition -----------------------------------------------
    if (s_mode == MODE_TRANS) {
      for (int j = tid; j < nc; j += nt)
        z[j] = nonbasic_value(inb[j], atup[j], clo[j], chi[j]);
      const int cnt = nonzero_columns(z, nc, nzi, s_warp);
      if (tid == 0) {
        float s2 = 0.0f;
        for (int t = 0; t < cnt; ++t) {
          const int j = nzi[t];
          s2 = __fadd_rn(s2, __fmul_rn(c[j], z[j]));
        }
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
        if (lead && rec < F) {
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
      if (lead && rec >= 0) {
        const size_t r0 = (size_t)b * F + rec;
        for (int i = tid; i < m; i += nt) lgb_o[r0 * m + i] = basis[i];
        for (int w = tid; w < pw; w += nt) lga_o[r0 * pw + w] = pack_word(atup, nc, w);
      }
      if (s_adopt) {
        if (lead)
          for (int j = tid; j < nc; j += nt) bestx_o[lane_off + j] = z[j];
        __syncthreads();
        if (lead)
          for (int i = tid; i < m; i += nt) bestx_o[lane_off + basis[i]] = xB[i];
      }
      __syncthreads();
      BB_MARK(3);
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
      BB_MARK(4);
    }
  }
#undef BB_MARK

  // ---- outputs (a lane stopped by ticks keeps LS_TICKS) --------------------
  __syncthreads();
  if (lead) {
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
#ifdef BB_TICK_CLOCKS
  if (lead && tid == 0 && bb_clocks != nullptr)
    for (int k = 0; k < 2 * N_PARTS; ++k)
      bb_clocks[(size_t)b * 2 * N_PARTS + k] = clk[k];
#endif
  // no block leaves while another may still read its shared memory
  if (csize > 1) cg::this_cluster().sync();
}

using BBKernel = decltype(&bb_fragment_kernel<true, true, true>);

// the variant of a plan (W slice and node bounds in shared memory only
// beside B^-1)
BBKernel bb_kernel(bool bi, bool w, bool col, int* variant) {
  if (!bi) {
    *variant = 0;
    return bb_fragment_kernel<false, false, false>;
  }
  *variant = 1 + (w ? 2 : 0) + (col ? 1 : 0);
  if (w)
    return col ? bb_fragment_kernel<true, true, true>
               : bb_fragment_kernel<true, true, false>;
  return col ? bb_fragment_kernel<true, false, true>
             : bb_fragment_kernel<true, false, false>;
}

// The plan's launch configuration, after checking it: 0, or the CUDA error
// the launch would meet.  Each variant's shared-memory limit is raised to
// the card's opt-in once per device, on its first use there.
int bb_config(int m, int n, int D, int batch, int C, int threads, int bi,
              int w, int col, int p1, cudaStream_t stream,
              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
              BBKernel* kern) {
  static bool raised[MAX_DEVICES][5] = {};
  const int nc = n + m;
  if (m <= 0 || n < 0 || D <= 0 || batch <= 0 || C < 1 || C > MAX_CLUSTER ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      (!bi && (w || col || p1)))
    return (int)cudaErrorInvalidValue;
  const int cap = dynamic_smem_cap();
  const size_t bytes = bb_smem_bytes(m, nc, D, C, bi, w, col, p1);
  if (cap <= 0 || bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  int variant = 0;
  *kern = bb_kernel(bi, w, col, &variant);
  const int slot = device_slot();
  if (slot < 0 || !raised[slot][variant]) {
    cudaError_t e = cudaFuncSetAttribute(
        *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (e != cudaSuccess) return (int)e;
    if (slot >= 0) raised[slot][variant] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)batch * C, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" {

// The card's limits the launch plan reads: the dynamic shared bytes a block
// may opt into (the plan sets STATIC_SMEM_RESERVE of them aside for static
// shared memory) and the number of SMs.  Returns 0 or a CUDA error.
int bb_fragment_device_limits(int* smem_optin, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// A block's dynamic shared bytes and global scratch bytes under a plan (for
// the wrapper's check of its own arithmetic).
long long bb_fragment_smem_bytes(int m, int n, int D, int C, int bi, int w,
                                 int col, int p1) {
  return (long long)bb_smem_bytes(m, n + m, D, C, bi, w, col, p1);
}

long long bb_fragment_scratch_bytes(int m, int n, int bi, int col, int p1) {
  return (long long)bb_scratch_bytes(m, n + m, bi, col, p1);
}

// How many clusters of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int bb_fragment_max_clusters(int m, int n, int D, int C, int threads, int bi,
                             int w, int col, int p1) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  BBKernel kern;
  int err = bb_config(m, n, D, 1, C, threads, bi, w, col, p1, 0, &cfg, attr,
                      &kern);
  if (err) return -err;
  int count = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveClusters(&count, (const void*)kern, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// Launches one cluster of C blocks of `threads` threads per lane on
// `stream`, as the wrapper's plan says (bi, w, col, p1: B^-1, the W slice,
// the node bounds and flags, P1 in shared memory); returns 0 on success,
// else the CUDA error (a plan that does not fit is refused before the
// launch).  All pointers are device pointers: W (m, n+m) f32, intm (n+m)
// f32 integrality flags (0 on the logical columns), c/lo/hi (batch, n+m)
// f32, par (batch, 4) f32, wb (batch, m) i32 with -1 = cold, wa (batch,
// n+m) i32; scratch (batch * C * bb_fragment_scratch_bytes) bytes; outputs
// best (batch) f32, bestx (batch, n+m) f32, nlog/lstate/iters/ticks (batch)
// i32, lg_scal (batch, F, 8) f32, lg_basis (batch, F, m) i32, lg_atup
// (batch, F, PW) i32, fin_basis (batch, m) i32, fin_atup (batch, PW) i32,
// PW = ceil((n+m) / 32).  bestx and the three logs must come in zeroed: the
// kernel writes only adopted points and logged records.
int bb_fragment_launch(const void* W, const void* intm, int m, int n,
                       int batch, const void* c, const void* lo,
                       const void* hi, const void* par, const void* wb,
                       const void* wa, int F, int D, int node_iters,
                       int max_ticks, int stall_exit, int p1_stall,
                       float feas_tol, float cost_tol, float pivot_tol, int C,
                       int threads, int bi, int w, int col, int p1,
                       void* scratch, void* best, void* bestx, void* nlog,
                       void* lstate, void* iters, void* ticks, void* lg_scal,
                       void* lg_basis, void* lg_atup, void* fin_basis,
                       void* fin_atup, void* stream) {
  if (batch <= 0) return 0;
  if (scratch == nullptr || F <= 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  BBKernel kern;
  int err = bb_config(m, n, D, batch, C, threads, bi, w, col, p1,
                      static_cast<cudaStream_t>(stream), &cfg, attr, &kern);
  if (err) return err;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(W),
      static_cast<const float*>(intm), m, n, static_cast<const float*>(c),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(par), static_cast<const int*>(wb),
      static_cast<const int*>(wa), F, D, node_iters, max_ticks, stall_exit,
      p1_stall, feas_tol, cost_tol, pivot_tol, C, p1,
      static_cast<unsigned char*>(scratch),
      (long long)bb_scratch_bytes(m, n + m, bi, col, p1),
      static_cast<float*>(best), static_cast<float*>(bestx),
      static_cast<int*>(nlog), static_cast<int*>(lstate),
      static_cast<int*>(iters), static_cast<int*>(ticks),
      static_cast<float*>(lg_scal), static_cast<int*>(lg_basis),
      static_cast<int*>(lg_atup), static_cast<int*>(fin_basis),
      static_cast<int*>(fin_atup));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef BB_TICK_CLOCKS
// Where the next launches write each lane's tick clocks: (batch, 10)
// unsigned 64-bit, the cycles of restart, pivot start, pivot, transition
// and backtrack, then how many of each ran (null: nowhere).
int bb_fragment_set_clocks(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return (int)cudaMemcpyToSymbol(bb_clocks, &p, sizeof(p));
}
#endif

}  // extern "C"
