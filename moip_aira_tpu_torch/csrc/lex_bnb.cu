// K6 on Hopper: the lex backend's whole batch in one launch.  Each lane is
// one lexicographic solve of moip_aira_tpu_torch/solver/lex_torch.py
// (LexKernel: for each stage of its objective permutation, a depth-first
// branch and bound over a fixed stack of (lo, hi) rows whose every node is
// a cold LP solve of the dense simplex), in float64.
//
// This kernel replaces no Pallas kernel: the JAX package runs this batch
// (moip_aira_tpu/solver/lex_jax.py: a vmap over the lanes of a scan over the
// stages of a while_loop over the B&B nodes) as one XLA program.  Its plain
// version, which the tests and chip_smoke.py hold it to lane by lane, is
// LexKernel's loop on the CPU.  What bounds it: the LPs, node after node,
// each a chain of dependent step latencies.  So a lane's nodes run back to
// back in one launch, each LP on the engine whose chain is the shortest.
//
// The driver, lex_lane, is the lane's B&B, one for every engine, in the
// plain version's order of operations: for stage s, j = perm[s], c =
// +-C[j] (sign by the sense), and if the lane is alive and has met no
// resource limit, the root's bounds on the stack, then node after node:
// pop the top row and solve its LP (the engine's, from the logical basis,
// over [node bounds, row bounds, objective rows bounded by srhs]);
//   * nodes + 1 > max_bnb_nodes, ITER_LIMIT (a resource stop) or UNBOUNDED
//     end the stage after this node;
//   * an optimal LP: the bound (ceil(obj - 1e-6) for an integral
//     objective), the prune against best - tol, the most fractional integer
//     column (|x - rint(x)|, the first index on ties and a NaN the largest,
//     as torch.argmax breaks them), integral (its fraction <= 1e-6), take
//     (a better incumbent), branch, and the overflow test sp - 1 + 2 > MAXN
//     (a resource stop); a branch pushes the "up" child (lo[j] = floor(x[j]
//     + 1e-6) + 1) in the node's place and the "down" child (hi[j] = that
//     floor) on top;
// then rint (half to even) of the stage's best, the lane's result and srhs,
// and its IP count; over all stages, its nodes and LP steps.  A lane whose
// perm names an objective outside [0, k) runs no stage and reports
// LEX_BAD_PERM (4), with no IP, node or LP step.  Every float64 operation of
// its own is rounded on its own (__dadd_rn, __dsub_rn, __dmul_rn), so nvcc's
// contraction of a * b + c changes no prune.  Every thread of a lane keeps
// the driver's state in registers, alike, from values they all hold.
//
// An engine runs the lane's threads through a node: it solves the LP, every
// float64 operation dense_lane's (simplex_dense_core.cuh, K5's loop) in its
// order and rounding, so outputs and counts are the same on every engine,
// and reduces the most fractional column.  It says which thread leads, which
// columns a thread writes to the stack, where a stage's costs go and how the
// objective row is tightened.  The plan (lex_plan_for) picks it by shape:
//
// RegsEngine<MR, CW>, shape regs: for an LP of m <= REGS_ROWS rows and nc <=
// REGS_COLS columns, one warp a lane, P lanes a block, every value of a
// node's LP in the warp's registers.  Thread t holds column t mod CW (CW =
// 16 or 32 >= nc): its MR tableau values, c, bounds, values at each bound,
// flip length, objective term and flags.  With MR <= 8 rows every thread
// holds every row's x_B, bounds and basic column (the row sums, the ratio
// minimum, the row pick and the basic values' step take no shuffle); with
// up to 16, thread i holds row i (mod MR), and the minimum and the row pick
// are butterflies over the MR row threads.  c_B, the below/above masks, the
// entering column, the phase, the stall count, the watermark and the
// outcome are alike in every thread.  So a step touches no memory and
// passes no barrier but its shuffles, every one unconditional (a shuffle
// under a branch is split from its neighbours by the compiler's
// convergence check): pricing from registers, the column arg-max a
// butterfly over CW threads, the winner's column shuffled from its owner,
// the objective's nonbasic sum a shuffle chain from column 0.  A pivot's
// rank-1 update ends its step.  A node's start reads its stack row (each
// thread its own columns) and W through L1; its finish gathers x and the
// objective by shuffles.  MR and CW are compile-time, so the arrays stay in
// registers (lex_regs_kernel_for picks the build).
//
// RegsBlockEngine<MR>, shape regs_block: for an LP of at most RB_ROWS rows
// and 33 to RB_COLS columns, one block of NW = windows(nc) warps a lane,
// every tableau value in the block's registers.  Thread t holds column t -
// pad_low(nc), so warp w holds window w of the padded sums and pad threads
// give the +0s window_terms adds; lane i of every warp holds row i's x_B,
// bounds and basic column, so each warp does the ratio test, its minimum,
// the row pick and the row sums alike with no barrier, reading the rows'
// terms and costs and its columns' objective terms from its own copies in
// shared memory.  The column axis crosses warps through shared memory only:
// each step, each warp's arg-max winner publishes its score, values,
// tableau column and window of the nonbasic sum into the step's buffer
// (two, by parity) before the step's one block barrier; then every thread
// takes the same winner and chains the NW window sums (xla_sum's order).  A
// node's start and finish (fin_t, fin_i) take one barrier each.  MR (24 or
// 32) is compile-time, so the tableau column stays in registers; NW is read
// from the block's size, so one build serves 2, 3 and 4 warps.
//
// DenseEngine<SHAPE>, K5's plan, for a larger LP: dense_lane over the node's
// rows c, lo, hi in shared memory (in the global scratch for `global`), K6's
// own shared bytes counted; a lane on a warp, P lanes a block (packed), on a
// block (block) or on the `csize` blocks of a cluster (cluster, global).  On
// a cluster each block holds the node's full rows but writes only its slice
// of the children, and publishes its slice's most fractional column into
// every block's shared memory before a cluster barrier, so all take the same
// decisions.  The stack goes through L2 (__ldcg, __stcg), a cluster's pushes
// fenced and followed by a cluster barrier before any block pops.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblex_bnb.so lex_bnb.cu

#include "simplex_dense_core.cuh"

namespace {

// a lane's status (solver/lex_torch.py)
constexpr int LEX_OPTIMAL = 0;
constexpr int LEX_INFEASIBLE = 1;
constexpr int LEX_RESOURCE = 3;
// a lane whose perm names an objective outside [0, k): it runs no stage
constexpr int LEX_BAD_PERM = 4;
// the integrality tolerance, and the prune's tolerance for an objective
// that is not integral
constexpr double INT_TOL = 1e-6;
constexpr double REAL_TOL = 1e-9;
// K6's own shape, after K5's four: a warp a lane, the LP in its registers
// (RegsEngine), no shared memory
constexpr int SHAPE_REGS = 4;

// K6's part of a lane's shared memory, after K5's (k5_layout), as byte
// offsets from its end, each 16-byte aligned: the node's rows c, lo, hi
// (nc each) and x (n; none of the four in the global shape, whose rows lie
// in the global scratch), the warps' winners (v, x; j) and the cluster's
// published winners (v, x; j).  The wrapper's lex_bnb_smem_bytes counts
// the same.
struct LexLayout {
  size_t c, lo, hi, x, slot_t, slot_i, mail_t, mail_i, total;
};

// a layout's next array of `bytes`: its offset, the next one 16-byte aligned
struct Bump {
  size_t off = 0;
  __host__ __device__ size_t operator()(size_t bytes) {
    const size_t at = off;
    off += seg(bytes);
    return at;
  }
};

__host__ __device__ inline LexLayout lex_layout(int shape, int m, int n,
                                                int C) {
  LexLayout X{};
  Bump take_b;
  const bool glob = shape == SHAPE_GLOBAL;
  const size_t row = glob ? 0 : (size_t)(n + m) * sizeof(double);
  const int warps = shape == SHAPE_PACKED ? 0 : K5_MAX_WARPS;
  const int mail = (shape == SHAPE_CLUSTER || glob) ? C : 0;
  X.c = take_b(row);
  X.lo = take_b(row);
  X.hi = take_b(row);
  X.x = take_b(glob ? 0 : (size_t)n * sizeof(double));
  X.slot_t = take_b((size_t)2 * warps * sizeof(double));
  X.slot_i = take_b((size_t)warps * sizeof(int));
  X.mail_t = take_b((size_t)2 * mail * sizeof(double));
  X.mail_i = take_b((size_t)mail * sizeof(int));
  X.total = take_b.off;
  return X;
}

// K6's second shape of its own, regs_block (RegsBlockEngine): a block a
// lane, the LP in its registers
constexpr int RB_ROWS = 32;                 // rows: a row a warp lane
constexpr int RB_COLS = 4 * XLA_WINDOW;     // columns: one a thread, four warps
constexpr int RB_MAX_WARPS = RB_COLS / 32;
constexpr int SHAPE_REGS_BLOCK = 5;
// a warp's winner in the step's buffer: its score, reduced cost, c, lo, hi,
// span and nonbasic value, then the warp's window of the objective's
// nonbasic sum (values), its index, any eligible and at-upper (int32); its
// tableau column follows the values
constexpr int RB_SLOT_T = 8;
constexpr int RB_SLOT_I = 3;
// a warp's copies of the rows' terms: t1, t2, x_B, the phase-1 and the
// phase-2 costs (then its 32 columns' objective terms)
constexpr int RB_WARP_ROWS = 5;

// whether the regs_block shape takes an LP of m rows and n structural columns
__host__ __device__ inline bool regs_block_takes(int m, int n) {
  return m >= 1 && n >= 0 && m <= RB_ROWS && n + m > XLA_WINDOW && n + m <= RB_COLS;
}

// the rows of registers of the build that takes m rows
__host__ __device__ inline int regs_block_rows(int m) { return m <= 24 ? 24 : RB_ROWS; }

// The shape's shared memory, as byte offsets, each 16-byte aligned: the
// steps' two buffers of NW winners (values with their columns, then
// int32), the start's windows of the basic values (NW x MR), the finish's
// objective windows and most fractional columns (v, x; j), and each warp's
// copies of the rows' terms and of its columns' objective terms.  The
// wrapper's lex_bnb_smem_bytes counts the same.
struct RBLayout {
  size_t win_t, win_i, xbw, fin_t, fin_i, rows, total;
};

__host__ __device__ inline RBLayout rb_layout(int m, int n) {
  RBLayout X{};
  Bump take_b;
  const size_t nw = windows(n + m), mr = regs_block_rows(m);
  X.win_t = take_b(2 * nw * (RB_SLOT_T + mr) * sizeof(double));
  X.win_i = take_b(2 * nw * RB_SLOT_I * sizeof(int));
  X.xbw = take_b(nw * mr * sizeof(double));
  X.fin_t = take_b(nw * 3 * sizeof(double));
  X.fin_i = take_b(nw * sizeof(int));
  X.rows = take_b(nw * (RB_WARP_ROWS * mr + XLA_WINDOW) * sizeof(double));
  X.total = take_b.off;
  return X;
}

// a block's dynamic shared bytes under a plan: P lanes' parts in the packed
// shape, else one lane's (its slice on a cluster), each K5's part, then K6's
__host__ __device__ inline size_t lex_smem_bytes(int shape, int m, int n,
                                                 int C, int P) {
  if (shape == SHAPE_REGS) return 0;
  if (shape == SHAPE_REGS_BLOCK) return rb_layout(m, n).total;
  const size_t lane = k5_layout(shape, m, n + m, C, (int)sizeof(double)).total +
                      lex_layout(shape, m, n, C).total;
  return shape == SHAPE_PACKED ? (size_t)P * lane : lane;
}

// the global shape's rows a block: c, lo, hi (nc each) and x (n)
__host__ __device__ inline size_t lex_row_values(int m, int n) {
  return 3 * (size_t)(n + m) + n;
}

// (a, ia) beats (b, ib) in torch.argmax's order: a NaN is the largest, then
// the larger value, the lower index among equals
__device__ __forceinline__ bool frac_wins(double a, int ia, double b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na) return ia < ib;
  return a > b || (a == b && ia < ib);
}

// (v, j, x) the best of each group of WIDTH threads (a power of two) by
// frac_wins, in every thread of the group
template <int WIDTH>
__device__ __forceinline__ void frac_butterfly(double& v, int& j, double& x) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(FULL, v, off);
    const int oj = __shfl_xor_sync(FULL, j, off);
    const double ox = __shfl_xor_sync(FULL, x, off);
    const bool w = frac_wins(ov, oj, v, j);
    v = w ? ov : v;
    j = w ? oj : j;
    x = w ? ox : x;
  }
}

// The launch's inputs and outputs (device pointers; the plan's shape and
// C are the kernel's and its cluster's).
struct LexArgs {
  const double* W;  // (m, n + m): [A; C | -I]
  int m, n, k, batch;
  const double* rhs;      // (batch, k): each lane's starting srhs
  const long long* perm;  // (batch, k): each lane's objective order
  const double* C;        // (k, n): the objectives
  const double* lb;       // (n)
  const double* ub;       // (n)
  const double* row_lb;   // (m - k): the constraint rows' bounds
  const double* row_ub;
  const unsigned char* is_int;        // (n)
  const unsigned char* obj_integral;  // (k)
  int is_min, maxn, max_bnb_nodes, max_iters;
  double ft, ct, pt, prog;
  int stall_limit, csize;
  double* stack;  // (batch, 2, maxn, n): each lane's lo rows, then hi rows
  double* tab;    // global shape: (batch, C, m, pitch) tableau slices
  double* rows;   // global shape: (batch, C, lex_row_values) node rows
  int* status;         // (batch)
  long long* results;  // (batch, k)
  int* ips;            // (batch)
  long long* nodes;    // (batch): B&B nodes over all stages
  long long* iters;    // (batch): LP steps over all nodes
};

// Row i's logical bounds for lane b: the constraint row's, or objective row
// i - (m - k)'s by the lane's srhs (above for a minimisation, below for a
// maximisation), which the stages tighten
__device__ __forceinline__ void row_bounds(const LexArgs& a, int b, int i, double& lo,
                                           double& hi) {
  const int mk = a.m - a.k;
  if (i < mk) {
    lo = a.row_lb[i];
    hi = a.row_ub[i];
  } else {
    const double r = a.rhs[(size_t)b * a.k + (i - mk)];
    lo = a.is_min ? -INFINITY : r;
    hi = a.is_min ? r : INFINITY;
  }
}

// (v, j, x) the best by frac_wins of `count` published winners (v, x at
// t[2 r], t[2 r + 1]; j at i[r])
__device__ __forceinline__ void frac_of(const double* t, const int* i, int count, double& v,
                                        int& j, double& x) {
  v = t[0];
  x = t[1];
  j = i[0];
  for (int r = 1; r < count; ++r) {
    if (frac_wins(t[2 * r], i[r], v, j)) {
      v = t[2 * r];
      x = t[2 * r + 1];
      j = i[r];
    }
  }
}

// ---- the driver ----------------------------------------------------------------

// What an engine's node gives back to every thread of the lane: the LP's
// status (RUNNING turned ITER_LIMIT), its objective and steps, and the
// lane's most fractional integer column (its fraction, index and x)
struct NodeLP {
  int status;
  double obj;
  int iters;
  double fv;
  int fj;
  double fx;
};

// the parts of a lane's run that a -DK6_CLOCKS build counts, in SM cycles
// of its leading thread, summed over its nodes and steps: a node's start
// (its stack row, W's columns, the column constants) and its x_B; per step
// pricing, the column arg-max, the winner's values, the objective's
// nonbasic sum, the ratio test with its minimum, the row pick, the outcome,
// the basic values' step with the rank-1 update, the next step's row sums;
// a node's finish (x, the objective) and its B&B part (the most fractional
// column, the children).  The register engines count parts 0-11, the
// driver part 12.
#ifdef K6_CLOCKS
constexpr int K6_N_PARTS = 13;
__device__ unsigned long long* k6_clocks;
#endif
struct K6Clock {
#ifdef K6_CLOCKS
  unsigned long long ck[K6_N_PARTS];
  long long t;
  __device__ __forceinline__ K6Clock() {
    for (int p = 0; p < K6_N_PARTS; ++p) ck[p] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void tick(int part) {
    const long long t1 = clock64();
    ck[part] += (unsigned long long)(t1 - t);
    t = t1;
  }
  __device__ __forceinline__ void store(bool on, int lane) const {
    if (on && k6_clocks != nullptr)
      for (int p = 0; p < K6_N_PARTS; ++p) k6_clocks[(size_t)lane * K6_N_PARTS + p] = ck[p];
  }
#else
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void store(bool, int) const {}
#endif
};

// Lane b's whole lexicographic solve on the engine e's threads (a and e by
// value: no store of the lane's aliases them, so their fields stay in registers).
template <class E>
__device__ __forceinline__ void lex_lane(const LexArgs a, E e, int b) {
  using T = double;
  const int n = a.n, k = a.k;
  const T INF = T(INFINITY);
  if (e.lead())
    for (int i = 0; i < k; ++i) a.results[(size_t)b * k + i] = 0;
  // C[perm[s]] would read past the objectives: the lane runs no stage (the
  // plain version raises before it runs); every thread of the lane reads
  // the same perm and leaves together
  bool bad_perm = false;
  for (int i = 0; i < k; ++i) {
    const long long j = a.perm[(size_t)b * k + i];
    bad_perm = bad_perm || j < 0 || j >= k;
  }
  if (bad_perm) {
    if (e.lead()) {
      a.status[b] = LEX_BAD_PERM;
      a.ips[b] = 0;
      a.nodes[b] = 0;
      a.iters[b] = 0;
    }
    return;
  }
  T* stk_lo = a.stack + (size_t)b * 2 * a.maxn * n;  // [maxn][n]
  T* stk_hi = stk_lo + (size_t)a.maxn * n;
  bool alive = true, resource = false;
  int ips = 0;
  long long nodes_all = 0, iters_all = 0;
  const T sgn = a.is_min ? T(1) : T(-1);
  K6Clock ck;

  for (int s = 0; s < k; ++s) {
    const int jo = (int)a.perm[(size_t)b * k + s];
    const bool active = alive && !resource;
    bool found = false, res_s = false;
    T best = INF;
    if (active) {
      const bool oint = a.obj_integral[jo] != 0;
      const T tol = oint ? INT_TOL : REAL_TOL;
      e.stage(a, jo, sgn);
      e.cols([&](int jj) {
        E::store(stk_lo + jj, a.lb[jj]);
        E::store(stk_hi + jj, a.ub[jj]);
      });
      e.sync();
      int sp = 1, nodes = 0;
      bool unbounded = false;
      while (sp > 0 && !res_s && !unbounded) {
        const int sp1 = sp - 1;
        const NodeLP out = e.solve(a, stk_lo + (size_t)sp1 * n, stk_hi + (size_t)sp1 * n, ck);
        const T fv = out.fv, fx = out.fx;  // the lane's most fractional column
        const int fj = out.fj;
        nodes += 1;
        nodes_all += 1;
        iters_all += out.iters;

        bool res1 = nodes > a.max_bnb_nodes || out.status == ITER_LIMIT;
        unbounded = out.status == UNBOUNDED;
        bool push = false;
        T fl = T(0);
        if (out.status == OPTIMAL) {
          const T bound = oint ? ceil(__dsub_rn(out.obj, INT_TOL)) : out.obj;
          const bool pruned = bound >= __dsub_rn(best, tol);
          const bool integral = fv <= INT_TOL;
          const bool improves = out.obj < __dsub_rn(best, INT_TOL);
          if (!pruned && integral && improves) best = out.obj;
          const bool branch = !pruned && !integral;
          const bool overflow = branch && sp1 + 2 > a.maxn;
          res1 = res1 || overflow;
          push = branch && !overflow;
          fl = floor(__dadd_rn(fx, INT_TOL));
        }
        if (push) {
          // the "up" child in the node's place, the "down" child on top
          // (the DFS explores down first), each thread its own columns
          T* up_lo = stk_lo + (size_t)sp1 * n;
          T* dn_lo = stk_lo + (size_t)(sp1 + 1) * n;
          T* dn_hi = stk_hi + (size_t)(sp1 + 1) * n;
          e.cols([&](int jj) {
            if (jj == fj) E::store(up_lo + jj, __dadd_rn(fl, T(1)));
            E::store(dn_lo + jj, e.lo_of(jj));
            E::store(dn_hi + jj, jj == fj ? fl : e.hi_of(jj));
          });
          sp = sp1 + 2;
        } else {
          sp = sp1;
        }
        res_s = res1;
        e.sync();
        ck.tick(12);
      }
      found = isfinite(best) && !res_s;
    }
    // the stage's value: the lane's result and its objective row's bound
    if (alive && found) {
      const T val = rint(a.is_min ? best : -best);
      if (e.lead()) a.results[(size_t)b * k + jo] = (long long)val;
      e.tighten(a, jo, val);
    }
    ips += active ? 1 : 0;
    alive = alive && found;
    resource = resource || res_s;
    e.stage_end();
  }
  ck.store(e.lead(), b);
  if (e.lead()) {
    a.status[b] = resource ? LEX_RESOURCE : (alive ? LEX_OPTIMAL : LEX_INFEASIBLE);
    a.ips[b] = ips;
    a.nodes[b] = nodes_all;
    a.iters[b] = iters_all;
  }
}

// K6, one per engine and build: lane E::lane_of(csize) on the engine's
// threads; `a` by value, so that its fields are read from the parameter bank
template <class E>
__global__ void __launch_bounds__(E::THREADS) lex_bnb_kernel(const LexArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = E::lane_of(a.csize);
  if (b >= a.batch) return;  // a packed block's idle warps: no barrier but their own
  E e(a, b, smem);
  lex_lane(a, e, b);
}

// ---- DenseEngine: K5's loop on the node's rows in shared memory ---------------
template <int SHAPE>
struct DenseEngine {
  using T = double;
  static constexpr int THREADS = K5_MAX_THREADS;
  static constexpr bool PK = SHAPE == SHAPE_PACKED;
  static constexpr bool CL = SHAPE == SHAPE_CLUSTER || SHAPE == SHAPE_GLOBAL;
  int m, n, mk, C, rank, tid, nt;
  int js0, js1;  // the structural columns whose stack entries this block writes
  unsigned char* base;
  T *row_c, *row_lo, *row_hi, *row_x, *tab, *slot_t, *mail_t;
  int *slot_i, *mail_i;

  __device__ static int lane_of(int csize) {
    return PK ? blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)
              : (CL ? blockIdx.x / csize : blockIdx.x);
  }

  __device__ __forceinline__ DenseEngine(const LexArgs& a, int b, unsigned char* smem)
      : m(a.m), n(a.n), mk(a.m - a.k), C(CL ? a.csize : 1) {
    const int nc = n + m, warp = threadIdx.x >> 5;
    rank = 0;
    if constexpr (CL) rank = (int)cg::this_cluster().block_rank();
    tid = PK ? (threadIdx.x & 31) : threadIdx.x;
    nt = PK ? 32 : blockDim.x;
    const LexLayout X = lex_layout(SHAPE, m, n, C);
    const size_t k5_bytes = k5_layout(SHAPE, m, nc, C, (int)sizeof(T)).total;
    base = smem + (PK ? (size_t)warp * (k5_bytes + X.total) : 0);
    unsigned char* ext = base + k5_bytes;
    const Slice sl = slice_of(nc, C, rank);
    const size_t blk = (size_t)b * C + rank;  // the lane's block, among all
    if constexpr (SHAPE == SHAPE_GLOBAL) {
      row_c = a.rows + blk * lex_row_values(m, n);
      row_lo = row_c + nc;
      row_hi = row_lo + nc;
      row_x = row_hi + nc;
    } else {
      row_c = reinterpret_cast<T*>(ext + X.c);
      row_lo = reinterpret_cast<T*>(ext + X.lo);
      row_hi = reinterpret_cast<T*>(ext + X.hi);
      row_x = reinterpret_cast<T*>(ext + X.x);
    }
    tab = SHAPE == SHAPE_GLOBAL ? a.tab + blk * m * sl.pitch : nullptr;
    slot_t = reinterpret_cast<T*>(ext + X.slot_t);
    slot_i = reinterpret_cast<int*>(ext + X.slot_i);
    mail_t = reinterpret_cast<T*>(ext + X.mail_t);
    mail_i = reinterpret_cast<int*>(ext + X.mail_i);
    js0 = imin(sl.j0, n);
    js1 = imin(sl.j1, n);
    // the rows' logical part: c 0 and the rows' bounds
    for (int i = tid; i < m; i += nt) {
      row_c[n + i] = T(0);
      row_bounds(a, b, i, row_lo[n + i], row_hi[n + i]);
    }
  }

  __device__ __forceinline__ bool lead() const { return rank == 0 && tid == 0; }
  template <class F>
  __device__ __forceinline__ void cols(const F& f) const {
    for (int jj = js0 + tid; jj < js1; jj += nt) f(jj);
  }
  __device__ __forceinline__ static void store(T* p, T v) { __stcg(p, v); }
  __device__ __forceinline__ T lo_of(int jj) const { return row_lo[jj]; }
  __device__ __forceinline__ T hi_of(int jj) const { return row_hi[jj]; }
  // every block's pushes visible to every block of the lane before any
  // pops (a cluster), or the lane's threads past their reads of the rows
  __device__ __forceinline__ void sync() const {
    if constexpr (CL) {
      __threadfence();
      cg::this_cluster().sync();
    } else {
      lane_sync<SHAPE>();
    }
  }
  __device__ __forceinline__ void stage_end() const { lane_sync<SHAPE>(); }

  __device__ __forceinline__ void stage(const LexArgs& a, int jo, T sgn) {
    for (int jj = tid; jj < n; jj += nt) row_c[jj] = __dmul_rn(sgn, a.C[(size_t)jo * n + jj]);
  }

  __device__ __forceinline__ void tighten(const LexArgs& a, int jo, T val) {
    if (tid == 0) (a.is_min ? row_hi : row_lo)[n + mk + jo] = val;
  }

  __device__ __forceinline__ NodeLP solve(const LexArgs& args, const T* slo, const T* shi,
                                          K6Clock&) {
    // the lane's values in locals: no store of the node's aliases them
    // while the node is optimized before the driver inlines it
    const LexArgs a = args;
    const int m = this->m, n = this->n, tid = this->tid, nt = this->nt, js0 = this->js0,
              js1 = this->js1;
    T *const row_c = this->row_c, *const row_lo = this->row_lo, *const row_hi = this->row_hi,
             *const row_x = this->row_x, *const tab = this->tab;
    unsigned char* const base = this->base;
    for (int jj = tid; jj < n; jj += nt) {
      row_lo[jj] = __ldcg(slo + jj);
      row_hi[jj] = __ldcg(shi + jj);
    }
    lane_sync<SHAPE>();
    const LaneResult<T> out = dense_lane<T, SHAPE>(
        base, a.W, m, n, a.csize, row_c, row_lo, row_hi, true, a.max_iters, a.ft, a.ct, a.pt,
        a.prog, a.stall_limit, tab, row_x, nullptr, nullptr, 0);
    // the most fractional integer column of the LP's x
    T fv = T(-1), fx = T(0);
    int fj = INT_MAX;
    for (int jj = js0 + tid; jj < js1; jj += nt) {
      const T x = row_x[jj];
      const T f = a.is_int[jj] ? fabs(__dsub_rn(x, rint(x))) : T(0);
      if (frac_wins(f, jj, fv, fj)) {
        fv = f;
        fj = jj;
        fx = x;
      }
    }
    frac_best(fv, fj, fx);
    return {out.status, out.obj, out.iters, fv, fj, fx};
  }

  // The lane's most fractional column (v its fraction, j its index, x its
  // value), from each thread's candidate, in every thread: over the warp by
  // shuffles, over the block's warps through `slot_t`/`slot_i`, over a
  // cluster's blocks through every block's `mail_t`/`mail_i`, each block's
  // winner published at its rank before the cluster barrier.
  __device__ __forceinline__ void frac_best(T& v, int& j, T& x) const {
    frac_butterfly<32>(v, j, x);
    if constexpr (!PK) {
      const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        slot_t[2 * warp] = v;
        slot_t[2 * warp + 1] = x;
        slot_i[warp] = j;
      }
      __syncthreads();
      frac_of(slot_t, slot_i, nw, v, j, x);
      if constexpr (CL) {
        cg::cluster_group cluster = cg::this_cluster();
        if ((int)threadIdx.x < C) {
          T* mt = cluster.map_shared_rank(mail_t + 2 * rank, threadIdx.x);
          int* mi = cluster.map_shared_rank(mail_i + rank, threadIdx.x);
          mt[0] = v;
          mt[1] = x;
          *mi = j;
        }
        cluster.sync();
        frac_of(mail_t, mail_i, C, v, j, x);
      }
    }
  }
};

// ---- RegsEngine: a warp a lane, the node's LP in its registers --------------

constexpr int REGS_ROWS = 16;  // rows: the tableau's registers a thread
constexpr int REGS_COLS = 32;  // columns: one a thread

// whether the regs shape takes an LP of m rows and n structural columns
__host__ __device__ inline bool regs_takes(int m, int n) {
  return m >= 1 && n >= 0 && m <= REGS_ROWS && n + m <= REGS_COLS;
}

// The chain over the nc <= CW columns of each column's values u[j] and
// (TWO) w[j], shuffled from the column's thread (every one of the CW, so no
// shuffle waits on a branch) eight columns ahead of their links: acc =
// first(u[0], w[0]), then link(acc, u[j], w[j]); xla_sum's and xla_dot's order.
template <int CW, bool TWO, class First, class Link>
__device__ __forceinline__ double col_chain(double u, double w, int nc, const First& first,
                                            const Link& link) {
  double acc = 0.0;
#pragma unroll
  for (int j0 = 0; j0 < CW; j0 += 8) {
    double us[8], ws[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      us[i] = __shfl_sync(FULL, u, j0 + i);
      ws[i] = TWO ? __shfl_sync(FULL, w, j0 + i) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j0 + i < nc) acc = j0 + i == 0 ? first(us[i], ws[i]) : link(acc, us[i], ws[i]);
  }
  return acc;
}

// xla_sum over the nc <= 32 columns' terms v: the chain from column 0
template <int CW>
__device__ __forceinline__ double col_sum(double v, int nc) {
  using T = double;
  return col_chain<CW, false>(v, T(0), nc, [](T u, T) { return u; },
                              [](T acc, T u, T) { return __dadd_rn(acc, u); });
}

// a / b as __ddiv_rn gives it; a zero or infinite a over a finite nonzero
// b is its signed zero or infinity without a division, a quotient whose
// range the division's check would send down its slow path
__device__ __forceinline__ double div_rn(double a, double b) {
  const bool easy = (a == 0.0 || isinf(a)) && isfinite(b) && b != 0.0;
  const double q = __ddiv_rn(easy ? 1.0 : a, b);
  return easy ? (signbit(b) ? -a : a) : q;
}

// The butterfly over groups of WIDTH lanes (a power of two): (v, j) the
// largest of the group by `wins`, in every lane of it, without a branch
template <int WIDTH>
__device__ __forceinline__ void best_of(double& v, int& j) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(FULL, v, off);
    const int oj = __shfl_xor_sync(FULL, j, off);
    const bool w = wins(ov, oj, v, j);
    v = w ? ov : v;
    j = w ? oj : j;
  }
}

// A register engine's thread: its column and row, their bounds, the
// stage's cost and the node's bounds of its column, and what the two
// register engines do alike outside their LPs
struct RegLane {
  using T = double;
  int m, n, nc, mk, lane;
  int jc;     // this thread's column
  int ri;     // this thread's row
  bool has;   // the column exists
  bool st;    // ... a structural one
  bool sint;  // ... an integer one
  bool hasr;
  int rr;
  T rlo, rhi;  // row rr's logical bounds (row_bounds)
  T cc;        // the stage's cost of the column (0 on the logical columns)
  T blo, bhi;  // a logical column's bounds, from its row's thread
  T lo, hi;    // the node's bounds of the column

  __device__ __forceinline__ RegLane(const LexArgs& a, int b, int jc_, int ri_)
      : m(a.m), n(a.n), nc(a.n + a.m), mk(a.m - a.k), lane(threadIdx.x & 31), jc(jc_),
        ri(ri_) {
    has = jc >= 0 && jc < nc;
    st = has && jc < n;
    sint = st && a.is_int[jc] != 0;
    hasr = ri < m;
    rr = hasr ? ri : m - 1;
    row_bounds(a, b, rr, rlo, rhi);
  }

  // each thread writes, and reads, only its own column's stack entries
  template <class F>
  __device__ __forceinline__ void cols(const F& f) const {
    if (st) f(jc);
  }
  __device__ __forceinline__ static void store(T* p, T v) { *p = v; }
  __device__ __forceinline__ T lo_of(int) const { return lo; }
  __device__ __forceinline__ T hi_of(int) const { return hi; }
  __device__ __forceinline__ void stage_end() const {}

  __device__ __forceinline__ void stage(const LexArgs& a, int jo, T sgn) {
    const int j = jc;
    cc = st ? __dmul_rn(sgn, a.C[(size_t)jo * n + j]) : T(0);
    // a logical column's bounds: its row's, from the row's thread
    const int src = (has && j >= n) ? j - n : 0;
    blo = __shfl_sync(FULL, rlo, src);
    bhi = __shfl_sync(FULL, rhi, src);
  }

  __device__ __forceinline__ void tighten(const LexArgs& a, int jo, T val) {
    if (rr == mk + jo) {
      if (a.is_min)
        rhi = val;
      else
        rlo = val;
    }
  }

  // the most fractional integer column over groups of WIDTH threads, the
  // x of this thread's column zj: its fraction fv, index fj and x fx, in
  // every thread of the group
  template <int WIDTH>
  __device__ __forceinline__ void frac_best(T zj, T& fv, int& fj, T& fx) const {
    fv = T(-1);
    fx = T(0);
    fj = INT_MAX;
    if (st) {
      const T f = sint ? fabs(__dsub_rn(zj, rint(zj))) : T(0);
      const bool w = frac_wins(f, jc, fv, fj);
      fv = w ? f : fv;
      fj = w ? jc : fj;
      fx = w ? zj : fx;
    }
    frac_butterfly<WIDTH>(fv, fj, fx);
  }
};

template <int MR, int CW>
struct RegsEngine : RegLane {
  static constexpr int THREADS = 32 * K5_MAX_PACK;
  // the rows alike in every thread (MR <= 8: their few values in each
  // thread's registers), else row i in thread i
  static constexpr bool REP = MR <= 8;
  static constexpr int RR = REP ? MR : 1;  // the rows a thread keeps
  static constexpr int Gm = MR;            // the threads a row group spans

  __device__ static int lane_of(int) {
    return blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  }

  __device__ __forceinline__ RegsEngine(const LexArgs& a, int b, unsigned char*)
      : RegLane(a, b, threadIdx.x & (CW - 1), threadIdx.x & (Gm - 1)) {}

  __device__ __forceinline__ bool lead() const { return lane == 0; }
  // the stack's rows, for the duplicate threads' reads
  __device__ __forceinline__ void sync() const { __syncwarp(); }

  __device__ __forceinline__ NodeLP solve(const LexArgs& args, const T* slo, const T* shi,
                                          K6Clock& ck) {
    // the lane's values in locals: no store of the node's aliases them
    // while the node is optimized before the driver inlines it
    const LexArgs a = args;
    const int m = this->m, n = this->n, nc = this->nc, jc = this->jc, ri = this->ri, rr = this->rr;
    const bool has = this->has, st = this->st, hasr = this->hasr;
    const T cc = this->cc, blo = this->blo, bhi = this->bhi, rlo = this->rlo, rhi = this->rhi;
    T lo, hi;
    const int j = jc;
    const T INF = T(INFINITY);
    const T ft = a.ft, ct = a.ct, pt = a.pt, prog = a.prog;
    // ---- the node's LP: start -------------------------------------
    lo = j < n ? slo[j] : blo;
    hi = j < n ? shi[j] : bhi;
    const int empty = __any_sync(FULL, has && lo > __dadd_rn(hi, ft));
    const bool lof = isfinite(lo), hif = isfinite(hi);
    const bool fre = !lof && !hif;
    const T zlo = lof ? lo : (hif ? hi : T(0));
    const T zup = hif ? hi : zlo;
    const T span = (lof && hif) ? __dsub_rn(hi, lo) : INF;
    bool inb = j >= n, atu = j < n && !lof && hif;
    T cz = __dmul_rn(cc, j >= n ? T(0) : (atu ? zup : zlo));
    const T z0 = j < n ? zlo : T(0);
    T t[MR];
    const int jw = has ? j : 0;
#pragma unroll
    for (int i = 0; i < MR; ++i) t[i] = i < m ? -__ldg(a.W + (size_t)i * nc + jw) : T(0);
    ck.tick(0);
    // x_B = -T0 z0 with T0 = -W, row rr by its thread: the chain of
    // fused multiply-adds over the columns from column 0
    T xb;
    {
      const T* Wr = a.W + (size_t)rr * nc;
      T acc = T(0);
#pragma unroll
      for (int j0 = 0; j0 < CW; j0 += 8) {
        T wv[8], zv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          wv[i] = j0 + i < nc ? -__ldg(Wr + j0 + i) : T(0);
          zv[i] = __shfl_sync(FULL, z0, j0 + i);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (j0 + i < nc)
            acc = j0 + i == 0 ? __dmul_rn(wv[i], zv[i]) : __fma_rn(wv[i], zv[i], acc);
      }
      xb = -acc;
    }
    // the rows: x_B, bounds, basic column; REP: every row's in every
    // thread, else row rr's
    T xB[RR], bl[RR], bh[RR];
    int basis[RR];
    if constexpr (REP) {
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        xB[i] = __shfl_sync(FULL, xb, i);
        bl[i] = __shfl_sync(FULL, rlo, i);
        bh[i] = __shfl_sync(FULL, rhi, i);
        basis[i] = n + i;
      }
    } else {
      xB[0] = xb;
      bl[0] = rlo;
      bh[0] = rhi;
      basis[0] = n + rr;
    }
    T cBb[MR];  // each row's cost c[basis], alike in every thread
#pragma unroll
    for (int i = 0; i < MR; ++i) cBb[i] = T(0);  // the logical columns'

    int status = empty ? INFEASIBLE : RUNNING;
    int it = 0, stall = 0, stall_e = 0;
    bool p1 = true, p1n = true;
    T last = INF, last_e = INF, infeas = T(0), cbx = T(0);
    unsigned bwm = 0, abm = 0;  // bit i: row i below / above its bounds
    ck.tick(1);

    // the row terms of the step about to start, its three row sums as
    // chains from row 0 (REP: in every thread; else shuffled from each
    // row's thread), and its phase test
    auto rows_and_sums = [&]() {
      T s_lo = T(0), s_hi = T(0);
      if constexpr (REP) {
        unsigned bwb = 0, abb = 0;
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          if (i < m) {
            const bool bw = xB[i] < __dsub_rn(bl[i], ft);
            const bool ab = xB[i] > __dadd_rn(bh[i], ft);
            bwb |= (unsigned)bw << i;
            abb |= (unsigned)ab << i;
            const T t1v = bw ? __dsub_rn(bl[i], xB[i]) : T(0);
            const T t2v = ab ? __dsub_rn(xB[i], bh[i]) : T(0);
            s_lo = i == 0 ? t1v : __dadd_rn(s_lo, t1v);
            s_hi = i == 0 ? t2v : __dadd_rn(s_hi, t2v);
            cbx = i == 0 ? __dmul_rn(cBb[0], xB[0]) : __fma_rn(cBb[i], xB[i], cbx);
          }
        }
        bwm = bwb;
        abm = abb;
      } else {
        const bool bw = xB[0] < __dsub_rn(bl[0], ft);
        const bool ab = xB[0] > __dadd_rn(bh[0], ft);
        bwm = __ballot_sync(FULL, bw);
        abm = __ballot_sync(FULL, ab);
        const T t1v = bw ? __dsub_rn(bl[0], xB[0]) : T(0);
        const T t2v = ab ? __dsub_rn(xB[0], bh[0]) : T(0);
        s_lo = __shfl_sync(FULL, t1v, 0);
        s_hi = __shfl_sync(FULL, t2v, 0);
        cbx = __dmul_rn(cBb[0], __shfl_sync(FULL, xB[0], 0));
#pragma unroll
        for (int i = 1; i < MR; ++i) {
          const T u = __shfl_sync(FULL, t1v, i), v = __shfl_sync(FULL, t2v, i);
          const T x = __shfl_sync(FULL, xB[0], i);
          if (i < m) {
            s_lo = __dadd_rn(s_lo, u);
            s_hi = __dadd_rn(s_hi, v);
            cbx = __fma_rn(cBb[i], x, cbx);
          }
        }
      }
      infeas = __dadd_rn(s_lo, s_hi);
      p1n = p1 && infeas > ft;  // phase 1 ends once feasible
      const bool entered = p1 && !p1n;
      stall_e = entered ? 0 : stall;
      last_e = entered ? INF : last;
    };
    rows_and_sums();
    bool run = status == RUNNING && it < a.max_iters;
    ck.tick(10);
    // ---- the steps --------------------------------------------------
    while (run) {
      const bool sp1n = p1n, bland = stall >= a.stall_limit;
      // pricing: each column's reduced cost, eligibility and score,
      // c_B (the phase-1 costs ab - bw, exactly, or c[basis]) . T[:, j]
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        if (i < m) {
          const bool ab = (abm >> i) & 1u, bw = (bwm >> i) & 1u;
          const T c1 = ab ? (bw ? T(0) : T(1)) : (bw ? T(-1) : T(0));
          const T ce = sp1n ? c1 : cBb[i];
          acc = i == 0 ? __dmul_rn(ce, t[0]) : __fma_rn(ce, t[i], acc);
        }
      }
      const T d = __dsub_rn(sp1n ? T(0) : cc, acc);
      const T ad = fabs(d);
      const bool elig = has && !inb && (fre ? ad > ct : (atu ? d : -d) > ct);
      const T score = elig ? (bland ? -T(jc) : ad) : (bland ? T(-BIG) : T(-1));
      T bv = has ? score : -INF;
      int bj = has ? jc : INT_MAX;
      ck.tick(2);
      best_of<CW>(bv, bj);
      const bool anyq = __any_sync(FULL, elig);
      ck.tick(3);
      // the winner's values and column, from its owner
      const int qc = bj, owner = qc & 31;
      const T zv = inb ? T(0) : (atu ? zup : zlo);
      const T dq = __shfl_sync(FULL, d, owner), cq = __shfl_sync(FULL, cc, owner);
      const T loq = __shfl_sync(FULL, lo, owner), hiq = __shfl_sync(FULL, hi, owner);
      const T spanq = __shfl_sync(FULL, span, owner), zq = __shfl_sync(FULL, zv, owner);
      const bool atuq = __shfl_sync(FULL, (int)atu, owner) != 0;
      T alpha[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) alpha[i] = i < m ? __shfl_sync(FULL, t[i], owner) : T(0);
      ck.tick(4);
      // the objective's nonbasic part, with the step's starting flags
      // (in both phases, so its chain interleaves with the ratio test)
      const T czv_all = col_sum<CW>(cz, nc);
      const T czv = sp1n ? T(0) : czv_all;
      ck.tick(5);

      // the ratio test: row rr's by its thread (REP: then every row's
      // ratio in every thread); the least ratio
      const T sigma = dq < T(0) ? T(1) : T(-1);  // up on d < 0
      T xr = xB[0], lr = bl[0], hr = bh[0], ar = alpha[0];
      if constexpr (REP) {
#pragma unroll
        for (int i = 1; i < RR; ++i) {
          xr = i == rr ? xB[i] : xr;
          lr = i == rr ? bl[i] : lr;
          hr = i == rr ? bh[i] : hr;
        }
      }
#pragma unroll
      for (int i = 1; i < MR; ++i) ar = i == rr ? alpha[i] : ar;
      const bool bwr = (bwm >> rr) & 1u, abr = (abm >> rr) & 1u;
      const T eta = __dmul_rn(-sigma, ar);
      const T ae = fabs(eta);
      const bool ng = eta < T(0);
      const T num = ng ? __dsub_rn(xr, abr ? hr : lr) : __dsub_rn(bwr ? lr : hr, xr);
      const bool valid = ae > pt && !(ng ? bwr : abr);
      // (every thread divides, an invalid row 1 by 1: no branch)
      const T rd = div_rn(valid ? num : T(1), valid ? ae : T(1));
      const T rq = valid ? rd : INF;
      const T rc = rq < T(0) ? T(0) : rq;
      T mn = INF, ratio_r, piv;
      T pv = -INF;
      int r = INT_MAX, p_col;
      if constexpr (REP) {
        // the ratios, and their minimum as a tree of fmin (exact,
        // whatever the order; the sign of a zero minimum changes
        // neither the tie nor the test)
        T rat[RR], mt[RR];
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          rat[i] = __shfl_sync(FULL, rc, i);
          mt[i] = i < m ? rat[i] : INF;
        }
#pragma unroll
        for (int w = 1; w < RR; w <<= 1)
#pragma unroll
          for (int i = 0; i + w < RR; i += 2 * w) mt[i] = fmin(mt[i], mt[i + w]);
        mn = mt[0];
        ck.tick(6);
        // the least ratio and, among the rows tied with it, the one of
        // largest |eta| (Bland: the lowest basic column), by a tree of
        // `wins` (a total order)
        const T tie = __dadd_rn(mn, ft);
        T pk[RR];
        int ik[RR];
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          const T aei = fabs(__dmul_rn(-sigma, alpha[i]));
          const T pick = rat[i] <= tie ? (bland ? -T(basis[i]) : aei)
                                       : (bland ? T(-BIG) : T(-1));
          pk[i] = i < m ? pick : -INF;
          ik[i] = i < m ? i : INT_MAX;
        }
#pragma unroll
        for (int w = 1; w < RR; w <<= 1) {
#pragma unroll
          for (int i = 0; i + w < RR; i += 2 * w) {
            const bool b2 = wins(pk[i + w], ik[i + w], pk[i], ik[i]);
            pk[i] = b2 ? pk[i + w] : pk[i];
            ik[i] = b2 ? ik[i + w] : ik[i];
          }
        }
        pv = pk[0];
        r = ik[0];
        ratio_r = rat[0];
        piv = alpha[0];
        p_col = basis[0];
#pragma unroll
        for (int i = 1; i < RR; ++i) {
          ratio_r = i == r ? rat[i] : ratio_r;
          piv = i == r ? alpha[i] : piv;
          p_col = i == r ? basis[i] : p_col;
        }
      } else {
        mn = hasr ? rc : INF;
#pragma unroll
        for (int off = Gm / 2; off > 0; off >>= 1)
          mn = fmin(mn, __shfl_xor_sync(FULL, mn, off));
        ck.tick(6);
        const T tie = __dadd_rn(mn, ft);
        if (hasr) {
          pv = rc <= tie ? (bland ? -T(basis[0]) : ae) : (bland ? T(-BIG) : T(-1));
          r = ri;
        }
        best_of<Gm>(pv, r);
        ratio_r = __shfl_sync(FULL, rc, r);
        piv = __shfl_sync(FULL, ar, r);
        p_col = __shfl_sync(FULL, basis[0], r);
      }
      ck.tick(7);

      // the step's outcome, the bound flags, the objective watermark
      const bool row_blocks = mn < spanq;
      const T theta = row_blocks ? ratio_r : spanq;
      const int code = p1n ? 1 : 0;  // INFEASIBLE = 1, OPTIMAL = 0
      status = anyq ? (isfinite(theta) ? RUNNING : UNBOUNDED - code) : code;
      const bool moves = status == RUNNING;
      const bool do_pivot = moves && row_blocks, do_flip = moves && !row_blocks;
      const bool leave_up =
          __dmul_rn(-sigma, piv) < T(0) ? ((abm >> r) & 1u) : !((bwm >> r) & 1u);
      const T newval = __dadd_rn(zq, __dmul_rn(sigma, theta));
      {
        const bool hp = has && jc == p_col, hq = has && jc == qc;
        if (do_pivot) {
          if (hp) {
            atu = leave_up;
            inb = false;
          }
          if (hq) inb = true;
        } else if (hq) {
          atu = atuq ^ do_flip;
        }
        const T zn = inb ? T(0) : (atu ? zup : zlo);
        if ((do_pivot && hp) || hq) cz = __dmul_rn(cc, zn);
      }
      const T cur = p1n ? infeas : __dadd_rn(cbx, czv);
      const bool progressed = cur < __dsub_rn(last_e, prog);
      stall = progressed ? 0 : stall_e + 1;
      last = cur < last_e ? cur : last_e;
      p1 = p1n;
      it += 1;
      ck.tick(8);

      // the step: basic values along eta; a pivot's row takes q's value,
      // bounds and cost, and every column its rank-1 update
      // (selected, not branched; the next step's row sums before the
      // rank-1 update, so that its divisions overlap them; past the
      // last step they are unread)
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const bool here = REP ? i == r : ri == r;
        const T e = REP ? __dmul_rn(-sigma, alpha[i]) : eta;
        const bool first = REP ? i == 0 : ri == 0;
        T v = first ? __dadd_rn(xB[i], __dmul_rn(e, theta)) : __fma_rn(e, theta, xB[i]);
        const bool pv_row = do_pivot && here;
        v = pv_row ? newval : v;
        basis[i] = pv_row ? qc : basis[i];
        bl[i] = pv_row ? loq : bl[i];
        bh[i] = pv_row ? hiq : bh[i];
        xB[i] = moves && (!REP || i < m) ? v : xB[i];
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) cBb[i] = do_pivot && i == r ? cq : cBb[i];
      ck.tick(9);
      run = status == RUNNING && it < a.max_iters;
      rows_and_sums();
      ck.tick(10);
      const T den = fabs(piv) > T(0) ? piv : T(1);
      T tr = t[0];
#pragma unroll
      for (int i = 1; i < MR; ++i) tr = i == r ? t[i] : tr;
      const T rj = div_rn(tr, den);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const T u = i == r ? rj : __fma_rn(-alpha[i], rj, t[i]);
        t[i] = do_pivot && i < m ? u : t[i];
      }
      ck.tick(9);
    }
    // ---- finish: x, the objective c . z ------------------------------
    T zj = inb ? T(0) : (atu ? zup : zlo);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      int bi;
      T xi;
      if constexpr (REP) {
        bi = basis[i < RR ? i : 0];
        xi = xB[i < RR ? i : 0];
      } else {
        bi = __shfl_sync(FULL, basis[0], i);
        xi = __shfl_sync(FULL, xB[0], i);
      }
      zj = i < m && jc == bi ? xi : zj;
    }
    const T obj = col_chain<CW, true>(cc, zj, nc, [](T c, T z) { return __dmul_rn(c, z); },
                                      [](T acc, T c, T z) { return __fma_rn(c, z, acc); });
    const int lp_status = status == RUNNING ? ITER_LIMIT : status;
    ck.tick(11);

    // the lane's most fractional integer column
    T fv, fx;
    int fj;
    frac_best<CW>(zj, fv, fj, fx);
    this->lo = lo;
    this->hi = hi;
    return {lp_status, obj, it, fv, fj, fx};
  }
};

// ---- RegsBlockEngine: a block a lane, the node's LP in its registers --------

// t[r] (SET: t[r] = v) for a block-uniform r: one jump on r, not a chain
// of selects
template <bool SET, int MR>
__device__ __forceinline__ double reg_at(double (&t)[MR], int r, double v = 0.0) {
  switch (r) {
#define RB_CASE(i)                                 \
  case i:                                          \
    if constexpr (i < MR) {                        \
      if constexpr (SET) t[i] = v; else v = t[i];  \
    }                                              \
    break;
    RB_CASE(0) RB_CASE(1) RB_CASE(2) RB_CASE(3) RB_CASE(4) RB_CASE(5) RB_CASE(6) RB_CASE(7)
    RB_CASE(8) RB_CASE(9) RB_CASE(10) RB_CASE(11) RB_CASE(12) RB_CASE(13) RB_CASE(14)
    RB_CASE(15) RB_CASE(16) RB_CASE(17) RB_CASE(18) RB_CASE(19) RB_CASE(20) RB_CASE(21)
    RB_CASE(22) RB_CASE(23) RB_CASE(24) RB_CASE(25) RB_CASE(26) RB_CASE(27) RB_CASE(28)
    RB_CASE(29) RB_CASE(30) RB_CASE(31)
#undef RB_CASE
  }
  return v;
}

template <int MR>
struct RegsBlockEngine : RegLane {
  static constexpr int THREADS = RB_COLS;
  static constexpr int SLOT = RB_SLOT_T + MR;
  static constexpr int WROW = RB_WARP_ROWS * MR + XLA_WINDOW;  // a warp's rows and terms
  int nw, warp;
  T* win_t;    // [2][nw][SLOT]
  int* win_i;  // [2][nw][RB_SLOT_I]
  T* xbw;      // [nw][MR]
  T* fin_t;    // [nw][3]: obj, v, x
  int* fin_i;  // [nw]: j
  // this warp's copies of the rows' terms (t1, t2, x_B, the phase-1 and
  // the phase-2 costs, MR each) and of its columns' objective terms
  T *w_t1, *w_t2, *w_xb, *w_cb1, *w_cbb, *w_cz;

  __device__ static int lane_of(int) { return blockIdx.x; }

  __device__ __forceinline__ RegsBlockEngine(const LexArgs& a, int b, unsigned char* smem)
      : RegLane(a, b, (int)threadIdx.x - pad_low(a.n + a.m), threadIdx.x & 31),
        nw(blockDim.x >> 5), warp(threadIdx.x >> 5) {
    const RBLayout X = rb_layout(m, n);
    win_t = reinterpret_cast<T*>(smem + X.win_t);
    win_i = reinterpret_cast<int*>(smem + X.win_i);
    xbw = reinterpret_cast<T*>(smem + X.xbw);
    fin_t = reinterpret_cast<T*>(smem + X.fin_t);
    fin_i = reinterpret_cast<int*>(smem + X.fin_i);
    w_t1 = reinterpret_cast<T*>(smem + X.rows) + (size_t)warp * WROW;
    w_t2 = w_t1 + MR;
    w_xb = w_t2 + MR;
    w_cb1 = w_xb + MR;
    w_cbb = w_cb1 + MR;
    w_cz = w_cbb + MR;
  }

  __device__ __forceinline__ bool lead() const { return threadIdx.x == 0; }
  __device__ __forceinline__ void sync() const {}

  __device__ __forceinline__ NodeLP solve(const LexArgs& args, const T* slo, const T* shi,
                                          K6Clock& ck) {
    // the lane's values in locals: no store of the node's aliases them
    // while the node is optimized before the driver inlines it
    const LexArgs a = args;
    const int m = this->m, n = this->n, nc = this->nc, jc = this->jc, ri = this->ri, rr = this->rr;
    const bool has = this->has, st = this->st, hasr = this->hasr;
    const T cc = this->cc, blo = this->blo, bhi = this->bhi, rlo = this->rlo, rhi = this->rhi;
    T lo, hi;
    const int lane = this->lane, nw = this->nw, warp = this->warp;
    T *const win_t = this->win_t, *const xbw = this->xbw, *const fin_t = this->fin_t;
    int *const win_i = this->win_i, *const fin_i = this->fin_i;
    T *const w_t1 = this->w_t1, *const w_t2 = this->w_t2, *const w_xb = this->w_xb,
             *const w_cb1 = this->w_cb1, *const w_cbb = this->w_cbb, *const w_cz = this->w_cz;
    const int j = jc;
    const T INF = T(INFINITY);
    const T ft = a.ft, ct = a.ct, pt = a.pt, prog = a.prog;
    // ---- the node's LP: start -------------------------------------
    // (each thread reads only its own column's stack entries)
    lo = st ? slo[j] : (has ? blo : T(0));
    hi = st ? shi[j] : (has ? bhi : T(0));
    const bool lof = isfinite(lo), hif = isfinite(hi);
    const bool fre = !lof && !hif;
    const T zlo = lof ? lo : (hif ? hi : T(0));
    const T zup = hif ? hi : zlo;
    const T span = (lof && hif) ? __dsub_rn(hi, lo) : INF;
    bool inb = !st, atu = st && !lof && hif;
    const T z0 = st ? zlo : T(0);
    w_cz[lane] = st ? __dmul_rn(cc, atu ? zup : zlo) : T(0);
    if (ri < MR) w_cbb[ri] = T(0);  // the logical columns' costs
    T t[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i)
      t[i] = (i < m && has) ? -__ldg(a.W + (size_t)i * nc + j) : T(0);
    ck.tick(0);
    // x_B = -T0 z0 with T0 = -W: row rr's window `warp` by lane rr of
    // each warp (window_terms over the rounded products, the pads +0),
    // then each row's chain of its windows' sums
    {
      const T* Wr = a.W + (size_t)rr * nc;
      const int jw0 = warp * XLA_WINDOW - pad_low(nc);
      T acc = T(0);
#pragma unroll
      for (int l0 = 0; l0 < XLA_WINDOW; l0 += 8) {
        T wv[8], zv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int jj = jw0 + l0 + i;
          wv[i] = (jj >= 0 && jj < nc) ? -__ldg(Wr + jj) : T(0);
          zv[i] = __shfl_sync(FULL, z0, l0 + i);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int jj = jw0 + l0 + i;
          const T term = (jj >= 0 && jj < nc) ? __dmul_rn(wv[i], zv[i]) : T(0);
          acc = l0 + i == 0 ? term : __dadd_rn(acc, term);
        }
      }
      if (ri < MR) xbw[warp * MR + ri] = acc;
    }
    const int empty = __syncthreads_or(has && lo > __dadd_rn(hi, ft));
    T xB, bl = rlo, bh = rhi;
    int basis = n + rr;
    {
      T acc = xbw[rr];
#pragma unroll
      for (int w = 1; w < RB_MAX_WARPS; ++w)
        if (w < nw) acc = __dadd_rn(acc, xbw[w * MR + rr]);
      xB = -acc;
    }

    int status = empty ? INFEASIBLE : RUNNING;
    int it = 0, stall = 0, stall_e = 0;
    bool p1 = true, p1n = true;
    T last = INF, last_e = INF, infeas = T(0), cbx = T(0);
    unsigned bwm = 0, abm = 0;  // bit i: row i below / above its bounds
    ck.tick(1);

    // the row terms of the step about to start, into the warp's copies
    // (with each column's objective term, written before the call), its
    // three row sums as chains from row 0, and its phase test
    auto rows_and_sums = [&]() {
      const bool bw = xB < __dsub_rn(bl, ft);
      const bool ab = xB > __dadd_rn(bh, ft);
      bwm = __ballot_sync(FULL, bw);
      abm = __ballot_sync(FULL, ab);
      if (ri < MR) {
        w_t1[ri] = bw ? __dsub_rn(bl, xB) : T(0);
        w_t2[ri] = ab ? __dsub_rn(xB, bh) : T(0);
        w_xb[ri] = xB;
        w_cb1[ri] = __dsub_rn(T(ab), T(bw));
      }
      __syncwarp();
      const double2* p1v = reinterpret_cast<const double2*>(w_t1);
      const double2* p2v = reinterpret_cast<const double2*>(w_t2);
      const double2* pxv = reinterpret_cast<const double2*>(w_xb);
      const double2* pcv = reinterpret_cast<const double2*>(w_cbb);
      T s_lo = T(0), s_hi = T(0);
#pragma unroll
      for (int i2 = 0; i2 < MR / 2; ++i2) {
        const double2 u = p1v[i2], v = p2v[i2], x = pxv[i2], c = pcv[i2];
        const int i = 2 * i2;
        if (i < m) {
          s_lo = i == 0 ? u.x : __dadd_rn(s_lo, u.x);
          s_hi = i == 0 ? v.x : __dadd_rn(s_hi, v.x);
          cbx = i == 0 ? __dmul_rn(c.x, x.x) : __fma_rn(c.x, x.x, cbx);
        }
        if (i + 1 < m) {
          s_lo = __dadd_rn(s_lo, u.y);
          s_hi = __dadd_rn(s_hi, v.y);
          cbx = __fma_rn(c.y, x.y, cbx);
        }
      }
      infeas = __dadd_rn(s_lo, s_hi);
      p1n = p1 && infeas > ft;  // phase 1 ends once feasible
      const bool entered = p1 && !p1n;
      stall_e = entered ? 0 : stall;
      last_e = entered ? INF : last;
    };
    rows_and_sums();
    bool run = status == RUNNING && it < a.max_iters;
    int par = 0;  // the step's buffer
    ck.tick(10);
    // ---- the steps --------------------------------------------------
    while (run) {
      const bool sp1n = p1n, bland = stall >= a.stall_limit;
      // pricing: c_B (the phase-1 costs or c[basis], the warp's copy) .
      // T[:, j], each column's reduced cost, eligibility and score
      const double2* ce = reinterpret_cast<const double2*>(sp1n ? w_cb1 : w_cbb);
      T acc = T(0);
#pragma unroll
      for (int i2 = 0; i2 < MR / 2; ++i2) {
        const double2 c = ce[i2];
        const int i = 2 * i2;
        if (i < m) acc = i == 0 ? __dmul_rn(c.x, t[0]) : __fma_rn(c.x, t[i], acc);
        if (i + 1 < m) acc = __fma_rn(c.y, t[i + 1], acc);
      }
      const T d = __dsub_rn(sp1n ? T(0) : cc, acc);
      const T ad = fabs(d);
      const bool elig = has && !inb && (fre ? ad > ct : (atu ? d : -d) > ct);
      const T score = elig ? (bland ? -T(jc) : ad) : (bland ? T(-BIG) : T(-1));
      T bv = has ? score : -INF;
      int bj = has ? jc : INT_MAX;
      ck.tick(2);
      // the warp's window of the objective's nonbasic part, with the
      // step's starting flags: the chain over its 32 terms (pads +0)
      T czw;
      {
        const double2* zc = reinterpret_cast<const double2*>(w_cz);
        czw = T(0);
#pragma unroll
        for (int i2 = 0; i2 < XLA_WINDOW / 2; ++i2) {
          const double2 u = zc[i2];
          czw = i2 == 0 ? u.x : __dadd_rn(czw, u.x);
          czw = __dadd_rn(czw, u.y);
        }
      }
      ck.tick(5);
      best_of<XLA_WINDOW>(bv, bj);
      const int anyw = __any_sync(FULL, elig);
      ck.tick(3);
      // the warp's winner publishes its values and its column
      T* slot = win_t + ((size_t)par * nw + warp) * SLOT;
      int* sloti = win_i + ((size_t)par * nw + warp) * RB_SLOT_I;
      if (has && jc == bj) {
        slot[0] = bv;
        slot[1] = d;
        slot[2] = cc;
        slot[3] = lo;
        slot[4] = hi;
        slot[5] = span;
        slot[6] = inb ? T(0) : (atu ? zup : zlo);
        slot[7] = czw;
#pragma unroll
        for (int i = 0; i < MR; i += 2)
          *reinterpret_cast<double2*>(slot + RB_SLOT_T + i) = make_double2(t[i], t[i + 1]);
        sloti[0] = bj;
        sloti[1] = anyw;
        sloti[2] = atu;
      }
      __syncthreads();
      // the block's winner, in every thread; the objective's windows
      const T* sw = win_t + (size_t)par * nw * SLOT;
      const int* swi = win_i + (size_t)par * nw * RB_SLOT_I;
      int wq = 0, qc = swi[0], anyq = swi[1];
      T qv = sw[0], czv_all = sw[7];
#pragma unroll
      for (int w = 1; w < RB_MAX_WARPS; ++w) {
        if (w < nw) {
          const T ov = sw[w * SLOT];
          const int oj = swi[w * RB_SLOT_I];
          const bool bt = wins(ov, oj, qv, qc);
          qv = bt ? ov : qv;
          qc = bt ? oj : qc;
          wq = bt ? w : wq;
          anyq |= swi[w * RB_SLOT_I + 1];
          czv_all = __dadd_rn(czv_all, sw[w * SLOT + 7]);
        }
      }
      const T* qs = sw + wq * SLOT;
      const T dq = qs[1], cq = qs[2], loq = qs[3], hiq = qs[4], spanq = qs[5], zq = qs[6];
      const bool atuq = swi[wq * RB_SLOT_I + 2] != 0;
      const T ar = qs[RB_SLOT_T + rr];
      const T czv = sp1n ? T(0) : czv_all;
      ck.tick(4);

      // the ratio test: row rr's by its lane; the least ratio
      const T sigma = dq < T(0) ? T(1) : T(-1);  // up on d < 0
      const bool bwr = (bwm >> rr) & 1u, abr = (abm >> rr) & 1u;
      const T eta = __dmul_rn(-sigma, ar);
      const T ae = fabs(eta);
      const bool ng = eta < T(0);
      const T num = ng ? __dsub_rn(xB, abr ? bh : bl) : __dsub_rn(bwr ? bl : bh, xB);
      const bool valid = ae > pt && !(ng ? bwr : abr);
      const T rd = div_rn(valid ? num : T(1), valid ? ae : T(1));
      const T rq = valid ? rd : INF;
      const T rc = rq < T(0) ? T(0) : rq;
      T mn = hasr ? rc : INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mn = fmin(mn, __shfl_xor_sync(FULL, mn, off));
      ck.tick(6);
      // the least ratio and, among the rows tied with it, the one of
      // largest |eta| (Bland: the lowest basic column)
      const T tie = __dadd_rn(mn, ft);
      T pv = -INF;
      int r = INT_MAX;
      if (hasr) {
        pv = rc <= tie ? (bland ? -T(basis) : ae) : (bland ? T(-BIG) : T(-1));
        r = ri;
      }
      best_of<32>(pv, r);
      const T ratio_r = __shfl_sync(FULL, rc, r);
      const T piv = __shfl_sync(FULL, ar, r);
      const int p_col = __shfl_sync(FULL, basis, r);
      ck.tick(7);

      // the step's outcome, the bound flags, the objective watermark
      const bool row_blocks = mn < spanq;
      const T theta = row_blocks ? ratio_r : spanq;
      const int code = p1n ? 1 : 0;  // INFEASIBLE = 1, OPTIMAL = 0
      status = anyq ? (isfinite(theta) ? RUNNING : UNBOUNDED - code) : code;
      const bool moves = status == RUNNING;
      const bool do_pivot = moves && row_blocks, do_flip = moves && !row_blocks;
      const bool leave_up =
          __dmul_rn(-sigma, piv) < T(0) ? ((abm >> r) & 1u) : !((bwm >> r) & 1u);
      const T newval = __dadd_rn(zq, __dmul_rn(sigma, theta));
      {
        const bool hp = has && jc == p_col, hq = has && jc == qc;
        if (do_pivot) {
          if (hp) {
            atu = leave_up;
            inb = false;
          }
          if (hq) inb = true;
        } else if (hq) {
          atu = atuq ^ do_flip;
        }
        const T zn = inb ? T(0) : (atu ? zup : zlo);
        if ((do_pivot && hp) || hq) w_cz[lane] = __dmul_rn(cc, zn);
      }
      const T cur = p1n ? infeas : __dadd_rn(cbx, czv);
      const bool progressed = cur < __dsub_rn(last_e, prog);
      stall = progressed ? 0 : stall_e + 1;
      last = cur < last_e ? cur : last_e;
      p1 = p1n;
      it += 1;
      ck.tick(8);

      // the step: row rr's basic value along eta; a pivot's row takes
      // q's value, bounds and cost (the warp's copy), and every column
      // its rank-1 update (the next step's row sums before it, so that
      // its division overlaps them; past the last step they are unread)
      {
        T v = ri == 0 ? __dadd_rn(xB, __dmul_rn(eta, theta)) : __fma_rn(eta, theta, xB);
        const bool pv_row = do_pivot && ri == r;
        v = pv_row ? newval : v;
        basis = pv_row ? qc : basis;
        bl = pv_row ? loq : bl;
        bh = pv_row ? hiq : bh;
        xB = moves ? v : xB;
        if (pv_row) w_cbb[r] = cq;
      }
      ck.tick(9);
      run = status == RUNNING && it < a.max_iters;
      rows_and_sums();
      ck.tick(10);
      if (do_pivot) {
        // every row of the build, then row r's value
        const T rj = div_rn(reg_at<false>(t, r), fabs(piv) > T(0) ? piv : T(1));
        const double2* al = reinterpret_cast<const double2*>(qs + RB_SLOT_T);
#pragma unroll
        for (int i2 = 0; i2 < MR / 2; ++i2) {
          const double2 u = al[i2];
          t[2 * i2] = __fma_rn(-u.x, rj, t[2 * i2]);
          t[2 * i2 + 1] = __fma_rn(-u.y, rj, t[2 * i2 + 1]);
        }
        reg_at<true>(t, r, rj);
      }
      par ^= 1;
      ck.tick(9);
    }
    // ---- finish: x, the objective c . z ------------------------------
    T zj = inb ? T(0) : (atu ? zup : zlo);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int bi = __shfl_sync(FULL, basis, i);
      zj = i < m && jc == bi ? w_xb[i] : zj;
    }
    // the warp's window of the rounded products c z, and its most
    // fractional integer column
    const T objw = col_sum<XLA_WINDOW>(has ? __dmul_rn(cc, zj) : T(0), XLA_WINDOW);
    T fv, fx;
    int fj;
    frac_best<32>(zj, fv, fj, fx);
    if (lane == 0) {
      fin_t[3 * warp] = objw;
      fin_t[3 * warp + 1] = fv;
      fin_t[3 * warp + 2] = fx;
      fin_i[warp] = fj;
    }
    __syncthreads();
    T obj = fin_t[0];
    fv = fin_t[1];
    fx = fin_t[2];
    fj = fin_i[0];
#pragma unroll
    for (int w = 1; w < RB_MAX_WARPS; ++w) {
      if (w < nw) {
        obj = __dadd_rn(obj, fin_t[3 * w]);
        const T ov = fin_t[3 * w + 1], ox = fin_t[3 * w + 2];
        const int oj = fin_i[w];
        const bool bt = frac_wins(ov, oj, fv, fj);
        fv = bt ? ov : fv;
        fj = bt ? oj : fj;
        fx = bt ? ox : fx;
      }
    }
    const int lp_status = status == RUNNING ? ITER_LIMIT : status;
    ck.tick(11);
    this->lo = lo;
    this->hi = hi;
    return {lp_status, obj, it, fv, fj, fx};
  }
};

// ---- the host ------------------------------------------------------------------

using LexKernelFn = decltype(&lex_bnb_kernel<DenseEngine<SHAPE_PACKED>>);

template <int SHAPE>
LexKernelFn dense_kernel_for(int, int) {
  return lex_bnb_kernel<DenseEngine<SHAPE>>;
}

// the regs shape's build for an LP of m rows and n structural columns that
// it takes: MR rows of registers, CW threads a column group
LexKernelFn lex_regs_kernel_for(int m, int n) {
  if (n + m <= 16 && m <= 4) return lex_bnb_kernel<RegsEngine<4, 16>>;
  return m <= 8 ? lex_bnb_kernel<RegsEngine<8, REGS_COLS>>
                : lex_bnb_kernel<RegsEngine<REGS_ROWS, REGS_COLS>>;
}

// the regs_block shape's build for an LP of m rows that it takes
LexKernelFn lex_regs_block_kernel_for(int m, int) {
  return regs_block_rows(m) == 24 ? lex_bnb_kernel<RegsBlockEngine<24>>
                                  : lex_bnb_kernel<RegsBlockEngine<RB_ROWS>>;
}

bool regs_launch(int m, int n, int, int) { return regs_takes(m, n); }
bool regs_block_launch(int m, int n, int threads, int P) {
  return regs_block_takes(m, n) && P == 1 && threads == 32 * windows(n + m);
}

// The launch table, by shape code: the K5 shape whose plan check and grid
// a launch takes (a block per P lanes, or C blocks a lane), the limits of
// K6's own engines on the LP and the block (none on K5's shapes), and the
// build for an LP of m rows and n structural columns.
struct LexShape {
  int grid;
  bool (*takes)(int m, int n, int threads, int P);
  LexKernelFn (*build)(int m, int n);
};
const LexShape LEX_SHAPES[] = {
    {SHAPE_PACKED, nullptr, dense_kernel_for<SHAPE_PACKED>},
    {SHAPE_BLOCK, nullptr, dense_kernel_for<SHAPE_BLOCK>},
    {SHAPE_CLUSTER, nullptr, dense_kernel_for<SHAPE_CLUSTER>},
    {SHAPE_GLOBAL, nullptr, dense_kernel_for<SHAPE_GLOBAL>},
    {SHAPE_PACKED, regs_launch, lex_regs_kernel_for},             // SHAPE_REGS
    {SHAPE_BLOCK, regs_block_launch, lex_regs_block_kernel_for},  // SHAPE_REGS_BLOCK
};
constexpr int LEX_N_SHAPES = sizeof(LEX_SHAPES) / sizeof(LEX_SHAPES[0]);

// The plan's launch configuration and build, after checking it: 0, or the
// CUDA error the launch would meet.
int lex_config(int shape, int m, int n, int batch, int C, int threads, int P,
               cudaStream_t stream, cudaLaunchConfig_t* cfg,
               cudaLaunchAttribute* attr, LexKernelFn* kern) {
  static bool raised[MAX_DEVICES][K5_N_SHAPES] = {};
  if (shape < 0 || shape >= LEX_N_SHAPES) return (int)cudaErrorInvalidValue;
  const LexShape& S = LEX_SHAPES[shape];
  if (S.takes != nullptr && !S.takes(m, n, threads, P)) return (int)cudaErrorInvalidValue;
  const int err = check_plan(S.grid, m, n, batch, C, threads, P);
  if (err) return err;
  *kern = S.build(m, n);
  const size_t bytes = lex_smem_bytes(shape, m, n, C, P);
  if (shape < K5_N_SHAPES)
    return shape_config(*kern, raised, shape, batch, C, threads, P, bytes, stream, cfg, attr);
  // K6's own shapes take a few KB, under the default limit: no opt-in
  plan_config(S.grid, batch, C, threads, P, bytes, stream, cfg, attr);
  return 0;
}

}  // namespace

extern "C" {

// A block's dynamic shared bytes under a plan (shape 0 packed, 1 block, 2
// cluster, 3 global, 4 regs, 5 regs_block), for the wrapper's check of its
// own arithmetic.
long long lex_bnb_smem_bytes(int shape, int m, int n, int C, int P) {
  return (long long)lex_smem_bytes(shape, m, n, C, P);
}

// How many clusters of C blocks of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters; blocks for C = 1), or minus the CUDA
// error.
int lex_bnb_max_clusters(int shape, int m, int n, int C, int threads, int P) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  LexKernelFn kern;
  const int err = lex_config(shape, m, n, 1, C, threads, P, 0, &cfg, attr, &kern);
  return err ? -err : active_clusters(kern, &cfg);
}

// The build a plan launches: its registers a thread and its local (spilled)
// bytes a thread, as nvcc left them; 0, or the CUDA error (a plan the
// kernel refuses: cudaErrorInvalidValue).
int lex_bnb_attrs(int shape, int m, int n, int C, int threads, int P, int* regs,
                  int* local_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  LexKernelFn kern;
  const int err = lex_config(shape, m, n, 1, C, threads, P, 0, &cfg, attr, &kern);
  if (err) return err;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

#ifdef K6_CLOCKS
// Where a -DK6_CLOCKS build's lanes write their cycles by part (lane b at
// K6_N_PARTS b), or null (none written); 0, or the CUDA error.
int lex_bnb_set_clocks(void* p) {
  unsigned long long* q = static_cast<unsigned long long*>(p);
  return (int)cudaMemcpyToSymbol(k6_clocks, &q, sizeof(q));
}
#endif

// Launches K6 on `stream` as the wrapper's plan says: shape 0 (packed, P
// lanes a block of 32 P threads; 4, regs, the same), 1 (a block of
// `threads` a lane; 5, regs_block, the same with 32 windows(n + m)
// threads), 2 (a cluster of C such blocks a lane), 3 (global: shape 2 with
// the tableau slices in `tab`, batch x C x m x pitch values, pitch = slice_of(n + m, C,
// 0).pitch, and the node's rows in `rows`, batch x C x (3 (n + m) + n)
// values; both null for the other shapes).  `stack` holds batch x 2 x maxn
// x n values.  All pointers are device pointers: W (m, n + m), rhs (batch,
// k) and C (k, n), lb/ub (n), row_lb/row_ub (m - k) float64, perm (batch,
// k) int64, is_int (n) and obj_integral (k) bytes; outputs status/ips
// (batch) int32, results (batch, k), nodes and iters (batch) int64.
// Returns 0 on success, else the CUDA error of the launch (a plan that does
// not fit is refused before it).
int lex_bnb_launch(const void* W, int m, int n, int k, int batch,
                   const void* rhs, const void* perm, const void* C_obj,
                   const void* lb, const void* ub, const void* row_lb,
                   const void* row_ub, const void* is_int,
                   const void* obj_integral, int is_min, int maxn,
                   int max_bnb_nodes, int max_iters, double feas_tol,
                   double cost_tol, double pivot_tol, double progress_tol,
                   int stall_limit, int shape, int C, int threads, int P,
                   void* stack, void* tab, void* rows, void* status,
                   void* results, void* ips, void* nodes, void* iters,
                   void* stream) {
  if (batch <= 0) return 0;
  if (k < 1 || k > m || maxn < 1 || stack == nullptr ||
      (shape == SHAPE_GLOBAL && (tab == nullptr || rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  LexKernelFn kern;
  int err = lex_config(shape, m, n, batch, C, threads, P,
                       static_cast<cudaStream_t>(stream), &cfg, attr, &kern);
  if (err) return err;
  LexArgs a;
  a.W = static_cast<const double*>(W);
  a.m = m;
  a.n = n;
  a.k = k;
  a.batch = batch;
  a.rhs = static_cast<const double*>(rhs);
  a.perm = static_cast<const long long*>(perm);
  a.C = static_cast<const double*>(C_obj);
  a.lb = static_cast<const double*>(lb);
  a.ub = static_cast<const double*>(ub);
  a.row_lb = static_cast<const double*>(row_lb);
  a.row_ub = static_cast<const double*>(row_ub);
  a.is_int = static_cast<const unsigned char*>(is_int);
  a.obj_integral = static_cast<const unsigned char*>(obj_integral);
  a.is_min = is_min;
  a.maxn = maxn;
  a.max_bnb_nodes = max_bnb_nodes;
  a.max_iters = max_iters;
  a.ft = feas_tol;
  a.ct = cost_tol;
  a.pt = pivot_tol;
  a.prog = progress_tol;
  a.stall_limit = stall_limit;
  a.csize = C;
  a.stack = static_cast<double*>(stack);
  a.tab = static_cast<double*>(tab);
  a.rows = static_cast<double*>(rows);
  a.status = static_cast<int*>(status);
  a.results = static_cast<long long*>(results);
  a.ips = static_cast<int*>(ips);
  a.nodes = static_cast<long long*>(nodes);
  a.iters = static_cast<long long*>(iters);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
