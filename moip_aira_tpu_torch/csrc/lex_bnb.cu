// K6 on Hopper: the lex backend's whole batch in one launch.  Each lane is
// one lexicographic solve of moip_aira_tpu_torch/solver/lex_torch.py
// (LexKernel: for each stage of its objective permutation, a depth-first
// branch and bound over a fixed stack of (lo, hi) rows whose every node is
// a cold LP solve of the dense simplex), in float64, on a warp, a block or
// a thread-block cluster as the launch plan says.
//
// This kernel replaces no Pallas kernel: the JAX package runs this batch
// (moip_aira_tpu/solver/lex_jax.py: a vmap over the lanes of a lax.scan
// over the stages of a lax.while_loop over the B&B nodes, each node
// simplex_jax's lax.while_loop) as one XLA program on the device.  Its
// plain version, which the tests and chip_smoke.py hold it against lane by
// lane, is LexKernel's loop on the CPU.
//
// What it computes, per lane, in the plain version's order of operations:
// for stage s, j = perm[s], c = +-C[j] (sign by the sense), and if the lane
// is alive and has met no resource limit, the B&B: pop the top row, solve
// its LP (dense_lane of simplex_dense_core.cuh, K5's loop, from the logical
// basis, over [node bounds, row bounds, objective rows bounded by srhs]),
// then
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
// and its IP count.  A lane whose perm names an objective outside [0, k)
// runs no stage and reports LEX_BAD_PERM (4), with no IP, node or LP step.  Every float64 operation of its own is rounded on its
// own (__dadd_rn, __dsub_rn, __dmul_rn), so nvcc's contraction of a * b + c
// changes no prune; the LPs are K5's, bit for bit with the plain loop.  It
// also counts each lane's nodes and LP steps over all its stages.
//
// What bounds it on this card: the LPs, node after node, each a chain of
// dependent step latencies (simplex_dense.cu), with the lanes' nodes
// diverging.  What the design does about it: a lane's nodes run back to
// back in one launch, with no host between them (the host loop it replaces
// launched K5 once a B&B step and read the device twice); an LP of at most
// 16 rows and 32 columns runs in K6's own shape, regs (a warp a lane, the
// whole LP in the warp's registers, each step a chain of shuffles with no
// memory access and no barrier; below); one of at most 32 rows and 33 to
// 128 columns in its second, regs_block (a block a lane, a warp a window of
// 32 columns, the LP in registers, one block barrier a step; below); a
// larger one on K5's plan, the
// tableau and the node's rows in shared memory (packed: a warp a lane, each
// warp its own B&B with no block barrier; block; cluster: each block a
// slice of the columns, every decision taken from values every block holds
// equal; global: the tableau slices, and the node's rows, in a global
// scratch), with K6's own shared bytes counted.
//
// On a cluster, each block holds the node's full rows (the LP's start reads
// every column) but pushes only its slice of the children; it publishes its
// slice's most fractional column, that column's x and its fraction into
// every block's shared memory before a cluster barrier, so every block
// takes the same winner and the same decisions and all leave the stage
// together.  The stack, one per lane in global memory (2 MAXN n values), is
// read and written through L2 (__ldcg, __stcg), each block's pushes fenced
// and followed by a cluster barrier before any block pops.
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
// (lex_bnb_regs_kernel, below), no shared memory
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

__host__ __device__ inline LexLayout lex_layout(int shape, int m, int n,
                                                int C) {
  LexLayout X{};
  size_t off = 0;
  auto take_b = [&](size_t bytes) {
    const size_t at = off;
    off += seg(bytes);
    return at;
  };
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
  X.total = off;
  return X;
}

// K6's second shape of its own, regs_block (lex_bnb_regs_block_kernel,
// below): a block a lane, the LP in its registers
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
  size_t off = 0;
  auto take_b = [&](size_t bytes) {
    const size_t at = off;
    off += seg(bytes);
    return at;
  };
  const size_t nw = windows(n + m), mr = regs_block_rows(m);
  X.win_t = take_b(2 * nw * (RB_SLOT_T + mr) * sizeof(double));
  X.win_i = take_b(2 * nw * RB_SLOT_I * sizeof(int));
  X.xbw = take_b(nw * mr * sizeof(double));
  X.fin_t = take_b(nw * 3 * sizeof(double));
  X.fin_i = take_b(nw * sizeof(int));
  X.rows = take_b(nw * (RB_WARP_ROWS * mr + XLA_WINDOW) * sizeof(double));
  X.total = off;
  return X;
}

// a lane's shared bytes: K5's part, then K6's
__host__ __device__ inline size_t lex_lane_bytes(int shape, int m, int n,
                                                 int C) {
  return k5_layout(shape, m, n + m, C, (int)sizeof(double)).total +
         lex_layout(shape, m, n, C).total;
}

// a block's dynamic shared bytes under a plan: P lanes' parts in the packed
// shape, else one lane's (its slice on a cluster)
__host__ __device__ inline size_t lex_smem_bytes(int shape, int m, int n,
                                                 int C, int P) {
  if (shape == SHAPE_REGS) return 0;
  if (shape == SHAPE_REGS_BLOCK) return rb_layout(m, n).total;
  const size_t lane = lex_lane_bytes(shape, m, n, C);
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

// Every block's pushes visible to every block of the lane before any pops
// (a cluster), or the lane's threads past their reads of the rows.
template <int SHAPE>
__device__ __forceinline__ void bnb_sync() {
  if constexpr (SHAPE == SHAPE_CLUSTER || SHAPE == SHAPE_GLOBAL) {
    __threadfence();
    cg::this_cluster().sync();
  } else {
    lane_sync<SHAPE>();
  }
}

// The lane's most fractional column (v its fraction, j its index, x its
// value), from each thread's candidate, in every thread: over the warp by
// shuffles, over the block's warps through `slot_t`/`slot_i`, over a
// cluster's blocks through every block's `mail_t`/`mail_i`, each block's
// winner published at its rank before the cluster barrier.
template <int SHAPE>
__device__ __forceinline__ void lane_frac_best(double& v, int& j, double& x,
                                               double* slot_t, int* slot_i,
                                               double* mail_t, int* mail_i,
                                               int C, int rank) {
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(FULL, v, off);
    const int oj = __shfl_xor_sync(FULL, j, off);
    const double ox = __shfl_xor_sync(FULL, x, off);
    if (frac_wins(ov, oj, v, j)) {
      v = ov;
      j = oj;
      x = ox;
    }
  }
  if constexpr (SHAPE != SHAPE_PACKED) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      slot_t[2 * warp] = v;
      slot_t[2 * warp + 1] = x;
      slot_i[warp] = j;
    }
    __syncthreads();
    v = slot_t[0];
    x = slot_t[1];
    j = slot_i[0];
    for (int w = 1; w < nw; ++w) {
      if (frac_wins(slot_t[2 * w], slot_i[w], v, j)) {
        v = slot_t[2 * w];
        x = slot_t[2 * w + 1];
        j = slot_i[w];
      }
    }
    if constexpr (SHAPE == SHAPE_CLUSTER || SHAPE == SHAPE_GLOBAL) {
      cg::cluster_group cluster = cg::this_cluster();
      if ((int)threadIdx.x < C) {
        double* mt = cluster.map_shared_rank(mail_t + 2 * rank, threadIdx.x);
        int* mi = cluster.map_shared_rank(mail_i + rank, threadIdx.x);
        mt[0] = v;
        mt[1] = x;
        *mi = j;
      }
      cluster.sync();
      v = mail_t[0];
      x = mail_t[1];
      j = mail_i[0];
      for (int r = 1; r < C; ++r) {
        if (frac_wins(mail_t[2 * r], mail_i[r], v, j)) {
          v = mail_t[2 * r];
          x = mail_t[2 * r + 1];
          j = mail_i[r];
        }
      }
    }
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

// One lane: on warp (threadIdx.x / 32) of block blockIdx.x, P lanes a block
// (packed); on one block (block); on the `csize` blocks of a cluster
// (cluster, global).  Every thread of every block of a lane keeps the
// lane's B&B state in registers, alike, from values they all hold.
template <int SHAPE>
__global__ void __launch_bounds__(K5_MAX_THREADS) lex_bnb_kernel(const LexArgs a) {
  using T = double;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool PK = SHAPE == SHAPE_PACKED;
  constexpr bool CL = SHAPE == SHAPE_CLUSTER || SHAPE == SHAPE_GLOBAL;
  const int m = a.m, n = a.n, k = a.k, nc = n + m;
  const int C = CL ? a.csize : 1;
  const int warp = threadIdx.x >> 5;
  const int b = PK ? blockIdx.x * (blockDim.x >> 5) + warp
                   : (CL ? blockIdx.x / C : blockIdx.x);
  if (PK && b >= a.batch) return;  // no block barrier in the packed shape
  int rank = 0;
  if constexpr (CL) rank = (int)cg::this_cluster().block_rank();
  const int tid = PK ? (threadIdx.x & 31) : threadIdx.x;
  const int nt = PK ? 32 : blockDim.x;
  const LexLayout X = lex_layout(SHAPE, m, n, C);
  const size_t k5_bytes = k5_layout(SHAPE, m, nc, C, (int)sizeof(T)).total;
  unsigned char* base = smem + (PK ? (size_t)warp * (k5_bytes + X.total) : 0);
  unsigned char* ext = base + k5_bytes;
  const Slice sl = slice_of(nc, C, rank);
  const size_t blk = (size_t)b * C + rank;  // the lane's block, among all
  T* row_c;
  T* row_lo;
  T* row_hi;
  T* row_x;
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
  T* tab = SHAPE == SHAPE_GLOBAL ? a.tab + blk * m * sl.pitch : nullptr;
  T* slot_t = reinterpret_cast<T*>(ext + X.slot_t);
  int* slot_i = reinterpret_cast<int*>(ext + X.slot_i);
  T* mail_t = reinterpret_cast<T*>(ext + X.mail_t);
  int* mail_i = reinterpret_cast<int*>(ext + X.mail_i);
  T* stk_lo = a.stack + (size_t)b * 2 * a.maxn * n;  // [maxn][n]
  T* stk_hi = stk_lo + (size_t)a.maxn * n;
  // the structural columns whose stack entries this block writes
  const int js0 = imin(sl.j0, n), js1 = imin(sl.j1, n);
  const int mk = m - k;  // the constraint rows; the k objective rows follow
  const T INF = T(INFINITY);

  // the rows' logical part: c 0, the constraint rows' bounds, and the
  // objective rows bounded by srhs (above for a minimisation, below for a
  // maximisation), which the stages tighten in place
  for (int i = tid; i < m; i += nt) {
    row_c[n + i] = T(0);
    if (i < mk) {
      row_lo[n + i] = a.row_lb[i];
      row_hi[n + i] = a.row_ub[i];
    } else {
      const T r = a.rhs[(size_t)b * k + (i - mk)];
      row_lo[n + i] = a.is_min ? -INF : r;
      row_hi[n + i] = a.is_min ? r : INF;
    }
  }
  if (rank == 0)
    for (int s = tid; s < k; s += nt) a.results[(size_t)b * k + s] = 0;
  // C[perm[s]] would read past the objectives: the lane runs no stage (the
  // plain version raises before it runs); every thread of every block of
  // the lane reads the same perm and leaves together
  bool bad_perm = false;
  for (int s = 0; s < k; ++s) {
    const long long j = a.perm[(size_t)b * k + s];
    bad_perm = bad_perm || j < 0 || j >= k;
  }
  if (bad_perm) {
    if (rank == 0 && tid == 0) {
      a.status[b] = LEX_BAD_PERM;
      a.ips[b] = 0;
      a.nodes[b] = 0;
      a.iters[b] = 0;
    }
    return;
  }
  bool alive = true, resource = false;
  int ips = 0;
  long long nodes_all = 0, iters_all = 0;
  const T sgn = a.is_min ? T(1) : T(-1);

  for (int s = 0; s < k; ++s) {
    const int j = (int)a.perm[(size_t)b * k + s];
    const bool active = alive && !resource;
    bool found = false, res_s = false;
    T best = INF;
    if (active) {
      const bool oint = a.obj_integral[j] != 0;
      const T tol = oint ? INT_TOL : REAL_TOL;
      for (int jj = tid; jj < n; jj += nt)
        row_c[jj] = __dmul_rn(sgn, a.C[(size_t)j * n + jj]);
      for (int jj = js0 + tid; jj < js1; jj += nt) {
        __stcg(stk_lo + jj, a.lb[jj]);
        __stcg(stk_hi + jj, a.ub[jj]);
      }
      bnb_sync<SHAPE>();
      int sp = 1, nodes = 0;
      bool unbounded = false;
      while (sp > 0 && !res_s && !unbounded) {
        const int sp1 = sp - 1;
        const T* slo = stk_lo + (size_t)sp1 * n;
        const T* shi = stk_hi + (size_t)sp1 * n;
        for (int jj = tid; jj < n; jj += nt) {
          row_lo[jj] = __ldcg(slo + jj);
          row_hi[jj] = __ldcg(shi + jj);
        }
        lane_sync<SHAPE>();
        const LaneResult<T> out = dense_lane<T, SHAPE>(
            base, a.W, m, n, a.csize, row_c, row_lo, row_hi, true, a.max_iters,
            a.ft, a.ct, a.pt, a.prog, a.stall_limit, tab, row_x, nullptr,
            nullptr, 0);
        nodes += 1;
        nodes_all += 1;
        iters_all += out.iters;

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
        lane_frac_best<SHAPE>(fv, fj, fx, slot_t, slot_i, mail_t, mail_i, C, rank);

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
          // (the DFS explores down first), this block's slice of each
          T* up_lo = stk_lo + (size_t)sp1 * n;
          T* dn_lo = stk_lo + (size_t)(sp1 + 1) * n;
          T* dn_hi = stk_hi + (size_t)(sp1 + 1) * n;
          for (int jj = js0 + tid; jj < js1; jj += nt) {
            if (jj == fj) __stcg(up_lo + jj, __dadd_rn(fl, T(1)));
            __stcg(dn_lo + jj, row_lo[jj]);
            __stcg(dn_hi + jj, jj == fj ? fl : row_hi[jj]);
          }
          sp = sp1 + 2;
        } else {
          sp = sp1;
        }
        res_s = res1;
        bnb_sync<SHAPE>();
      }
      found = isfinite(best) && !res_s;
    }
    // the stage's value: the lane's result and its objective row's bound
    if (alive && found) {
      const T val = rint(a.is_min ? best : -best);
      if (rank == 0 && tid == 0) a.results[(size_t)b * k + j] = (long long)val;
      if (tid == 0) {
        if (a.is_min)
          row_hi[n + mk + j] = val;
        else
          row_lo[n + mk + j] = val;
      }
    }
    ips += active ? 1 : 0;
    alive = alive && found;
    resource = resource || res_s;
    lane_sync<SHAPE>();
  }
  if (rank == 0 && tid == 0) {
    a.status[b] =
        resource ? LEX_RESOURCE : (alive ? LEX_OPTIMAL : LEX_INFEASIBLE);
    a.ips[b] = ips;
    a.nodes[b] = nodes_all;
    a.iters[b] = iters_all;
  }
}

// ---- the regs shape: a warp a lane, the node's LP in its registers ----------
//
// K6's own shape (K5 has none such): for an LP of m <= REGS_ROWS rows and
// nc <= REGS_COLS columns, one warp runs one lane, P lanes a block, and
// every value of a node's LP lives in the warp's registers.  Thread t holds
// column t mod CW (CW = 16 or 32 >= nc; with 16, threads t and t + 16 hold
// the same column): the column's m tableau values, c, lo, hi, its values at each bound, the bound flip's length, its
// objective term, its free / in-basis / at-upper flags.  Rows: with at most
// MR = 8 of them, every thread holds every row's x_B, bounds and basic
// column, so the row sums, the ratio minimum, the row pick and the basic
// values' step take no shuffle (one division a thread: its own row's
// ratio, shuffled to all); with up to 16, thread i holds row i (mod MR),
// and the minimum and the row pick are butterflies over the MR row
// threads.  The rows' costs c_B and below/above flags (as bit masks) and
// the entering column are alike in every thread, and so are the phase, the
// stall count, the watermark and the step's outcome.  So a step touches no
// memory and passes no barrier but its shuffles: pricing from registers;
// the column arg-max a butterfly over the CW threads that hold a column;
// the winner's column and values shuffled from their owner; the
// objective's nonbasic sum as a shuffle chain from column 0, the plain
// loop's order for at most 32 terms.
// Every shuffle is unconditional (its count compile-time): a shuffle under
// a branch is split from its neighbours by the compiler's convergence
// check, and a step is bound by its instruction count and latencies.  The
// last pivot's rank-1 update is done at the end of its step, not fused
// into the next pricing: the same operations on the same values.  A node's
// start reads its stack row (each thread its own columns', so no thread
// reads what another wrote) and W's columns and rows (through L1; W is the
// launch's one read-only array); its finish gathers x and the objective by
// shuffles.  Every float64 operation is dense_lane's in its order and
// rounding, so each lane's outputs and counts are the other shapes'.  MR
// and CW are compile-time, so the arrays stay in registers;
// lex_regs_kernel_for picks the instantiation.

constexpr int REGS_ROWS = 16;  // rows: the tableau's registers a thread
constexpr int REGS_COLS = 32;  // columns: one a thread

// the parts of a regs lane's run that a -DK6_CLOCKS build counts, in SM
// cycles of its first thread, summed over its nodes and steps: a node's
// start (its stack row, W's columns, the column constants) and its x_B;
// per step pricing, the column arg-max, the winner's values, the
// objective's nonbasic sum, the ratio test with its minimum, the row pick,
// the outcome, the basic values' step with the rank-1 update, the next
// step's row sums; a node's finish (x, the objective) and its B&B part
// (the most fractional column, the children)
#ifdef K6_CLOCKS
constexpr int K6_N_PARTS = 13;
__device__ unsigned long long* k6_clocks;
#define K6_CLOCK_DECL \
  unsigned long long ck_[K6_N_PARTS] = {}; long long ck_t_ = clock64();
#define K6_TICK(part)                                \
  do {                                               \
    const long long t_ = clock64();                  \
    ck_[part] += (unsigned long long)(t_ - ck_t_);   \
    ck_t_ = t_;                                      \
  } while (0)
#define K6_CLOCK_STORE(on, lane)                                   \
  do {                                                             \
    if ((on) && k6_clocks != nullptr)                              \
      for (int p_ = 0; p_ < K6_N_PARTS; ++p_)                      \
        k6_clocks[(size_t)(lane) * K6_N_PARTS + p_] = ck_[p_];     \
  } while (0)
#else
#define K6_CLOCK_DECL
#define K6_TICK(part) \
  do {                \
  } while (0)
#define K6_CLOCK_STORE(on, lane) \
  do {                           \
  } while (0)
#endif

// whether the regs shape takes an LP of m rows and n structural columns
__host__ __device__ inline bool regs_takes(int m, int n) {
  return m >= 1 && n >= 0 && m <= REGS_ROWS && n + m <= REGS_COLS;
}

// The chain over the nc <= CW columns of each column's values u[j] and
// (TWO) w[j], shuffled from the column's thread (every one of the CW, so
// no shuffle waits on a branch) eight columns ahead of their links: acc = first(u[0], w[0]), then acc = link(acc, u[j], w[j]).
// xla_sum's and xla_dot's order for one item.
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

template <int MR, int CW>
__global__ void __launch_bounds__(32 * K5_MAX_PACK)
    lex_bnb_regs_kernel(const LexArgs a) {
  using T = double;
  // the rows alike in every thread (MR <= 8: their few values in each
  // thread's registers), else row i in thread i
  constexpr bool REP = MR <= 8;
  constexpr int RR = REP ? MR : 1;  // the rows a thread keeps
  const int m = a.m, n = a.n, k = a.k, nc = n + m;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= a.batch) return;  // no barrier but the warp's own
  constexpr int Gm = MR;           // the threads a row group spans
  const int jc = lane & (CW - 1);  // this thread's column
  const bool has = jc < nc;        // ... that exists
  const bool sint = jc < n && a.is_int[jc] != 0;  // ... an integer structural one
  const int ri = lane & (Gm - 1);  // this thread's row
  const bool hasr = ri < m;
  const int rr = hasr ? ri : m - 1;
  const int mk = m - k;
  const T INF = T(INFINITY);
  const T ft = a.ft, ct = a.ct, pt = a.pt, prog = a.prog;
  T* stk_lo = a.stack + (size_t)b * 2 * a.maxn * n;  // [maxn][n]
  T* stk_hi = stk_lo + (size_t)a.maxn * n;

  // row rr's logical bounds: the constraint row's, or the objective row's
  // by srhs, which the stages tighten
  T rlo, rhi;
  if (rr < mk) {
    rlo = a.row_lb[rr];
    rhi = a.row_ub[rr];
  } else {
    const T r = a.rhs[(size_t)b * k + (rr - mk)];
    rlo = a.is_min ? -INF : r;
    rhi = a.is_min ? r : INF;
  }
  if (lane == 0)
    for (int s = 0; s < k; ++s) a.results[(size_t)b * k + s] = 0;
  bool bad_perm = false;
  for (int s = 0; s < k; ++s) {
    const long long j = a.perm[(size_t)b * k + s];
    bad_perm = bad_perm || j < 0 || j >= k;
  }
  if (bad_perm) {
    if (lane == 0) {
      a.status[b] = LEX_BAD_PERM;
      a.ips[b] = 0;
      a.nodes[b] = 0;
      a.iters[b] = 0;
    }
    return;
  }
  bool alive = true, resource = false;
  int ips = 0;
  long long nodes_all = 0, iters_all = 0;
  const T sgn = a.is_min ? T(1) : T(-1);
  K6_CLOCK_DECL

  for (int s = 0; s < k; ++s) {
    const int jo = (int)a.perm[(size_t)b * k + s];
    const bool active = alive && !resource;
    bool found = false, res_s = false;
    T best = INF;
    if (active) {
      const bool oint = a.obj_integral[jo] != 0;
      const T tol = oint ? INT_TOL : REAL_TOL;
      // the stage's costs (0 on the logical columns), the logical columns'
      // bounds from their rows' threads, and the root's bounds on the stack
      const int j = jc;
      const T cc = j < n ? __dmul_rn(sgn, a.C[(size_t)jo * n + j]) : T(0);
      const int src = (has && j >= n) ? j - n : 0;
      const T blo = __shfl_sync(FULL, rlo, src);
      const T bhi = __shfl_sync(FULL, rhi, src);
      if (j < n) {
        stk_lo[j] = a.lb[j];
        stk_hi[j] = a.ub[j];
      }
      __syncwarp();
      int sp = 1, nodes = 0;
      bool unbounded = false;
      while (sp > 0 && !res_s && !unbounded) {
        const int sp1 = sp - 1;
        // ---- the node's LP: start -------------------------------------
        const T lo = j < n ? stk_lo[(size_t)sp1 * n + j] : blo;
        const T hi = j < n ? stk_hi[(size_t)sp1 * n + j] : bhi;
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
        K6_TICK(0);
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
        K6_TICK(1);

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
        K6_TICK(10);
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
          K6_TICK(2);
          best_of<CW>(bv, bj);
          const bool anyq = __any_sync(FULL, elig);
          K6_TICK(3);
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
          K6_TICK(4);
          // the objective's nonbasic part, with the step's starting flags
          // (in both phases, so its chain interleaves with the ratio test)
          const T czv_all = col_sum<CW>(cz, nc);
          const T czv = sp1n ? T(0) : czv_all;
          K6_TICK(5);

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
            K6_TICK(6);
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
            K6_TICK(6);
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
          K6_TICK(7);

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
          K6_TICK(8);

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
          K6_TICK(9);
          run = status == RUNNING && it < a.max_iters;
          rows_and_sums();
          K6_TICK(10);
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
          K6_TICK(9);
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
        K6_TICK(11);
        nodes += 1;
        nodes_all += 1;
        iters_all += it;

        // ---- the B&B node: the most fractional integer column ------------
        T fv = T(-1), fx = T(0);
        int fj = INT_MAX;
        if (jc < n) {
          const T f = sint ? fabs(__dsub_rn(zj, rint(zj))) : T(0);
          const bool w = frac_wins(f, jc, fv, fj);
          fv = w ? f : fv;
          fj = w ? jc : fj;
          fx = w ? zj : fx;
        }
#pragma unroll
        for (int off = CW / 2; off > 0; off >>= 1) {
          const T ov = __shfl_xor_sync(FULL, fv, off);
          const int oj = __shfl_xor_sync(FULL, fj, off);
          const T ox = __shfl_xor_sync(FULL, fx, off);
          const bool w = frac_wins(ov, oj, fv, fj);
          fv = w ? ov : fv;
          fj = w ? oj : fj;
          fx = w ? ox : fx;
        }

        bool res1 = nodes > a.max_bnb_nodes || lp_status == ITER_LIMIT;
        unbounded = lp_status == UNBOUNDED;
        bool push = false;
        T fl = T(0);
        if (lp_status == OPTIMAL) {
          const T bound = oint ? ceil(__dsub_rn(obj, INT_TOL)) : obj;
          const bool pruned = bound >= __dsub_rn(best, tol);
          const bool integral = fv <= INT_TOL;
          const bool improves = obj < __dsub_rn(best, INT_TOL);
          if (!pruned && integral && improves) best = obj;
          const bool branch = !pruned && !integral;
          const bool overflow = branch && sp1 + 2 > a.maxn;
          res1 = res1 || overflow;
          push = branch && !overflow;
          fl = floor(__dadd_rn(fx, INT_TOL));
        }
        if (push) {
          // the "up" child in the node's place, the "down" child on top,
          // each thread its own columns
          T* up_lo = stk_lo + (size_t)sp1 * n;
          T* dn_lo = stk_lo + (size_t)(sp1 + 1) * n;
          T* dn_hi = stk_hi + (size_t)(sp1 + 1) * n;
          if (j < n) {
            if (j == fj) up_lo[j] = __dadd_rn(fl, T(1));
            dn_lo[j] = lo;
            dn_hi[j] = j == fj ? fl : hi;
          }
          sp = sp1 + 2;
        } else {
          sp = sp1;
        }
        res_s = res1;
        __syncwarp();  // the stack's rows, for the duplicate threads' reads
        K6_TICK(12);
      }
      found = isfinite(best) && !res_s;
    }
    // the stage's value: the lane's result and its objective row's bound
    if (alive && found) {
      const T val = rint(a.is_min ? best : -best);
      if (lane == 0) a.results[(size_t)b * k + jo] = (long long)val;
      if (rr == mk + jo) {
        if (a.is_min)
          rhi = val;
        else
          rlo = val;
      }
    }
    ips += active ? 1 : 0;
    alive = alive && found;
    resource = resource || res_s;
  }
  K6_CLOCK_STORE(lane == 0, b);
  if (lane == 0) {
    a.status[b] = resource ? LEX_RESOURCE : (alive ? LEX_OPTIMAL : LEX_INFEASIBLE);
    a.ips[b] = ips;
    a.nodes[b] = nodes_all;
    a.iters[b] = iters_all;
  }
}

// ---- the regs_block shape: a block a lane, the node's LP in its registers ---
//
// K6's second shape of its own, for an LP of at most RB_ROWS rows and 33 to
// RB_COLS columns (more than a warp's threads): one block of NW =
// windows(nc) warps runs one lane, and every tableau value lives in the
// block's registers.  Thread t holds column t - pad_low(nc), so warp w holds
// exactly window w of the padded nc-long sums, and pad threads hold no
// column (their terms are the +0s window_terms adds): the column's MR
// tableau values, c, lo, hi, its values at each bound, the flip's length and
// its flags.  Lane i of every warp holds row i's x_B, bounds and basic
// column, so each warp computes the ratio test, its minimum and the row
// pick (butterflies) and the row sums (chains from row 0) alike, with no
// barrier; the rows' terms and costs c_B, and the warp's columns' objective
// terms, which every thread of the warp reads in its chains, lie in the
// warp's own copies in shared memory (a __syncwarp, no block barrier, and
// the reads two values at a time).  The column axis crosses warps through
// shared memory only: each step, each warp's arg-max winner publishes its
// score, its values, its whole tableau column and its warp's window of the
// objective's nonbasic sum into the step's buffer (two, by the step's
// parity), before the step's one block barrier; then every thread takes
// the same winner by `wins` and chains the NW window sums (xla_sum's
// order).  A pivot's rank-1 update runs over all MR rows of the build
// without a branch a row: the rows past m hold +0 in every column and are
// never read.  A node's start
// (the basic values' windows) and finish (the objective's windows and each
// warp's most fractional column) take one barrier each.  No tableau value
// goes to shared memory but the winner's column.  Every float64 operation
// is dense_lane's for nc > 32, in its order and rounding, so each lane's
// outputs and counts are the other shapes'.  MR (24 or 32) is compile-time,
// so the tableau column stays in registers; NW is read from the block's
// size, so one build serves 2, 3 and 4 warps.

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
__global__ void __launch_bounds__(RB_COLS) lex_bnb_regs_block_kernel(const LexArgs a) {
  using T = double;
  constexpr int SLOT = RB_SLOT_T + MR;
  constexpr int WROW = RB_WARP_ROWS * MR + XLA_WINDOW;  // a warp's rows and terms
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m, n = a.n, k = a.k, nc = n + m;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int jc = (int)threadIdx.x - pad_low(nc);  // this thread's column
  const bool has = jc >= 0 && jc < nc;           // ... that exists
  const bool sint = has && jc < n && a.is_int[jc] != 0;
  const int ri = lane;  // this thread's row
  const bool hasr = ri < m;
  const int rr = hasr ? ri : m - 1;
  const int mk = m - k;
  const T INF = T(INFINITY);
  const T ft = a.ft, ct = a.ct, pt = a.pt, prog = a.prog;
  const RBLayout X = rb_layout(m, n);
  T* win_t = reinterpret_cast<T*>(smem + X.win_t);    // [2][nw][SLOT]
  int* win_i = reinterpret_cast<int*>(smem + X.win_i);  // [2][nw][RB_SLOT_I]
  T* xbw = reinterpret_cast<T*>(smem + X.xbw);        // [nw][MR]
  T* fin_t = reinterpret_cast<T*>(smem + X.fin_t);    // [nw][3]: obj, v, x
  int* fin_i = reinterpret_cast<int*>(smem + X.fin_i);  // [nw]: j
  // this warp's copies of the rows' terms (t1, t2, x_B, the phase-1 and
  // the phase-2 costs, MR each) and of its columns' objective terms
  T* w_t1 = reinterpret_cast<T*>(smem + X.rows) + (size_t)warp * WROW;
  T* w_t2 = w_t1 + MR;
  T* w_xb = w_t2 + MR;
  T* w_cb1 = w_xb + MR;
  T* w_cbb = w_cb1 + MR;
  T* w_cz = w_cbb + MR;
  T* stk_lo = a.stack + (size_t)b * 2 * a.maxn * n;  // [maxn][n]
  T* stk_hi = stk_lo + (size_t)a.maxn * n;

  // row rr's logical bounds, as the regs shape keeps them
  T rlo, rhi;
  if (rr < mk) {
    rlo = a.row_lb[rr];
    rhi = a.row_ub[rr];
  } else {
    const T r = a.rhs[(size_t)b * k + (rr - mk)];
    rlo = a.is_min ? -INF : r;
    rhi = a.is_min ? r : INF;
  }
  if (threadIdx.x == 0)
    for (int s = 0; s < k; ++s) a.results[(size_t)b * k + s] = 0;
  bool bad_perm = false;
  for (int s = 0; s < k; ++s) {
    const long long j = a.perm[(size_t)b * k + s];
    bad_perm = bad_perm || j < 0 || j >= k;
  }
  if (bad_perm) {
    if (threadIdx.x == 0) {
      a.status[b] = LEX_BAD_PERM;
      a.ips[b] = 0;
      a.nodes[b] = 0;
      a.iters[b] = 0;
    }
    return;
  }
  bool alive = true, resource = false;
  int ips = 0;
  long long nodes_all = 0, iters_all = 0;
  const T sgn = a.is_min ? T(1) : T(-1);
  K6_CLOCK_DECL

  for (int s = 0; s < k; ++s) {
    const int jo = (int)a.perm[(size_t)b * k + s];
    const bool active = alive && !resource;
    bool found = false, res_s = false;
    T best = INF;
    if (active) {
      const bool oint = a.obj_integral[jo] != 0;
      const T tol = oint ? INT_TOL : REAL_TOL;
      const int j = jc;
      const bool st = has && j < n;  // a structural column
      const T cc = st ? __dmul_rn(sgn, a.C[(size_t)jo * n + j]) : T(0);
      // a logical column's bounds: its row's, from the row's lane
      const int src = (has && j >= n) ? j - n : 0;
      const T blo = __shfl_sync(FULL, rlo, src);
      const T bhi = __shfl_sync(FULL, rhi, src);
      if (st) {
        stk_lo[j] = a.lb[j];
        stk_hi[j] = a.ub[j];
      }
      int sp = 1, nodes = 0;
      bool unbounded = false;
      while (sp > 0 && !res_s && !unbounded) {
        const int sp1 = sp - 1;
        // ---- the node's LP: start -------------------------------------
        // (each thread reads only its own column's stack entries)
        const T lo = st ? stk_lo[(size_t)sp1 * n + j] : (has ? blo : T(0));
        const T hi = st ? stk_hi[(size_t)sp1 * n + j] : (has ? bhi : T(0));
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
        K6_TICK(0);
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
        K6_TICK(1);

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
        K6_TICK(10);
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
          K6_TICK(2);
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
          K6_TICK(5);
          best_of<XLA_WINDOW>(bv, bj);
          const int anyw = __any_sync(FULL, elig);
          K6_TICK(3);
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
          K6_TICK(4);

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
          K6_TICK(6);
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
          K6_TICK(7);

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
          K6_TICK(8);

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
          K6_TICK(9);
          run = status == RUNNING && it < a.max_iters;
          rows_and_sums();
          K6_TICK(10);
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
          K6_TICK(9);
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
        T fv = T(-1), fx = T(0);
        int fj = INT_MAX;
        if (st) {
          const T f = sint ? fabs(__dsub_rn(zj, rint(zj))) : T(0);
          const bool w = frac_wins(f, jc, fv, fj);
          fv = w ? f : fv;
          fj = w ? jc : fj;
          fx = w ? zj : fx;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_xor_sync(FULL, fv, off);
          const int oj = __shfl_xor_sync(FULL, fj, off);
          const T ox = __shfl_xor_sync(FULL, fx, off);
          const bool w = frac_wins(ov, oj, fv, fj);
          fv = w ? ov : fv;
          fj = w ? oj : fj;
          fx = w ? ox : fx;
        }
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
        K6_TICK(11);
        nodes += 1;
        nodes_all += 1;
        iters_all += it;

        // ---- the B&B node, as the regs shape's -----------------------------
        bool res1 = nodes > a.max_bnb_nodes || lp_status == ITER_LIMIT;
        unbounded = lp_status == UNBOUNDED;
        bool push = false;
        T fl = T(0);
        if (lp_status == OPTIMAL) {
          const T bound = oint ? ceil(__dsub_rn(obj, INT_TOL)) : obj;
          const bool pruned = bound >= __dsub_rn(best, tol);
          const bool integral = fv <= INT_TOL;
          const bool improves = obj < __dsub_rn(best, INT_TOL);
          if (!pruned && integral && improves) best = obj;
          const bool branch = !pruned && !integral;
          const bool overflow = branch && sp1 + 2 > a.maxn;
          res1 = res1 || overflow;
          push = branch && !overflow;
          fl = floor(__dadd_rn(fx, INT_TOL));
        }
        if (push) {
          // the "up" child in the node's place, the "down" child on top,
          // each thread its own column
          T* up_lo = stk_lo + (size_t)sp1 * n;
          T* dn_lo = stk_lo + (size_t)(sp1 + 1) * n;
          T* dn_hi = stk_hi + (size_t)(sp1 + 1) * n;
          if (st) {
            if (j == fj) up_lo[j] = __dadd_rn(fl, T(1));
            dn_lo[j] = lo;
            dn_hi[j] = j == fj ? fl : hi;
          }
          sp = sp1 + 2;
        } else {
          sp = sp1;
        }
        res_s = res1;
        K6_TICK(12);
      }
      found = isfinite(best) && !res_s;
    }
    // the stage's value: the lane's result and its objective row's bound
    if (alive && found) {
      const T val = rint(a.is_min ? best : -best);
      if (threadIdx.x == 0) a.results[(size_t)b * k + jo] = (long long)val;
      if (rr == mk + jo) {
        if (a.is_min)
          rhi = val;
        else
          rlo = val;
      }
    }
    ips += active ? 1 : 0;
    alive = alive && found;
    resource = resource || res_s;
  }
  K6_CLOCK_STORE(threadIdx.x == 0, b);
  if (threadIdx.x == 0) {
    a.status[b] = resource ? LEX_RESOURCE : (alive ? LEX_OPTIMAL : LEX_INFEASIBLE);
    a.ips[b] = ips;
    a.nodes[b] = nodes_all;
    a.iters[b] = iters_all;
  }
}

using LexKernelFn = decltype(&lex_bnb_kernel<SHAPE_PACKED>);

// the regs shape's instantiation for an LP of m rows and nc columns that it
// takes: MR rows of registers, CW threads a column group
LexKernelFn lex_regs_kernel_for(int m, int nc) {
  if (nc <= 16 && m <= 4) return lex_bnb_regs_kernel<4, 16>;
  return m <= 8 ? lex_bnb_regs_kernel<8, REGS_COLS> : lex_bnb_regs_kernel<REGS_ROWS, REGS_COLS>;
}

// the regs_block shape's instantiation for an LP of m rows that it takes
LexKernelFn lex_regs_block_kernel_for(int m) {
  return regs_block_rows(m) == 24 ? lex_bnb_regs_block_kernel<24>
                                  : lex_bnb_regs_block_kernel<RB_ROWS>;
}

// The plan's launch configuration, after checking it: 0, or the CUDA error
// the launch would meet.
int lex_config(int shape, int m, int n, int batch, int C, int threads, int P,
               cudaStream_t stream, cudaLaunchConfig_t* cfg,
               cudaLaunchAttribute* attr, LexKernelFn* kern) {
  static bool raised[MAX_DEVICES][K5_N_SHAPES] = {};
  if (shape == SHAPE_REGS) {  // a warp a lane and no shared memory
    if (!regs_takes(m, n) || batch <= 0 || C != 1 || P < 1 || P > K5_MAX_PACK ||
        threads != 32 * P)
      return (int)cudaErrorInvalidValue;
    *kern = lex_regs_kernel_for(m, n + m);
    plan_config(SHAPE_PACKED, batch, 1, threads, P, 0, stream, cfg, attr);
    return 0;
  }
  if (shape == SHAPE_REGS_BLOCK) {  // a block of windows(nc) warps a lane
    if (!regs_block_takes(m, n) || batch <= 0 || C != 1 || P != 1 ||
        threads != 32 * windows(n + m))
      return (int)cudaErrorInvalidValue;
    *kern = lex_regs_block_kernel_for(m);
    plan_config(SHAPE_BLOCK, batch, 1, threads, 1, rb_layout(m, n).total, stream, cfg, attr);
    return 0;
  }
  const int err = check_plan(shape, m, n, batch, C, threads, P);
  if (err) return err;
  *kern = shape == SHAPE_PACKED    ? lex_bnb_kernel<SHAPE_PACKED>
          : shape == SHAPE_BLOCK   ? lex_bnb_kernel<SHAPE_BLOCK>
          : shape == SHAPE_CLUSTER ? lex_bnb_kernel<SHAPE_CLUSTER>
                                   : lex_bnb_kernel<SHAPE_GLOBAL>;
  return shape_config(*kern, raised, shape, batch, C, threads, P,
                      lex_smem_bytes(shape, m, n, C, P), stream, cfg, attr);
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

#ifdef K6_CLOCKS
// Where a -DK6_CLOCKS build's regs lanes write their cycles by part (lane b
// at K6_N_PARTS b), or null (none written); 0, or the CUDA error.
int lex_bnb_set_clocks(void* p) {
  unsigned long long* q = static_cast<unsigned long long*>(p);
  return (int)cudaMemcpyToSymbol(k6_clocks, &q, sizeof(q));
}
#endif

// The regs shape's kernel for an LP of m rows and n structural columns:
// its registers a thread and its local (spilled) bytes a thread, as the
// build left them; 0, or the CUDA error (an LP the shape does not take:
// cudaErrorInvalidValue).
int lex_bnb_regs_attrs(int m, int n, int* regs, int* local_bytes) {
  if (!regs_takes(m, n)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, lex_regs_kernel_for(m, n + m));
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

// The regs_block shape's kernel for an LP of m rows and n structural
// columns: its registers and local bytes a thread, as lex_bnb_regs_attrs.
int lex_bnb_regs_block_attrs(int m, int n, int* regs, int* local_bytes) {
  if (!regs_block_takes(m, n)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, lex_regs_block_kernel_for(m));
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

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
