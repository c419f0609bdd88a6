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
// launched K5 once a B&B step and read the device twice); the tableau and
// the node's rows stay in shared memory; the plan is K5's (packed: a warp a
// lane, each warp its own B&B with no block barrier; block; cluster: each
// block a slice of the columns, every decision taken from values every
// block holds equal; global: the tableau slices, and the node's rows, in a
// global scratch), with K6's own shared bytes counted.
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

using LexKernelFn = decltype(&lex_bnb_kernel<SHAPE_PACKED>);

// The plan's launch configuration, after checking it: 0, or the CUDA error
// the launch would meet.
int lex_config(int shape, int m, int n, int batch, int C, int threads, int P,
               cudaStream_t stream, cudaLaunchConfig_t* cfg,
               cudaLaunchAttribute* attr, LexKernelFn* kern) {
  static bool raised[MAX_DEVICES][K5_N_SHAPES] = {};
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
// cluster, 3 global), for the wrapper's check of its own arithmetic.
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

// Launches K6 on `stream` as the wrapper's plan says: shape 0 (packed, P
// lanes a block of 32 P threads), 1 (a block of `threads` a lane), 2 (a
// cluster of C such blocks a lane) or 3 (global: shape 2 with the tableau
// slices in `tab`, batch x C x m x pitch values, pitch = slice_of(n + m, C,
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
