// K5 on Hopper: the whole loop of the dense bounded-variable simplex of
// moip_aira_tpu_torch/solver/simplex_dense.py (DenseLPSolver: start, steps
// and finish) in one launch, each lane on a warp, a block or a thread-block
// cluster as the launch plan says, in float32 or float64.
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
// (a few to a few hundred) a step is a chain of dependent latencies: a
// column's pricing chain of m multiply-adds, the arg-max over the columns,
// the ratio test and row pick over the rows, and the three serial row sums
// of the next step, with barriers between them.  What the design does about
// it (solver/cuda_dense.py::dense_loop_plan picks the shape per launch):
//   packed   a warp a lane, P lanes a block, for m <= 32 rows and nc <= 128
//            columns: the columns strided over the warp's threads, every
//            barrier a __syncwarp and every reduction a shuffle, so a lane
//            that stops leaves its block's other lanes running;
//   block    a block a lane with the whole tableau in shared memory;
//   cluster  a lane on a cluster of C blocks: block r keeps the columns of
//            the windows [r wpb, r wpb + wpb) of the padded nc-long sums
//            (wpb = ceil(windows(nc) / C)), so each window of the
//            objective's column sums lies in one block, with the slices of
//            every nc-long vector; each block publishes its pricing winner,
//            that column and its windows' sums into every block's shared
//            memory (distributed shared memory) before the one cluster
//            barrier of the step, two buffers alternating by parity, and
//            every block then takes the same step on identical row state;
//   global   the cluster shape with each block's tableau slice in a global
//            scratch (the rest in shared memory as on a cluster), the last
//            resort for an LP whose slice fits no block of a cluster of 8
//            (2AP50 and larger in float64, 2AP60 and larger in float32).
// In every shape a step is: pricing of the block's columns, which first
// applies the last pivot's rank-1 update to each column (the same values as
// the update and then the pricing), a thread a column, with the windows of
// the objective's nonbasic part on the threads past the columns; the block's
// arg-max and one barrier (and the cluster's exchange); then warp 0 alone
// runs everything over the rows -- the ratio test, the row pick, the
// outcome, the basic values' step, and the next step's row terms, its three
// row sums side by side (a window a thread) and its phase test -- and one
// barrier ends the step.  A step has two barriers on a block, a cluster
// barrier more on a cluster, and none past __syncwarp in the packed shape.
//
// The loop itself, dense_lane, lives in simplex_dense_core.cuh, which K6
// (lex_bnb.cu) runs at every node of a lane's branch and bound; this file
// is its one-pass kernel.  Built with -DK5_CLOCKS (tools/k5_bench.py only),
// thread 0 of each lane also counts the SM cycles of each part of its run
// (K5Part); the production build is unchanged.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsimplex_dense.so simplex_dense.cu

#include "simplex_dense_core.cuh"

namespace {

// Each lane once through dense_lane: on warp (threadIdx.x / 32) of block
// blockIdx.x, P lanes a block (packed); on one block (block); on the `csize`
// blocks of a cluster (cluster; global, the tableau slice of block rank r at
// tab_g + (lane csize + r) m pitch).
template <class T, int SHAPE>
__device__ __forceinline__ void simplex_dense_body(
    const T* __restrict__ W, int m, int n, int batch, const T* __restrict__ c_g,
    const T* __restrict__ lo_g, const T* __restrict__ hi_g,
    const unsigned char* __restrict__ active, int max_iters, T ft, T ct, T pt,
    T prog, int stall_limit, int csize, T* tab_g, int* status_o, T* obj_o,
    T* x_o, long long* basis_o, unsigned char* atu_o, int* iters_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool PK = SHAPE == SHAPE_PACKED;
  constexpr bool CL = SHAPE == SHAPE_CLUSTER || SHAPE == SHAPE_GLOBAL;
  const int nc = n + m;
  const int C = CL ? csize : 1;
  const int warp = threadIdx.x >> 5;
  const int b = PK ? blockIdx.x * (blockDim.x >> 5) + warp
                   : (CL ? blockIdx.x / C : blockIdx.x);
  if (PK && b >= batch) return;  // no block barrier in the packed shape
  int rank = 0;
  if constexpr (CL) rank = (int)cg::this_cluster().block_rank();
  const size_t lane_bytes = k5_layout(SHAPE, m, nc, C, (int)sizeof(T)).total;
  unsigned char* base = smem + (PK ? (size_t)warp * lane_bytes : 0);
  T* tab = SHAPE == SHAPE_GLOBAL
               ? tab_g + ((size_t)b * C + rank) * m * slice_of(nc, C, 0).pitch
               : nullptr;
  const LaneResult<T> res = dense_lane<T, SHAPE>(
      base, W, m, n, csize, c_g + (size_t)b * nc, lo_g + (size_t)b * nc,
      hi_g + (size_t)b * nc, active == nullptr || active[b], max_iters, ft, ct,
      pt, prog, stall_limit, tab, x_o, basis_o, atu_o, b);
  if (rank == 0 && (PK ? (threadIdx.x & 31) : threadIdx.x) == 0) {
    status_o[b] = res.status;
    obj_o[b] = res.obj;
    iters_o[b] = res.iters;
  }
}

#define K5_PARAMS                                                             \
  const T *__restrict__ W, int m, int n, int batch, const T *__restrict__ c_g, \
      const T *__restrict__ lo_g, const T *__restrict__ hi_g,                  \
      const unsigned char *__restrict__ active, int max_iters, T ft, T ct,     \
      T pt, T prog, int stall_limit, int csize, T *tab_g, int *status_o,       \
      T *obj_o, T *x_o, long long *basis_o, unsigned char *atu_o, int *iters_o
#define K5_ARGS                                                            \
  W, m, n, batch, c_g, lo_g, hi_g, active, max_iters, ft, ct, pt, prog,     \
      stall_limit, csize, tab_g, status_o, obj_o, x_o, basis_o, atu_o, iters_o

// The packed and block shapes, several blocks an SM where the lanes are
// many: their registers are bounded by the block size alone (one resident
// block an SM gained them nothing, tools/k5_bench.py).
template <class T, int SHAPE>
__global__ void __launch_bounds__(K5_MAX_THREADS)
    simplex_dense_kernel(K5_PARAMS) {
  simplex_dense_body<T, SHAPE>(K5_ARGS);
}

// The cluster and global shapes, one resident block an SM: without it
// ptxas held their float64 kernels to 128 registers and spilled (136-150
// bytes; 6-14% slower at 2AP40 and 2AP60, tools/k5_bench.py), with it they
// take 174-177 and spill nothing.
template <class T, int SHAPE>
__global__ void __launch_bounds__(K5_MAX_THREADS, 1)
    simplex_dense_split_kernel(K5_PARAMS) {
  simplex_dense_body<T, SHAPE>(K5_ARGS);
}

#undef K5_PARAMS
#undef K5_ARGS

template <class T>
using K5Kernel = decltype(&simplex_dense_kernel<T, SHAPE_PACKED>);

// The plan's launch configuration, after checking it: 0, or the CUDA error
// the launch would meet.
template <class T>
int k5_config(int shape, int m, int n, int batch, int C, int threads, int P,
              cudaStream_t stream, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr, K5Kernel<T>* kern) {
  static bool raised[MAX_DEVICES][K5_N_SHAPES] = {};
  const int err = check_plan(shape, m, n, batch, C, threads, P);
  if (err) return err;
  *kern = shape == SHAPE_PACKED    ? simplex_dense_kernel<T, SHAPE_PACKED>
          : shape == SHAPE_BLOCK   ? simplex_dense_kernel<T, SHAPE_BLOCK>
          : shape == SHAPE_CLUSTER ? simplex_dense_split_kernel<T, SHAPE_CLUSTER>
                                   : simplex_dense_split_kernel<T, SHAPE_GLOBAL>;
  return shape_config(*kern, raised, shape, batch, C, threads, P,
                      k5_smem_bytes(shape, m, n + m, C, P, (int)sizeof(T)),
                      stream, cfg, attr);
}

template <class T>
int k5_max_clusters(int shape, int m, int n, int C, int threads, int P) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  K5Kernel<T> kern;
  const int err = k5_config<T>(shape, m, n, 1, C, threads, P, 0, &cfg, attr, &kern);
  return err ? -err : active_clusters(kern, &cfg);
}

template <class T>
int k5_launch(const void* W, int m, int n, int batch, const void* c,
              const void* lo, const void* hi, const void* active,
              int max_iters, double feas_tol, double cost_tol,
              double pivot_tol, double progress_tol, int stall_limit,
              int shape, int C, int threads, int P, void* scratch,
              void* status, void* obj, void* x, void* basis, void* at_upper,
              void* iters, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  K5Kernel<T> kern;
  int err = k5_config<T>(shape, m, n, batch, C, threads, P,
                         static_cast<cudaStream_t>(stream), &cfg, attr, &kern);
  if (err) return err;
  if (shape == SHAPE_GLOBAL && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(W), m, n, batch,
      static_cast<const T*>(c), static_cast<const T*>(lo),
      static_cast<const T*>(hi), static_cast<const unsigned char*>(active),
      max_iters, static_cast<T>(feas_tol), static_cast<T>(cost_tol),
      static_cast<T>(pivot_tol), static_cast<T>(progress_tol), stall_limit,
      C, static_cast<T*>(scratch), static_cast<int*>(status),
      static_cast<T*>(obj), static_cast<T*>(x),
      static_cast<long long*>(basis), static_cast<unsigned char*>(at_upper),
      static_cast<int*>(iters));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The card's limits the launch plans of K5 and K6 read: the dynamic shared
// bytes a block may opt into (the plan sets STATIC_SMEM_RESERVE of them
// aside) and the number of SMs.  Returns 0 or a CUDA error.
int simplex_dense_device_limits(int* smem_optin, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// A block's dynamic shared bytes under a plan (shape 0 packed, 1 block, 2
// cluster, 3 global) for values of `dsize` bytes (for the wrapper's check of its own
// arithmetic).
long long simplex_dense_smem_bytes(int dsize, int shape, int m, int n, int C,
                                   int P) {
  return (long long)k5_smem_bytes(shape, m, n + m, C, P, dsize);
}

// How many clusters of C blocks of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters; blocks for C = 1), or minus the CUDA
// error.
int simplex_dense_max_clusters(int dsize, int shape, int m, int n, int C,
                               int threads, int P) {
  if (dsize == 4) return k5_max_clusters<float>(shape, m, n, C, threads, P);
  if (dsize == 8) return k5_max_clusters<double>(shape, m, n, C, threads, P);
  return -(int)cudaErrorInvalidValue;
}

// Launches K5 on `stream` as the wrapper's plan says, in float32 (dsize 4)
// or float64 (8): shape 0 (packed, P lanes a block of 32 P threads), 1 (a
// block of `threads` a lane), 2 (a cluster of C such blocks a lane) or 3
// (global: shape 2 with the tableau in `scratch`, batch x C x m x pitch
// values, pitch = slice_of(n + m, C, 0).pitch; null for the other shapes);
// returns 0 on success, else the CUDA error (a plan that does not fit is
// refused before the launch).  All pointers are device pointers: W (m,
// n+m), c/lo/hi (batch, n+m) in the dtype, active (batch) bytes or null;
// outputs status/iters (batch) i32, obj (batch) and x (batch, n) in the
// dtype, basis (batch, m) i64, at_upper (batch, n+m) bytes.
int simplex_dense_launch(int dsize, const void* W, int m, int n, int batch,
                         const void* c, const void* lo, const void* hi,
                         const void* active, int max_iters, double feas_tol,
                         double cost_tol, double pivot_tol,
                         double progress_tol, int stall_limit, int shape,
                         int C, int threads, int P, void* scratch,
                         void* status, void* obj, void* x, void* basis,
                         void* at_upper, void* iters, void* stream) {
  if (batch <= 0) return 0;
  if (dsize == 4)
    return k5_launch<float>(W, m, n, batch, c, lo, hi, active, max_iters,
                            feas_tol, cost_tol, pivot_tol, progress_tol,
                            stall_limit, shape, C, threads, P, scratch, status,
                            obj, x, basis, at_upper, iters, stream);
  if (dsize == 8)
    return k5_launch<double>(W, m, n, batch, c, lo, hi, active, max_iters,
                             feas_tol, cost_tol, pivot_tol, progress_tol,
                             stall_limit, shape, C, threads, P, scratch,
                             status, obj, x, basis, at_upper, iters, stream);
  return (int)cudaErrorInvalidValue;
}

#ifdef K5_CLOCKS
// Where the next launches write each lane's cycles by part: (batch,
// K5_N_PARTS) unsigned 64-bit (null: nowhere).
int simplex_dense_set_clocks(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return (int)cudaMemcpyToSymbol(k5_clocks, &p, sizeof(p));
}
#endif

}  // extern "C"

