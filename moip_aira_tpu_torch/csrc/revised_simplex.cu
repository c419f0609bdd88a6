// K2 on Hopper: a batched bounded-variable REVISED primal simplex, one LP
// per thread-block cluster.
//
// Replaces moip_aira_tpu/solver/pallas_rev.py::make_pallas_rev_batch (the
// Pallas TPU kernel).  Its plain PyTorch version, which the tests and
// chip_smoke.py hold this kernel against, is
// moip_aira_tpu_torch/solver/simplex_torch.py::revised_lp_batch_ref.
//
// What it computes, per lane: the same pivots as K1 (dense_simplex.cu), but
// the lane carries only its basis inverse B^-1 (m x m, f32) and rebuilds
// the two tableau slices a pivot needs from the shared system matrix
// W = [diag(s) A | -I] (m x nc):
//   pricing    y = c_B^T B^-1, then d_j = c_j - y . W[:, j] for every column;
//   entering   alpha = B^-1 W[:, q];
//   pivot      the product-form rank-1 update of B^-1 on the leaving row.
// A warm lane (wb[0] >= 0) gathers its basis columns into P1 (m x m) and
// turns [P1 | -I] into [I | -B^-1] by Gauss-Jordan, each step on the
// (unassigned row, remaining basis entry) of largest |P1|, the first in
// row-major order on ties; a remainder with no entry above GJ_PIVOT_TOL is a
// singular basis and the lane starts cold.  Composite phase 1, Dantzig
// pricing that becomes Bland's rule after STALL_LIMIT pivots without
// progress, the ratio test with bound flips and the largest-|eta| (Bland:
// lowest basic column) tie-break, the basic bounds' +-BIG sentinels and the
// finalisation follow pallas_rev.py; ties break on the lowest index.
//
// What bounds it on this card.  The wave sends K2 a few lanes a launch (the
// 2AP40 front: 2,596 LPs in 479 launches), so a launch lasts as long as its
// slowest lane, pivots times one pivot's latency, and most SMs idle.  Every
// sum runs in index order with each multiply-add rounded twice, exactly as
// the plain version computes it, so the work of a pivot is a few serial
// chains of m dependent adds -- y (one chain per column of B^-1), pricing
// (one per column of W: m * nc multiply-adds, 552 KB of W at 2AP40's
// 82 x 1682, 8.2 MB at 2AP100's 202 x 10202), alpha (one per row), the
// phase-1 sum and the objective -- separated by block barriers.  With one
// block per lane, pricing streams all of W through one SM every pivot and
// is bound by that SM's share of L2 bandwidth and by the latency of its
// chains.
// What the design does about it: one lane runs on a cluster of C blocks
// (1 <= C <= 8) on C SMs.  Block r owns W's columns [r w, r w + w),
// w = ceil(nc / C), loads that slice into its shared memory once per
// launch when it fits (2AP40: 138 KB at C = 4, 69 KB at C = 8; else it
// streams the slice from W) and prices it every pivot, each thread running
// up to four columns' chains interleaved.  The blocks' winners meet in one
// arg-max through distributed shared memory (one cluster barrier a pivot),
// and the block that owns the entering column hands out W[:, q].  The
// m-sized work -- y, alpha, the ratio test, the rank-1 update, xB and the
// bookkeeping -- every block repeats identically on its own B^-1, so no
// other data crosses SMs.  Inside a block, y for both phases, the phase-1
// sum and the basic objective run side by side before the phase is known
// (rev_pivot_start), the rank-1 update steps through B^-1 without a
// division per element, and the reductions hand every thread the result
// without a second barrier: seven block barriers a pivot (the single-block
// design had eighteen).  B^-1, the W slice and the warm
// block P1 sit in dynamic shared memory as the launch plan says.  The
// wrapper (solver/cuda_lp.py::rev_launch_plan) picks C from the shape and
// the lane count, in Python; this file checks the plan and launches it.
// The basic solution and the final objective sum over columns in index
// order, which a column split cannot serve, so they read W and c from
// global memory, once per launch; the warm rebuild gathers from W too.
//
// The rebuild, the basic solution and the pivot's sub-steps live in
// revised_core.cuh, which K3 (bb_fragment.cu) runs in every B&B node, on a
// cluster of its own.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librevised_simplex.so revised_simplex.cu

#include "revised_core.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int ROW_VECTORS = 9;  // float vectors of m entries per lane

// dynamic shared bytes of the per-row and per-column vectors
size_t rev_vector_bytes(int m, int nc) {
  const size_t b = sizeof(float) * ROW_VECTORS * (size_t)m +
                   sizeof(int) * 2 * (size_t)m + 2 * (size_t)nc +
                   2 * (size_t)m;
  return (b + 15) & ~(size_t)15;
}

size_t square_bytes(int m) { return sizeof(float) * (size_t)m * m; }

__host__ __device__ int slice_width(int nc, int C) { return (nc + C - 1) / C; }

// a block's dynamic shared bytes under a launch plan (solver/cuda_lp.py's
// rev_smem_bytes computes the same)
size_t rev_smem_bytes(int m, int nc, int C, bool w_smem, bool bi_smem,
                      bool p1_smem) {
  return rev_vector_bytes(m, nc) + (bi_smem ? square_bytes(m) : 0) +
         (p1_smem ? square_bytes(m) : 0) +
         (w_smem ? sizeof(float) * (size_t)m * slice_width(nc, C) : 0);
}

// BI_S: B^-1 in shared memory (else the global scratch); W_S: the block's
// slice of W in shared memory (else read from W); p1_smem: the warm block
// P1 in shared memory (else the global scratch).  Blocks blockIdx.x =
// lane * csize + rank form lane's cluster.
template <bool BI_S, bool W_S>
// the register budget of one 512-thread block an SM (128 a thread)
__global__ void __launch_bounds__(MAX_THREADS, 1)
    revised_simplex_kernel(const float* __restrict__ W, int m, int n,
                           const float* __restrict__ c_g,
                           const float* __restrict__ lo_g,
                           const float* __restrict__ hi_g,
                           const int* __restrict__ wb_g,
                           const int* __restrict__ wa_g, int max_iters,
                           float feas_tol, float cost_tol, float pivot_tol,
                           int csize, int p1_smem, float* __restrict__ BI_g,
                           float* __restrict__ P1_g, float* __restrict__ z_g,
                           int* __restrict__ status_o,
                           float* __restrict__ obj_o, float* __restrict__ x_o,
                           int* __restrict__ basis_o, int* __restrict__ atup_o,
                           int* __restrict__ iters_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ RevScratch rs;
  __shared__ RevCand mail[2];
  __shared__ float s_sum, s_obj;

  const int nc = n + m;
  const int blk = blockIdx.x;
  const int b = blk / csize, rank = blk - (blk / csize) * csize;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane_off = (size_t)b * nc;
  const int mm = m * m;
  const float* c = c_g + lane_off;
  const float* lo = lo_g + lane_off;
  const float* hi = hi_g + lane_off;
  const int* wb = wb_g + (size_t)b * m;
  float* z = z_g + (size_t)blk * nc;  // nonbasic values, then the solution
  const int width = slice_width(nc, csize);
  const int j0 = min(nc, rank * width), j1 = min(nc, j0 + width);

  float* p = reinterpret_cast<float*>(smem_raw);
  float* BI;
  float* P1;
  float* ws = nullptr;
  if (BI_S) {
    BI = p;
    p += mm;
  } else {
    BI = BI_g + (size_t)blk * mm;
  }
  if (p1_smem) {
    P1 = p;
    p += mm;
  } else {
    P1 = P1_g + (size_t)blk * mm;
  }
  if (W_S) {
    ws = p;
    p += (size_t)m * width;
  }
  float* xB = p;
  p += m;
  float* bl = p;
  p += m;
  float* bh = p;
  p += m;
  float* cB = p;
  p += m;
  float* y = p;  // c_B^T B^-1; W z_N at the start
  p += m;
  float* alpha = p;  // entering column; the rebuild's pivot column
  p += m;
  float* ratio = p;
  p += m;
  float* rowdiv = p;  // pivot row of B^-1 over the pivot
  p += m;
  float* wq = p;  // W[:, q]; the rebuild's pivot row of P1 over the pivot
  p += m;
  int* ip = reinterpret_cast<int*>(p);
  int* basis = ip;
  ip += m;
  int* hits_up = ip;
  ip += m;
  unsigned char* bp = reinterpret_cast<unsigned char*>(ip);
  unsigned char* inb = bp;
  bp += nc;
  unsigned char* atup = bp;
  bp += nc;
  unsigned char* unassigned = bp;  // rebuild: rows not yet assigned
  bp += m;
  unsigned char* remaining = bp;  // rebuild: basis entries not yet placed

  const RevLane L{m,  n,  nc,    W,     c,      lo,     hi,     BI,
                  xB, bl, bh,    cB,    y,      alpha,  ratio,  rowdiv,
                  wq, basis, hits_up, inb, atup, &rs};
  const RevSplit S{j0, j1, width, ws, csize, mail};

  if (W_S) {
    const int wr = j1 - j0;
    for (int e = tid; e < m * width; e += nt) {
      const int k = e / width, jj = e - (e / width) * width;
      ws[e] = jj < wr ? W[(size_t)k * nc + j0 + jj] : 0.0f;
    }
  }
  for (int e = tid; e < mm; e += nt) {
    const int i = e / m;
    BI[e] = (e - i * m) == i ? -1.0f : 0.0f;
  }
  for (int i = tid; i < m; i += nt) basis[i] = n + i;

  // ---- warm start: Gauss-Jordan on [P1 | -I] ----------------------------
  bool use_warm = false;
  if (wb[0] >= 0) use_warm = rev_warm_rebuild(L, wb, P1, unassigned, remaining);
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
    z[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
    empty |= lo[j] > hi[j] + feas_tol;
  }
  for (int i = tid; i < m; i += nt) {
    const int col = basis[i];
    const float l = lo[col], h = hi[col];
    // the reference's sentinels: +-inf read as +-BIG, then back
    const float ls = isfinite(l) ? l : (l > 0.0f ? BIG : -BIG);
    const float hs = isfinite(h) ? h : (h > 0.0f ? BIG : -BIG);
    bl[i] = ls <= -BIG ? -INFINITY : ls;
    bh[i] = hs >= BIG ? INFINITY : hs;
    cB[i] = c[col];
  }
  empty = __syncthreads_or(empty);
  rev_basic_solution(L, z);

  // ---- pivot loop --------------------------------------------------------
  // Every thread of every block of the cluster holds the same status,
  // stall counter and last objective, so all leave the loop together.  The
  // objective of a pivot's result only feeds the stall counter, so it is
  // summed at the start of the next pivot, beside that pivot's phase-1 sum
  // and its y for either phase (rev_pivot_start).
  int status = empty ? INFEASIBLE : RUNNING;
  int stall = 0, it = 0;
  float last = INFINITY, prev_sum = 0.0f;
  bool prev_phase1 = false;
  for (; it < max_iters && status == RUNNING; ++it) {
    rev_pivot_start(L, feas_tol, it > 0 && !prev_phase1, &s_sum, &s_obj);
    if (it > 0) {
      const float cur = prev_phase1 ? prev_sum : s_obj;
      stall = cur < last - 1e-9f ? 0 : stall + 1;
      last = cur;
    }
    const float infeas_sum = s_sum;
    const bool phase1 = infeas_sum > feas_tol;
    const RevStep st =
        rev_pivot<W_S>(L, S, phase1, stall >= STALL_LIMIT, feas_tol, cost_tol,
                       pivot_tol, it & 1);
    status = st.status;
    prev_phase1 = phase1;
    prev_sum = infeas_sum;
  }

  // ---- finalize (block 0 of the cluster) ----------------------------------
  if (rank == 0) {
    for (int j = tid; j < nc; j += nt)
      z[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
    __syncthreads();
    for (int i = tid; i < m; i += nt) z[basis[i]] = xB[i];
    __syncthreads();
    for (int j = tid; j < nc; j += nt) {
      if (j < n) x_o[(size_t)b * n + j] = z[j];
      atup_o[lane_off + j] = atup[j];
    }
    for (int i = tid; i < m; i += nt) basis_o[(size_t)b * m + i] = basis[i];
    if (tid == 0) {
      float obj = 0.0f;
      for (int j = 0; j < nc; ++j) obj = __fadd_rn(obj, __fmul_rn(c[j], z[j]));
      status_o[b] = status == RUNNING ? ITER_LIMIT : status;
      obj_o[b] = obj;
      iters_o[b] = it;
    }
  }
  // no block leaves while another may still read its shared memory
  if (csize > 1) cg::this_cluster().sync();
}

using RevKernel = decltype(&revised_simplex_kernel<true, true>);

RevKernel rev_kernel(bool w_smem, bool bi_smem) {
  if (w_smem) return revised_simplex_kernel<true, true>;
  return bi_smem ? revised_simplex_kernel<true, false>
                 : revised_simplex_kernel<false, false>;
}

// The plan's launch configuration, after checking it: 0, or the CUDA error
// the launch would meet.
int rev_config(int m, int n, int batch, int C, int threads, int w_smem,
               int bi_smem, int p1_smem, cudaStream_t stream,
               cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
               RevKernel* kern) {
  const int nc = n + m;
  if (m <= 0 || n < 0 || batch <= 0 || C < 1 || C > MAX_CLUSTER ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      (w_smem && !bi_smem))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = rev_smem_bytes(m, nc, C, w_smem, bi_smem, p1_smem);
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  *kern = rev_kernel(w_smem, bi_smem);
  cudaError_t e = cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
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
// may opt into (what is left beside STATIC_SMEM_RESERVE bytes of static
// shared memory) and the number of SMs.  Returns 0 or a CUDA error.
int revised_simplex_device_limits(int* smem_optin, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// A block's dynamic shared bytes under a plan (for the wrapper's check of
// its own arithmetic).
long long revised_simplex_smem_bytes(int m, int n, int C, int w_smem,
                                     int bi_smem, int p1_smem) {
  return (long long)rev_smem_bytes(m, n + m, C, w_smem, bi_smem, p1_smem);
}

// How many clusters of the plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int revised_simplex_max_clusters(int m, int n, int C, int threads, int w_smem,
                                 int bi_smem, int p1_smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  RevKernel kern;
  int err = rev_config(m, n, 1, C, threads, w_smem, bi_smem, p1_smem, 0, &cfg,
                       attr, &kern);
  if (err) return -err;
  int count = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveClusters(&count, (const void*)kern, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// Launches one cluster of C blocks of `threads` threads per lane on
// `stream`, as the wrapper's plan says; returns 0 on success, else the CUDA
// error (a plan that does not fit, or that no SM group can hold, is refused
// before the launch).  All pointers are device pointers: W (m, n+m),
// c/lo/hi (batch, n+m) f32, wb (batch, m) i32 with -1 = cold, wa (batch,
// n+m) i32; scratch BI and P1 (batch * C, m, m) f32 where the plan keeps
// them out of shared memory (else ignored), z (batch * C, n+m) f32;
// outputs status/iters (batch) i32, obj (batch) f32, x (batch, n) f32,
// basis (batch, m) i32, at_upper (batch, n+m) i32.
int revised_simplex_launch(const void* W, int m, int n, int batch,
                           const void* c, const void* lo, const void* hi,
                           const void* wb, const void* wa, int max_iters,
                           float feas_tol, float cost_tol, float pivot_tol,
                           int C, int threads, int w_smem, int bi_smem,
                           int p1_smem, void* BI_scratch, void* P1_scratch,
                           void* z_scratch, void* status, void* obj, void* x,
                           void* basis, void* at_upper, void* iters,
                           void* stream) {
  if (batch <= 0) return 0;
  if (z_scratch == nullptr || (!p1_smem && P1_scratch == nullptr) ||
      (!bi_smem && BI_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  RevKernel kern;
  int err = rev_config(m, n, batch, C, threads, w_smem, bi_smem, p1_smem,
                       static_cast<cudaStream_t>(stream), &cfg, attr, &kern);
  if (err) return err;
  int count = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveClusters(&count, (const void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (count < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(W), m, n,
      static_cast<const float*>(c), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const int*>(wb),
      static_cast<const int*>(wa), max_iters, feas_tol, cost_tol, pivot_tol,
      C, p1_smem, static_cast<float*>(BI_scratch),
      static_cast<float*>(P1_scratch), static_cast<float*>(z_scratch),
      static_cast<int*>(status), static_cast<float*>(obj),
      static_cast<float*>(x), static_cast<int*>(basis),
      static_cast<int*>(at_upper), static_cast<int*>(iters));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
