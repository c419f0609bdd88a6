// K2 on Hopper: a batched bounded-variable REVISED primal simplex, one LP
// per block.
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
// What bounds it on this card: per pivot, m * nc multiply-adds of pricing
// against W, which no lane owns and which stays in the 50 MB L2 (552 KB at
// 2AP40's 82 x 1682, 8.2 MB at 2AP100's 202 x 10202), plus about 3 m^2 of
// work on B^-1 (y, alpha, the rank-1 update) and four block reductions
// (pricing arg-max, ratio minimum, row pick, and the serial phase-1 sum).
// Pricing dominates once nc >> m: the lane is bound by how fast one SM
// streams W from L2 through its multiply-add chains.
// What the design does about it: one thread block per lane, so a lane
// leaves its pivot loop on its own and only filled lanes are launched;
// threads own columns in pricing, so each step of the sum over rows reads
// consecutive W addresses (coalesced, L2-resident, shared by all lanes);
// B^-1 and its warm-start block P1 sit in dynamic shared memory when they
// fit, B^-1 alone when only it fits (2AP100: 163 KB), else both in a global
// scratch slice per lane -- one template parameter, chosen by shape; the
// per-column flags are bytes in shared memory and the per-column c, lo and
// hi are read from the inputs.  Every sum runs in index order and every
// multiply-add is rounded twice (no fused multiply-add), exactly as the
// plain PyTorch version computes them, so the two take the same pivots bit
// for bit.  Tensor-core pricing across lanes, several lanes per block and
// TMA are not used yet.
//
// The rebuild, the basic solution and the pivot's sub-steps live in
// revised_core.cuh, which K3 (bb_fragment.cu) runs in every B&B node.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librevised_simplex.so revised_simplex.cu

#include "revised_core.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int ROW_VECTORS = 10;  // float vectors of m entries per lane

// dynamic shared bytes of the per-row and per-column vectors
size_t rev_vector_bytes(int m, int nc) {
  const size_t b = sizeof(float) * ROW_VECTORS * (size_t)m +
                   sizeof(int) * 2 * (size_t)m + 2 * (size_t)nc +
                   2 * (size_t)m;
  return (b + 15) & ~(size_t)15;
}

size_t square_bytes(int m) { return sizeof(float) * (size_t)m * m; }

size_t rev_smem_bytes(int layout, int m, int nc) {
  return rev_vector_bytes(m, nc) + (layout >= 1 ? square_bytes(m) : 0) +
         (layout == 2 ? square_bytes(m) : 0);
}

// LAYOUT 2: B^-1 and P1 in shared memory; 1: B^-1 in shared memory, P1 in
// the global scratch; 0: both in the global scratch
template <int LAYOUT>
__global__ void __launch_bounds__(MAX_THREADS)
    revised_simplex_kernel(const float* __restrict__ W, int m, int n,
                           const float* __restrict__ c_g,
                           const float* __restrict__ lo_g,
                           const float* __restrict__ hi_g,
                           const int* __restrict__ wb_g,
                           const int* __restrict__ wa_g, int max_iters,
                           float feas_tol, float cost_tol, float pivot_tol,
                           float* __restrict__ BI_g, float* __restrict__ P1_g,
                           float* __restrict__ z_g, int* __restrict__ status_o,
                           float* __restrict__ obj_o, float* __restrict__ x_o,
                           int* __restrict__ basis_o, int* __restrict__ atup_o,
                           int* __restrict__ iters_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch red;
  __shared__ int s_status, s_stall, s_iters;
  __shared__ float s_last, s_sum, s_dq;

  const int nc = n + m;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane_off = (size_t)b * nc;
  const int mm = m * m;
  const float* c = c_g + lane_off;
  const float* lo = lo_g + lane_off;
  const float* hi = hi_g + lane_off;
  const int* wb = wb_g + (size_t)b * m;
  float* z = z_g + lane_off;  // nonbasic values, then the solution

  float* p = reinterpret_cast<float*>(smem_raw);
  float* BI;
  float* P1;
  if (LAYOUT >= 1) {
    BI = p;
    p += mm;
  } else {
    BI = BI_g + (size_t)b * mm;
  }
  if (LAYOUT == 2) {
    P1 = p;
    p += mm;
  } else {
    P1 = P1_g + (size_t)b * mm;
  }
  float* xB = p;
  p += m;
  float* bl = p;
  p += m;
  float* bh = p;
  p += m;
  float* cB = p;
  p += m;
  float* cB1 = p;  // phase-1 basic costs
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

  const RevLane L{m,  n,   nc,    W,     c,      lo, hi,    BI,
                  xB, bl,  bh,    cB,    cB1,    y,  alpha, ratio,
                  rowdiv, wq, basis, hits_up, inb, atup, &red};

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
  if (tid == 0) {
    s_status = empty ? INFEASIBLE : RUNNING;
    s_stall = 0;
    s_iters = 0;
    s_last = INFINITY;
  }
  __syncthreads();

  // ---- pivot loop --------------------------------------------------------
  for (int it = 0; it < max_iters && s_status == RUNNING; ++it) {
    const float infeas_sum = rev_infeasibility(L, feas_tol, &s_sum);
    const bool phase1 = infeas_sum > feas_tol;
    const RevStep st = rev_pivot(L, phase1, s_stall >= STALL_LIMIT, feas_tol,
                                 cost_tol, pivot_tol, &s_dq);
    // objective progress and the stall counter
    if (tid == 0) {
      const float cur = phase1 ? infeas_sum : rev_basic_objective(L);
      s_stall = cur < s_last - 1e-9f ? 0 : s_stall + 1;
      s_last = cur;
      s_status = st.status;
      s_iters += 1;
    }
    __syncthreads();
  }

  // ---- finalize ----------------------------------------------------------
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
    status_o[b] = s_status == RUNNING ? ITER_LIMIT : s_status;
    obj_o[b] = obj;
    iters_o[b] = s_iters;
  }
}

}  // namespace

extern "C" {

// Where a lane's B^-1 and warm-start block P1 live for an LP of m rows and
// n structural columns: 2 both in shared memory, 1 B^-1 in shared memory
// and P1 in the global scratch, 0 both in the global scratch, -1 when even
// the per-row and per-column vectors do not fit (the kernel cannot take the
// shape).  The caller passes a scratch of batch * m * m floats for each
// block that is not in shared memory.
int revised_simplex_layout(int m, int n) {
  const int nc = n + m;
  const size_t cap = (size_t)max_dynamic_smem();
  for (int layout = 2; layout >= 0; --layout)
    if (rev_smem_bytes(layout, m, nc) <= cap) return layout;
  return -1;
}

// Launches one block per lane on `stream`; returns cudaGetLastError() after
// the launch (0 on success).  All pointers are device pointers: W (m, n+m),
// c/lo/hi (batch, n+m) f32, wb (batch, m) i32 with -1 = cold, wa (batch, n+m)
// i32; scratch BI and P1 (batch, m, m) f32 as revised_simplex_layout asks
// (else ignored), z (batch, n+m) f32; outputs status/iters (batch) i32, obj
// (batch) f32, x (batch, n) f32, basis (batch, m) i32, at_upper (batch, n+m)
// i32.
int revised_simplex_launch(const void* W, int m, int n, int batch,
                           const void* c, const void* lo, const void* hi,
                           const void* wb, const void* wa, int max_iters,
                           float feas_tol, float cost_tol, float pivot_tol,
                           void* BI_scratch, void* P1_scratch, void* z_scratch,
                           void* status, void* obj, void* x, void* basis,
                           void* at_upper, void* iters, void* stream) {
  if (batch <= 0) return 0;
  const int nc = n + m;
  const int layout = revised_simplex_layout(m, n);
  if (layout < 0 || z_scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (layout < 2 && P1_scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (layout < 1 && BI_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = rev_smem_bytes(layout, m, nc);
  int threads = ((nc + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  auto kern = layout == 2   ? revised_simplex_kernel<2>
              : layout == 1 ? revised_simplex_kernel<1>
                            : revised_simplex_kernel<0>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<batch, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), m, n, static_cast<const float*>(c),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const int*>(wb), static_cast<const int*>(wa), max_iters,
      feas_tol, cost_tol, pivot_tol, static_cast<float*>(BI_scratch),
      static_cast<float*>(P1_scratch), static_cast<float*>(z_scratch),
      static_cast<int*>(status), static_cast<float*>(obj),
      static_cast<float*>(x), static_cast<int*>(basis),
      static_cast<int*>(at_upper), static_cast<int*>(iters));
  return (int)cudaGetLastError();
}

}  // extern "C"
