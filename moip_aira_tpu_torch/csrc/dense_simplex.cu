// K1 on Hopper: a batched bounded-variable primal simplex on a dense tableau,
// each LP on a warp, a block or a thread-block cluster as the launch plan
// says.
//
// Replaces moip_aira_tpu/solver/pallas_lp.py::make_pallas_lp_batch (the
// Pallas TPU kernel).  Its plain PyTorch version, which the tests and
// chip_smoke.py hold this kernel against, is
// moip_aira_tpu_torch/solver/simplex_torch.py::dense_lp_batch_ref.
//
// What it computes, per lane: the tableau T = B^-1 [A | -I] (m x nc, f32),
// cold from the logical basis (T = -W) or warm from a given basis by a
// Gauss-Jordan rebuild with greedy partial pivoting (a singular warm basis
// falls back to cold); then composite phase 1, Dantzig pricing that turns
// into Bland's rule after STALL_LIMIT pivots without progress, a ratio test
// with bound flips and a largest-|pivot| tie-break, and a rank-1 update.
// Ties break on the first of equal maxima, as jnp.argmax and torch.argmax do:
// lowest column in pricing, lowest row in the ratio test (lowest basic column
// id under Bland), lowest row-major entry in the rebuild.
//
// What bounds it on this card: a pivot reads the m x nc tableau twice
// (pricing, the rank-1 update) and writes it once, from shared memory, but
// at the sizes the fronts launch a lane is bound by latency: each pivot is
// a chain of about ten dependent steps -- pricing (a chain of m adds a
// column), three block-wide arg-max or min reductions, the ratio test (an
// IEEE division, about 80 cycles), the xB update and two in-order sums over
// the m rows -- each waiting on shared-memory loads (about 30 cycles),
// shuffles (about 36) and barriers, and on a cluster one cluster barrier
// (about 800 cycles; tools/latency_bench.cu on the H100).  A launch
// ends with its slowest lane, and the wave launches few lanes at a time
// (the 2AP20 front 32 a launch on average, G3KP10 27), so most SMs would
// idle with one block a lane.
// What the design does about it: three execution shapes, one per launch,
// chosen by the wrapper's plan (solver/cuda_lp.py::dense_launch_plan):
//   packed   one warp a lane, P lanes a block, for m <= 32 rows and
//            nc <= 128 columns: warp lane l owns row l and the columns
//            l, l + 32, ...; every reduction is a warp shuffle, every barrier
//            a __syncwarp, and the two row sums are shuffle chains that
//            every warp lane computes alike;
//   block    one block a lane with the whole tableau in shared memory, for
//            launches that fill the card;
//   cluster  one lane on a cluster of C blocks: block r owns the columns
//            [r w, r w + w), w = ceil(nc / C), of all m rows in its shared
//            memory, prices them and updates them.  Each block publishes
//            its pricing winner and that column (m floats) into every
//            block's shared memory before the one cluster barrier of the
//            pivot, two buffers alternating by parity, so afterwards the
//            entering column is local everywhere and no block reads a
//            peer's slice; every block repeats the ratio test, the row pick,
//            the xB update and the bookkeeping on identical data, so all
//            take the same step.
// Every shape leaves a pivot's rank-1 update to the next pivot's pricing,
// which updates each of its columns and prices it in one pass, row by row
// in index order (the same values as the update and then the pricing),
// with piv - 1 written into row r of the entering column beforehand.  In
// the block and cluster shapes a pivot has six barriers, one of them the
// cluster barrier on a cluster: the pricing and row-pick reductions carry
// (score, index) as one 64-bit key, so a warp
// butterfly level is one compare, with the "any eligible" flag in
// __syncthreads_or; the least ratio is a butterfly too; the xB update also
// sets each row's phase-1 cost, infeasibility and objective term, which
// warps 0 and 1 then sum side by side as shuffle chains in row order (the
// next pivot's phase-1 sum and this pivot's objective); every thread keeps
// the stall counter itself.  The ratio test takes one division whichever
// bound blocks.  Every sum runs in index order and every multiply-add is
// rounded twice (no fused multiply-add), exactly as the plain PyTorch
// version computes it, so kernel and plain version take the same pivots bit
// for bit.  The basic solution -T z and the final objective c . z skip the
// columns whose z is zero: with a finite tableau a zero term adds +0 to a
// sum that is never -0, so the value is the full sum's.
//
// Built with -DK1_CLOCKS (tools/k1_bench.py only), the first thread of each
// lane also counts the SM cycles of each part of its run (its "pricing"
// includes the previous pivot's rank-1 update).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdense_simplex.so dense_simplex.cu

#include "revised_core.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;  // block and cluster shapes
constexpr int MAX_WARPS_K1 = MAX_THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int PACK_ROWS = 32;   // packed: a row for each warp lane
constexpr int PACK_COLS = 128;  // packed: four columns for each warp lane
constexpr int MAX_PACK = 8;     // packed: lanes (warps) a block

constexpr int SHAPE_PACKED = 0;
constexpr int SHAPE_BLOCK = 1;
constexpr int SHAPE_CLUSTER = 2;

#ifdef K1_CLOCKS
// the parts of a lane's run: the start (loading, the warm rebuild where
// present, the basic solution and the first sums), then per pivot the last
// pivot's rank-1 update with pricing, the pricing reduction (with the
// cluster's and the published column), the ratio test (with the least
// ratio), the row pick, the step's decision (the rank-1 update is left to
// the next pricing), the xB update and bookkeeping, and the sums for the
// next pivot (its phase-1 sum and this one's objective)
constexpr int N_PARTS = 8;
__device__ unsigned long long* k1_clocks;
#define K1_CLOCK_DECL unsigned long long clk_[N_PARTS] = {}; long long clk_t_ = clock64();
#define K1_TICK(part)                          \
  do {                                         \
    const long long t_ = clock64();            \
    clk_[part] += (unsigned long long)(t_ - clk_t_); \
    clk_t_ = t_;                               \
  } while (0)
#define K1_CLOCK_STORE(on, lane)                                      \
  do {                                                                \
    if ((on) && k1_clocks != nullptr)                                 \
      for (int p_ = 0; p_ < N_PARTS; ++p_)                            \
        k1_clocks[(size_t)(lane) * N_PARTS + p_] = clk_[p_];          \
  } while (0)
#else
#define K1_CLOCK_DECL
#define K1_TICK(part) \
  do {                \
  } while (0)
#define K1_CLOCK_STORE(on, lane) \
  do {                           \
  } while (0)
#endif

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~(size_t)15;
}
__host__ __device__ inline int slice_width(int nc, int C) {
  return (nc + C - 1) / C;
}

// packed: one lane's shared bytes: T (m x nc), c, lo, hi and z (nc each),
// cB, cB1 and alpha (m each) as f32, then inb and atup (nc bytes each)
__host__ __device__ inline size_t packed_lane_bytes(int m, int nc) {
  return round16(sizeof(float) * ((size_t)m * nc + 4 * (size_t)nc + 3 * (size_t)m) +
                 2 * (size_t)nc);
}

// block and cluster: a block's shared bytes: its T slice (m x w), c, lo,
// hi and z (nc each), xB, bl, bh, cB, cB1, alpha, ratio, infe and prod (m
// each) and the published columns (2 C m) as f32, basis and hits_up (m
// each) as i32, then inb and atup (nc bytes each)
__host__ __device__ inline size_t block_bytes(int m, int nc, int w, int C) {
  return round16(sizeof(float) * ((size_t)m * w + 4 * (size_t)nc + 9 * (size_t)m +
                                  2 * (size_t)C * m) +
                 sizeof(int) * 2 * (size_t)m + 2 * (size_t)nc);
}

// a block's dynamic shared bytes under a plan (solver/cuda_lp.py's
// dense_smem_bytes computes the same)
size_t dense_smem_bytes(int shape, int m, int nc, int C, int P) {
  if (shape == SHAPE_PACKED) return (size_t)P * packed_lane_bytes(m, nc);
  return block_bytes(m, nc, slice_width(nc, C), C);
}

// ---- reductions -------------------------------------------------------------
// Each warp reduces by a butterfly (shfl_xor), which leaves the winner in
// every lane; a block's warps post their winners and every thread then
// reduces the posted ones in a loop; a cluster's blocks post theirs in
// distributed-shared-memory mailboxes.  `beats` is a total order on (score,
// index), so every level and every order finds the same winner.

// Each warp's partial result of a pivot's three reductions, one array per
// reduction so that no two consecutive ones share storage; `red` serves the
// rebuild's arg-max.
struct K1Scratch {
  RevCand red[MAX_WARPS_K1];            // the rebuild's pivot
  unsigned long long pk[MAX_WARPS_K1];  // pricing
  float mv[MAX_WARPS_K1];               // least ratio
  unsigned long long rk[MAX_WARPS_K1];  // leaving row
};

// (v, i) as one 64-bit key whose unsigned order is `beats`: an
// order-preserving image of v (+0 for -0, which `beats` ties with +0) above
// the complement of i, so the larger v wins and the lower i among equals
__device__ __forceinline__ unsigned long long cand_key(float v, int i) {
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)(~i);
}

__device__ __forceinline__ int key_index(unsigned long long k) {
  return (int)~(unsigned)k;
}

// the block's largest key in every thread, and the block's OR of `any`,
// behind one barrier (`part` holds a slot per warp)
__device__ __forceinline__ unsigned long long block_key_max(
    unsigned long long k, unsigned long long* part, int* any) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, k, off);
    k = o > k ? o : k;
  }
  if ((threadIdx.x & 31) == 0) part[warp] = k;
  *any = __syncthreads_or(*any);
  unsigned long long b = part[0];
  for (int w = 1; w < nw; ++w) {
    const unsigned long long o = part[w];
    b = o > b ? o : b;
  }
  return b;
}

// a candidate against another: the better by (v, i), `any` or-ed
__device__ __forceinline__ void take(RevCand& a, const RevCand& o) {
  if (beats(o.v, o.i, a.v, a.i)) {
    a.v = o.v;
    a.i = o.i;
    a.d = o.d;
  }
  a.any |= o.any;
}

__device__ __forceinline__ void warp_cand_all(RevCand& a) {
  for (int off = 16; off > 0; off >>= 1) {
    RevCand o;
    o.v = __shfl_xor_sync(FULL, a.v, off);
    o.i = __shfl_xor_sync(FULL, a.i, off);
    o.d = __shfl_xor_sync(FULL, a.d, off);
    o.any = __shfl_xor_sync(FULL, a.any, off);
    take(a, o);
  }
}

// the block's winner in every thread, behind one barrier (`part` holds a
// slot per warp)
__device__ __forceinline__ RevCand block_cand(RevCand a, RevCand* part) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_cand_all(a);
  if ((threadIdx.x & 31) == 0) part[warp] = a;
  __syncthreads();
  RevCand b = part[0];
  for (int w = 1; w < nw; ++w) take(b, part[w]);
  return b;
}

__device__ __forceinline__ float warp_min_all(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// acc + t_0 + t_1 + ... + t_{cnt-1}, t_k lane k's t, one term at a time in
// lane order; every lane returns it
__device__ __forceinline__ float warp_chain(float acc, float t, int cnt) {
  int k = 0;
#pragma unroll 1
  for (; k + 4 <= cnt; k += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __shfl_sync(FULL, t, k + u);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = __fadd_rn(acc, v[u]);
  }
#pragma unroll 1
  for (; k < cnt; ++k) acc = __fadd_rn(acc, __shfl_sync(FULL, t, k));
  return acc;
}

__device__ __forceinline__ float block_min_all(float v, float* part) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_min_all(v);
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float b = part[0];
  for (int w = 1; w < nw; ++w) b = fminf(b, part[w]);
  return b;
}

// The cluster's winner from each block's: every block posts its winner in
// its mailbox and, after the cluster barrier, every thread reads the csize
// mailboxes and reduces them.  Two mailboxes alternate: a block posts into
// one only after the cluster barrier of the pivot in between, which every
// reader of its last contents passed.
__device__ __forceinline__ RevCand cluster_cand(RevCand win, RevCand* mail,
                                                int csize, int parity) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) mail[parity] = win;
  cluster.sync();
  RevCand b = *cluster.map_shared_rank(mail + parity, 0u);
  for (int r = 1; r < csize; ++r)
    take(b, *cluster.map_shared_rank(mail + parity, (unsigned)r));
  return b;
}

// the split cluster barrier: arrive once this thread's reads of a peer's
// slice are done, wait before writing a slice a peer may read
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- the pivot's parts ------------------------------------------------------

// row i's share of the phase-1 infeasibility, and its phase-1 cost
__device__ __forceinline__ float row_infeasibility(float x, float l, float h,
                                                   float feas_tol,
                                                   float* cost) {
  const bool below = x < l - feas_tol, above = x > h + feas_tol;
  *cost = below ? -1.0f : (above ? 1.0f : 0.0f);
  return __fadd_rn(below ? l - x : 0.0f, above ? x - h : 0.0f);
}

// Column j's reduced cost from its pricing sum acc (d_j = c_j - acc, or
// -acc in phase 1), its eligibility and its score, against this thread's
// best so far.
__device__ __forceinline__ void eligible_score(
    float acc, int j, bool phase1, bool bland, float cost_tol, const float* c,
    const float* lo, const float* hi, const unsigned char* inb,
    const unsigned char* atup, RevCand& best) {
  float dj = -acc;
  if (!phase1) dj = __fadd_rn(dj, c[j]);
  const bool nb = !inb[j], at = atup[j] != 0;
  const bool fr = !isfinite(lo[j]) && !isfinite(hi[j]);
  const bool el = nb && (((!at || fr) && dj < -cost_tol) ||
                         ((at || fr) && dj > cost_tol));
  best.any |= el;
  const float sc = bland ? (el ? -(float)j : -BIG) : (el ? fabsf(dj) : -1.0f);
  if (beats(sc, j, best.v, best.i)) {
    best.v = sc;
    best.i = j;
    best.d = dj;
  }
}

// The pending rank-1 update of U columns (when `upd`), then their pricing:
// column base + u * stride of a slice whose rows are `pitch` floats apart
// and whose first column is j0.  Row by row in index order, each entry is
// updated (T[i, j] -= cv[i] (T[r, j] / div), cv the entering column with
// piv - 1 in row r, rd = T[r, j] / div taken before) and then priced with
// it: U independent chains of m multiply-adds, each in index order, exactly
// the update and then the pricing pass they replace; four rows' loads in
// flight at a time.
template <int U>
__device__ __forceinline__ void update_price_cols(
    float* __restrict__ T, int pitch, int j0, int stride, int base, int m,
    bool upd, int r, float div, const float* __restrict__ cv,
    const float* __restrict__ cBe, const float* c, const float* lo,
    const float* hi, const unsigned char* inb, const unsigned char* atup,
    bool phase1, bool bland, float cost_tol, RevCand& best) {
  float* __restrict__ p0 = T + base;
  float acc[U], rd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    acc[u] = 0.0f;
    rd[u] = upd ? p0[r * pitch + u * stride] / div : 0.0f;
  }
  int k = 0;
#pragma unroll 1
  for (; k + 4 <= m; k += 4) {
    float y[4], v[4][U];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      y[kk] = cBe[k + kk];
#pragma unroll
      for (int u = 0; u < U; ++u) v[kk][u] = p0[(k + kk) * pitch + u * stride];
    }
    if (upd) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float ck = cv[k + kk];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          v[kk][u] = __fsub_rn(v[kk][u], __fmul_rn(ck, rd[u]));
          p0[(k + kk) * pitch + u * stride] = v[kk][u];
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = __fadd_rn(acc[u], __fmul_rn(y[kk], v[kk][u]));
  }
#pragma unroll 1
  for (; k < m; ++k) {
    const float yk = cBe[k];
    float* row = p0 + k * pitch;
    const float ck = upd ? cv[k] : 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = row[u * stride];
      if (upd) {
        v = __fsub_rn(v, __fmul_rn(ck, rd[u]));
        row[u * stride] = v;
      }
      acc[u] = __fadd_rn(acc[u], __fmul_rn(yk, v));
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    eligible_score(acc[u], j0 + base + u * stride, phase1, bland, cost_tol, c,
                   lo, hi, inb, atup, best);
}

// This thread's best column among the `width` columns of a slice, its
// columns first, first + stride, ..., each brought up to date by the
// pending rank-1 update first: four, then two, then one at a time.
__device__ __forceinline__ RevCand update_price_slice(
    float* T, int pitch, int j0, int width, int first, int stride, int m,
    bool upd, int r, float div, const float* cv,
    const float* cBe, const float* c, const float* lo, const float* hi,
    const unsigned char* inb, const unsigned char* atup, bool phase1,
    bool bland, float cost_tol) {
  RevCand best{-INFINITY, INT_MAX, 0.0f, 0};
  int base = first;
#pragma unroll 1
  for (; base + 3 * stride < width; base += 4 * stride)
    update_price_cols<4>(T, pitch, j0, stride, base, m, upd, r, div, cv,
                         cBe, c, lo, hi, inb, atup, phase1, bland,
                         cost_tol, best);
  if (base + stride < width) {
    update_price_cols<2>(T, pitch, j0, stride, base, m, upd, r, div, cv,
                         cBe, c, lo, hi, inb, atup, phase1, bland,
                         cost_tol, best);
    base += 2 * stride;
  }
  if (base < width)
    update_price_cols<1>(T, pitch, j0, stride, base, m, upd, r, div, cv,
                         cBe, c, lo, hi, inb, atup, phase1, bland,
                         cost_tol, best);
  return best;
}

// The rank-1 update of U columns of a slice, col0 + u * stride, rows
// `pitch` floats apart: T[i, j] -= cv_i (T[r, j] / div) with cv_i =
// alpha[i], but piv - 1 on row r; four rows of each column in flight.
template <int U>
__device__ __forceinline__ void rank1_cols(float* __restrict__ col0, int pitch,
                                           int stride, int m, int r, float piv,
                                           float div,
                                           const float* __restrict__ alpha) {
  const float pr = piv - 1.0f;
  float rd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) rd[u] = col0[r * pitch + u * stride] / div;
  int i = 0;
#pragma unroll 1
  for (; i + 4 <= m; i += 4) {
    float a[4], t[4][U];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = (i + k) == r ? pr : alpha[i + k];
#pragma unroll
      for (int u = 0; u < U; ++u) t[k][u] = col0[(i + k) * pitch + u * stride];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < U; ++u)
        col0[(i + k) * pitch + u * stride] = __fsub_rn(t[k][u], __fmul_rn(a[k], rd[u]));
  }
#pragma unroll 1
  for (; i < m; ++i) {
    const float cv = i == r ? pr : alpha[i];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float* e = col0 + i * pitch + u * stride;
      *e = __fsub_rn(*e, __fmul_rn(cv, rd[u]));
    }
  }
}

// The rank-1 update of this thread's columns first, first + stride, ... of
// the `width` columns of a slice, two at a time.
__device__ __forceinline__ void rank1_slice(float* T, int pitch, int width,
                                            int first, int stride, int m,
                                            int r, float piv, float div,
                                            const float* alpha) {
  int jj = first;
#pragma unroll 1
  for (; jj + stride < width; jj += 2 * stride)
    rank1_cols<2>(T + jj, pitch, stride, m, r, piv, div, alpha);
  if (jj < width) rank1_cols<1>(T + jj, pitch, stride, m, r, piv, div, alpha);
}

// one row's ratio to its blocking bound along eta, and whether that bound
// is its upper one
__device__ __forceinline__ float row_ratio(float eta, float x, float l,
                                           float h, float feas_tol,
                                           float pivot_tol, bool* hits_up) {
  const bool below = x < l - feas_tol, above = x > h + feas_tol;
  const bool moving = fabsf(eta) > pivot_tol;
  const bool fl = isfinite(l), fh = isfinite(h);
  const float se = moving ? eta : 1.0f;
  // the four cases exclude each other; each divides the gap to its bound
  // by +-se, so one division serves whichever holds
  const bool c1 = moving && !below && !above && eta < 0.0f && fl;
  const bool c2 = moving && !below && !above && eta > 0.0f && fh;
  const bool c3 = moving && below && eta > 0.0f;
  const bool c4 = moving && above && eta < 0.0f;
  const float num = c1 ? x - l : (c2 ? h - x : (c3 ? l - x : x - h));
  const float den = (c1 || c4) ? -se : se;
  const float rt = (c1 || c2 || c3 || c4) ? num / den : INFINITY;
  *hits_up = c2 || c4;
  return fmaxf(rt, 0.0f);
}

// ---- block and cluster shapes ----------------------------------------------

// One lane on `csize` blocks (CL) or on one block.  Blocks blockIdx.x =
// lane * csize + rank form a lane's cluster; block `rank` owns the columns
// [rank w, rank w + w) of T, w = ceil(nc / csize) (all of them on one
// block), row k of its slice at T + k w in shared memory.  Every pivot each
// block publishes its pricing winner and that column (m floats) into every
// block's shared memory (its own for one block) before the barrier that
// follows pricing, two buffers alternating, so after the barrier the
// entering column is local everywhere and no block reads a peer's slice.
template <bool CL>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    dense_simplex_kernel(const float* __restrict__ W, int m, int n, int batch,
                         const float* __restrict__ c_g,
                         const float* __restrict__ lo_g,
                         const float* __restrict__ hi_g,
                         const int* __restrict__ wb_g,
                         const int* __restrict__ wa_g, int max_iters,
                         float feas_tol, float cost_tol, float pivot_tol,
                         int csize, int* __restrict__ status_o,
                         float* __restrict__ obj_o, float* __restrict__ x_o,
                         int* __restrict__ basis_o, int* __restrict__ atup_o,
                         int* __restrict__ iters_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ K1Scratch ks;
  __shared__ RevCand mail[2][MAX_CLUSTER];  // published winners, by block
  __shared__ float s_sum, s_obj;

  const int nc = n + m;
  const int blk = blockIdx.x;
  const int b = CL ? blk / csize : blk;
  const int rank = CL ? blk - b * csize : 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane_off = (size_t)b * nc;
  const int w = CL ? slice_width(nc, csize) : nc;
  const int j0 = min(nc, rank * w), j1 = min(nc, j0 + w);
  const int wr = j1 - j0;  // this block's columns
  const int C = CL ? csize : 1;
  const bool clocked = rank == 0 && tid == 0;
  (void)batch;
  (void)clocked;
  K1_CLOCK_DECL

  float* p = reinterpret_cast<float*>(smem_raw);
  float* T = p;
  p += (size_t)m * w;
  float* c = p;
  p += nc;
  float* lo = p;
  p += nc;
  float* hi = p;
  p += nc;
  float* z = p;  // nonbasic values; the solution at the end
  p += nc;
  float* xB = p;
  p += m;
  float* bl = p;
  p += m;
  float* bh = p;
  p += m;
  float* cB = p;
  p += m;
  float* cB1 = p;  // phase-1 basic costs; the unassigned-row mask in the rebuild
  p += m;
  float* alpha = p;  // the rebuild's pivot column
  p += m;
  float* ratio = p;
  p += m;
  float* infe = p;  // each row's phase-1 infeasibility after a step
  p += m;
  float* prod = p;  // each row's c_B x_B after a step
  p += m;
  float* ccol = p;  // published columns: [parity][block][m]
  p += 2 * (size_t)C * m;
  int* ip = reinterpret_cast<int*>(p);
  int* basis = ip;
  ip += m;
  int* hits_up = ip;
  ip += m;
  unsigned char* inb = reinterpret_cast<unsigned char*>(ip);
  unsigned char* atup = inb + nc;  // at-upper flags; the remaining-column mask in the rebuild

  int parity = 0;  // the mailbox of the next cluster reduction

  for (int j = tid; j < nc; j += nt) {
    c[j] = c_g[lane_off + j];
    lo[j] = lo_g[lane_off + j];
    hi[j] = hi_g[lane_off + j];
  }
  const int* wb = wb_g + (size_t)b * m;
  const bool warm = wb[0] >= 0;
  for (int i = 0; i < m; ++i)
    for (int jj = tid; jj < w; jj += nt) {
      const float v = jj < wr ? W[(size_t)i * nc + j0 + jj] : 0.0f;
      T[i * w + jj] = warm ? v : -v;
    }
  for (int i = tid; i < m; i += nt) basis[i] = n + i;

  // ---- warm start: Gauss-Jordan rebuild of B^-1 W ------------------------
  bool use_warm = false;
  if (warm) {
    for (int j = tid; j < nc; j += nt) atup[j] = 0;
    for (int i = tid; i < m; i += nt) cB1[i] = 1.0f;
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
      const int wv = wb[i];
      if (wv >= 0 && wv < nc) atup[wv] = 1;
    }
    __syncthreads();
    bool ok = true;
    for (int step = 0; step < m; ++step) {
      // the largest score of this block's entries, keyed by the entry's
      // row-major index i nc + j in the whole tableau, so the cluster's
      // winner is the first of equal maxima in row-major order
      RevCand win{-INFINITY, INT_MAX, 0.0f, 0};
      for (int i = 0; i < m; ++i)
        for (int jj = tid; jj < wr; jj += nt) {
          const int j = j0 + jj;
          const float s = fabsf(T[i * w + jj]) * cB1[i] * (float)atup[j];
          const int g = i * nc + j;
          if (beats(s, g, win.v, win.i)) {
            win.v = s;
            win.i = g;
          }
        }
      win = block_cand(win, ks.red);
      if (CL) {
        win = cluster_cand(win, &mail[parity][0], csize, 0);
        parity ^= 1;
      }
      const float best = win.v;
      const int arg = win.i;
      // the largest remaining score decides: when it is 0 the arg-max lands
      // on entry (0, 0), which may be an assigned row's, and the basis is
      // singular
      if (!(best > GJ_PIVOT_TOL)) {
        ok = false;
        break;
      }
      const int r = arg / nc, cb = arg - (arg / nc) * nc;
      const int owner = CL ? cb / w : 0;
      const float* src = T;
      if (CL)
        src = cg::this_cluster().map_shared_rank(T, (unsigned)owner);
      const int jq = cb - owner * w;
      for (int i = tid; i < m; i += nt) alpha[i] = src[i * w + jq];
      if (CL) cluster_arrive();
      __syncthreads();
      const float piv = alpha[r];
      if (CL) cluster_wait();
      rank1_slice(T, w, wr, tid, nt, m, r, piv, piv, alpha);
      __syncthreads();
      if (tid == 0) {
        cB1[r] = 0.0f;
        atup[cb] = 0;
        basis[r] = cb;
      }
      __syncthreads();
    }
    use_warm = ok;
    if (!ok) {
      // every block of the cluster gives up at the same step; no peer
      // reads this slice after its last arrival
      for (int i = 0; i < m; ++i)
        for (int jj = tid; jj < w; jj += nt)
          T[i * w + jj] = jj < wr ? -W[(size_t)i * nc + j0 + jj] : 0.0f;
      for (int i = tid; i < m; i += nt) basis[i] = n + i;
    }
  }
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
    bl[i] = lo[basis[i]];
    bh[i] = hi[basis[i]];
    cB[i] = c[basis[i]];
  }
  empty = __syncthreads_or(empty);
  if (CL) cg::this_cluster().sync();  // every block's slice is final
  // xB = -T z over the columns in index order, each block on its own copy,
  // reading each slice from the block that owns it
  for (int i = tid; i < m; i += nt) {
    float acc = 0.0f;
    for (int rk = 0; rk < C; ++rk) {
      const float* src = T;
      if (CL) src = cg::this_cluster().map_shared_rank(T, (unsigned)rk);
      const int a = min(nc, rk * w), e = min(nc, a + w);
      for (int j = a; j < e; ++j) {
        const float zj = z[j];
        if (zj != 0.0f)
          acc = __fadd_rn(acc, __fmul_rn(src[i * w + (j - a)], zj));
      }
    }
    xB[i] = -acc;
  }
  // no peer reads this slice any more once every block is past here
  if (CL) cg::this_cluster().sync();
  else __syncthreads();

  // Each row's phase-1 cost (cB1, which the next pricing reads in phase 1),
  // infeasibility (infe) and c_B x_B (prod); the xB update of each pivot
  // sets them for its rows, the start here.
  auto row_terms = [&](int i, float x, float l, float h, float cb) {
    float cost;
    infe[i] = row_infeasibility(x, l, h, feas_tol, &cost);
    cB1[i] = cost;
    prod[i] = __fmul_rn(cb, x);
  };
  // Side by side after the row terms' barrier, each a shuffle chain in row
  // order, a row on each lane: warp 0 sums the infeasibilities into s_sum,
  // warp 1 the objective into s_obj; one barrier.
  auto sums = [&]() {
    if (tid < 64) {
      const float* v = tid < 32 ? infe : prod;
      const int l = tid & 31;
      float acc = 0.0f;
      for (int i0 = 0; i0 < m; i0 += 32)
        acc = warp_chain(acc, i0 + l < m ? v[i0 + l] : 0.0f, min(32, m - i0));
      if (tid == 0) s_sum = acc;
      if (tid == 32) s_obj = acc;
    }
    __syncthreads();
  };
  for (int i = tid; i < m; i += nt) row_terms(i, xB[i], bl[i], bh[i], cB[i]);
  __syncthreads();
  sums();
  K1_TICK(0);

  // ---- pivot loop --------------------------------------------------------
  // Every thread of every block holds the same status, stall counter and
  // last objective, so all leave the loop together.
  // A pivot's rank-1 update waits for the next pivot's pricing, which
  // updates each column and prices it in one pass (the tableau is read only
  // by its pricing and its published columns in between).
  int status = empty ? INFEASIBLE : RUNNING;
  int stall = 0, it = 0;
  float last = INFINITY;
  // a rank-1 update waits: row pend_r, the divisor, and the entering column
  // (published, with piv - 1 written into row pend_r after the step)
  bool pend = false;
  int pend_r = 0;
  float pend_div = 1.0f;
  float* pend_cv = ccol;
  for (; it < max_iters && status == RUNNING; ++it) {
    const float infeas_sum = s_sum;
    const bool phase1 = infeas_sum > feas_tol;
    const bool bland = stall >= STALL_LIMIT;
    const float* cBe = phase1 ? cB1 : cB;

    // the last pivot's update and pricing d = c - cBe^T T over this block's
    // columns, then the block's winner (its key in every thread) and
    // whether any column is eligible
    RevCand mine = update_price_slice(T, w, j0, wr, tid, nt, m, pend, pend_r,
                                      pend_div, pend_cv, cBe, c, lo, hi, inb,
                                      atup, phase1, bland, cost_tol);
    K1_TICK(1);
    int any_b = mine.any;
    const int qb = key_index(block_key_max(cand_key(mine.v, mine.i), ks.pk, &any_b));
    // publish the block's winner (its owner thread alone knows its reduced
    // cost) and its column in every block of the cluster, then meet: the
    // entering column is local in every block
    float* mycol = ccol + ((size_t)parity * C + rank) * m;
    if (qb != INT_MAX) {
      for (int rk = 0; rk < C; ++rk) {
        float* dst = mycol;
        if (CL) dst = cg::this_cluster().map_shared_rank(mycol, (unsigned)rk);
        for (int i = tid; i < m; i += nt) dst[i] = T[i * w + (qb - j0)];
      }
    }
    if (qb != INT_MAX ? mine.i == qb : tid == 0) {
      mine.any = any_b;
      for (int rk = 0; rk < C; ++rk) {
        RevCand* dst = &mail[parity][rank];
        if (CL) dst = cg::this_cluster().map_shared_rank(dst, (unsigned)rk);
        *dst = mine;
      }
    }
    if (CL)
      cg::this_cluster().sync();
    else
      __syncthreads();
    RevCand win = mail[parity][0];
    for (int rk = 1; rk < C; ++rk) take(win, mail[parity][rk]);
    const int q = win.i;
    const float dq = win.d;
    const bool any_elig = win.any != 0;
    float* acol = ccol + ((size_t)parity * C + (CL ? q / w : 0)) * m;
    parity ^= 1;
    K1_TICK(2);

    // the ratio test: one row per thread
    const bool atq = atup[q] != 0;
    const bool fr_q = !isfinite(lo[q]) && !isfinite(hi[q]);
    const bool up_q = !inb[q] && (!atq || fr_q) && dq < -cost_tol;
    const float sigma = up_q ? 1.0f : -1.0f;
    float rpart = INFINITY;
    for (int i = tid; i < m; i += nt) {
      bool hu;
      const float rt = row_ratio(-sigma * acol[i], xB[i], bl[i], bh[i],
                                 feas_tol, pivot_tol, &hu);
      ratio[i] = rt;
      hits_up[i] = hu;
      rpart = fminf(rpart, rt);
    }
    const float rmin = block_min_all(rpart, ks.mv);
    K1_TICK(3);
    // the rows this thread wrote above: no barrier needed to read them
    float pbest = -INFINITY;
    int r = INT_MAX;
    for (int i = tid; i < m; i += nt) {
      const bool tied = ratio[i] <= rmin + feas_tol;
      const float pk = bland ? (tied ? -(float)basis[i] : -BIG)
                             : (tied ? fabsf(acol[i]) : -1.0f);
      if (beats(pk, i, pbest, r)) {
        pbest = pk;
        r = i;
      }
    }
    int unused = 0;
    r = key_index(block_key_max(cand_key(pbest, r), ks.rk, &unused));
    K1_TICK(4);

    // the step, decided identically by every thread from shared state that
    // the step does not write
    const float lo_q = lo[q], hi_q = hi[q], c_q = c[q];
    const bool flo_q = isfinite(lo_q), fhi_q = isfinite(hi_q);
    const float lo_q0 = flo_q ? lo_q : 0.0f, hi_q0 = fhi_q ? hi_q : 0.0f;
    const float flip_theta = (flo_q && fhi_q) ? hi_q0 - lo_q0 : INFINITY;
    const bool row_blocks = rmin < flip_theta;
    const float theta = row_blocks ? ratio[r] : flip_theta;
    int new_status = RUNNING;
    if (!any_elig)
      new_status = phase1 ? INFEASIBLE : OPTIMAL;
    else if (!isfinite(theta))
      new_status = phase1 ? INFEASIBLE : UNBOUNDED;
    const bool stepping = new_status == RUNNING;
    const bool do_pivot = stepping && row_blocks;
    const bool do_flip = stepping && !row_blocks;
    const float piv = acol[r];
    const bool leave_up = hits_up[r] != 0;

    // the rank-1 update, left to the next pivot's pricing
    pend = do_pivot;
    pend_r = r;
    pend_div = fabsf(piv) > PIVOT_FLOOR ? piv : 1.0f;
    pend_cv = acol;
    K1_TICK(5);
    // the basic solution after the step and each row's terms for the next
    // pivot's sums; row r's owner also records its new bounds and cost
    float zq = atq ? hi_q0 : lo_q0;
    if (!flo_q && !fhi_q) zq = 0.0f;
    for (int i = tid; i < m; i += nt) {
      float x = xB[i], l = bl[i], h = bh[i], cb = cB[i];
      if (do_pivot && i == r) {
        x = __fadd_rn(zq, __fmul_rn(sigma, theta));
        l = bl[i] = lo_q;
        h = bh[i] = hi_q;
        cb = cB[i] = c_q;
      } else if (do_pivot || do_flip) {
        x = __fadd_rn(x, __fmul_rn(-sigma * acol[i], theta));
      }
      xB[i] = x;
      row_terms(i, x, l, h, cb);
    }
    if (tid == 0) {
      if (do_flip) atup[q] = !atq;
      if (do_pivot) {
        const int p_col = basis[r];  // the leaving column: only this thread writes basis
        atup[p_col] = leave_up;
        inb[p_col] = 0;
        inb[q] = 1;
        basis[r] = q;
      }
    }
    __syncthreads();
    K1_TICK(6);

    // every thread has read the entering column: row r of this block's
    // copy becomes piv - 1 for the pending update
    if (do_pivot && tid == 0) acol[r] = piv - 1.0f;
    // the next pivot's phase-1 sum beside this pivot's objective, which
    // feeds the stall counter
    sums();
    const float cur = phase1 ? infeas_sum : s_obj;
    stall = cur < last - 1e-9f ? 0 : stall + 1;
    last = cur;
    status = new_status;
    K1_TICK(7);
  }

  // ---- finalize (block 0 of the cluster) ----------------------------------
  if (rank == 0) {
    for (int j = tid; j < nc; j += nt)
      z[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
    __syncthreads();
    for (int i = tid; i < m; i += nt) z[basis[i]] += xB[i];
    __syncthreads();
    for (int j = tid; j < nc; j += nt) {
      if (j < n) x_o[(size_t)b * n + j] = z[j];
      atup_o[lane_off + j] = atup[j];
    }
    for (int i = tid; i < m; i += nt) basis_o[(size_t)b * m + i] = basis[i];
    if (tid == 0) {
      float obj = 0.0f;
      for (int j = 0; j < nc; ++j)
        if (z[j] != 0.0f) obj = __fadd_rn(obj, __fmul_rn(c[j], z[j]));
      status_o[b] = status == RUNNING ? ITER_LIMIT : status;
      obj_o[b] = obj;
      iters_o[b] = it;
    }
  }
  K1_CLOCK_STORE(clocked, b);
  // no block leaves while a peer may still read its shared memory
  if (CL) cg::this_cluster().sync();
}

// ---- packed shape: one warp a lane -----------------------------------------

// P = blockDim.x / 32 lanes a block, lane b on warp b mod P of block b / P.
// Warp lane l owns row l (l < m) and the columns l, l + 32, ... (nc <= 128,
// so at most four); the row state lives in registers of the row's warp
// lane, the tableau and the per-column state in the lane's part of shared
// memory.  No block barrier: a warp past the batch leaves at once.
__global__ void __launch_bounds__(MAX_PACK * 32)
    dense_simplex_packed(const float* __restrict__ W, int m, int n, int batch,
                         const float* __restrict__ c_g,
                         const float* __restrict__ lo_g,
                         const float* __restrict__ hi_g,
                         const int* __restrict__ wb_g,
                         const int* __restrict__ wa_g, int max_iters,
                         float feas_tol, float cost_tol, float pivot_tol,
                         int csize, int* __restrict__ status_o,
                         float* __restrict__ obj_o, float* __restrict__ x_o,
                         int* __restrict__ basis_o, int* __restrict__ atup_o,
                         int* __restrict__ iters_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  (void)csize;
  const int nc = n + m;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;
  const bool clocked = l == 0;
  (void)clocked;
  K1_CLOCK_DECL

  float* T = reinterpret_cast<float*>(smem_raw +
                                      (size_t)warp * packed_lane_bytes(m, nc));
  float* c = T + (size_t)m * nc;
  float* lo = c + nc;
  float* hi = lo + nc;
  float* z = hi + nc;
  float* cB = z + nc;
  float* cB1 = cB + m;
  float* alpha = cB1 + m;
  unsigned char* inb = reinterpret_cast<unsigned char*>(alpha + m);
  unsigned char* atup = inb + nc;

  const size_t lane_off = (size_t)b * nc;
  const bool row = l < m;
  for (int j = l; j < nc; j += 32) {
    c[j] = c_g[lane_off + j];
    lo[j] = lo_g[lane_off + j];
    hi[j] = hi_g[lane_off + j];
  }
  const int* wb = wb_g + (size_t)b * m;
  const bool warm = wb[0] >= 0;
  for (int e = l; e < m * nc; e += 32) T[e] = warm ? W[e] : -W[e];
  int basis = n + l;  // row l's basic column
  __syncwarp();

  // ---- warm start: Gauss-Jordan rebuild of B^-1 W ------------------------
  bool use_warm = false;
  if (warm) {
    for (int j = l; j < nc; j += 32) atup[j] = 0;
    __syncwarp();
    if (row) {
      const int wv = wb[l];
      if (wv >= 0 && wv < nc) atup[wv] = 1;
    }
    __syncwarp();
    unsigned unassigned = m == 32 ? FULL : (1u << m) - 1u;
    bool ok = true;
    for (int step = 0; step < m; ++step) {
      RevCand win{-INFINITY, INT_MAX, 0.0f, 0};
      for (int i = 0; i < m; ++i) {
        const float ui = (float)((unassigned >> i) & 1u);
        for (int j = l; j < nc; j += 32) {
          const float s = fabsf(T[i * nc + j]) * ui * (float)atup[j];
          if (beats(s, i * nc + j, win.v, win.i)) {
            win.v = s;
            win.i = i * nc + j;
          }
        }
      }
      warp_cand_all(win);
      const float best = win.v;
      const int arg = win.i;
      if (!(best > GJ_PIVOT_TOL)) {
        ok = false;
        break;
      }
      const int r = arg / nc, cb = arg - (arg / nc) * nc;
      const float piv = T[arg];
      if (row) alpha[l] = T[l * nc + cb];
      __syncwarp();
      rank1_slice(T, nc, nc, l, 32, m, r, piv, piv, alpha);
      unassigned &= ~(1u << r);
      if (l == 0) atup[cb] = 0;
      if (l == r) basis = cb;
      __syncwarp();
    }
    use_warm = ok;
    if (!ok) {
      for (int e = l; e < m * nc; e += 32) T[e] = -W[e];
      basis = n + l;
      __syncwarp();
    }
  }

  // ---- basis bookkeeping and the basic solution --------------------------
  for (int j = l; j < nc; j += 32) inb[j] = 0;
  __syncwarp();
  if (row) inb[basis] = 1;
  __syncwarp();
  bool empty = false;
  for (int j = l; j < nc; j += 32) {
    const bool fhi = isfinite(hi[j]);
    if (use_warm)
      atup[j] = (wa_g[lane_off + j] > 0) && !inb[j];
    else
      atup[j] = (j < n) && !isfinite(lo[j]) && fhi && !inb[j];
    z[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
    empty |= lo[j] > hi[j] + feas_tol;
  }
  empty = __any_sync(FULL, empty);
  float xB = 0.0f, bl = 0.0f, bh = 0.0f;
  if (row) {
    bl = lo[basis];
    bh = hi[basis];
    cB[l] = c[basis];
  }
  __syncwarp();
  if (row) {
    float acc = 0.0f;
    for (int j = 0; j < nc; ++j) {
      const float zj = z[j];
      if (zj != 0.0f) acc = __fadd_rn(acc, __fmul_rn(T[l * nc + j], zj));
    }
    xB = -acc;
  }

  // Each row's phase-1 cost into cB1 and, as two interleaved shuffle chains
  // that every warp lane runs alike, the phase-1 sum and c_B^T x_B, each in
  // index order.
  float s_sum = 0.0f, s_obj = 0.0f;
  auto sums = [&]() {
    float inf_l = 0.0f, obj_l = 0.0f;
    if (row) {
      float cost;
      inf_l = row_infeasibility(xB, bl, bh, feas_tol, &cost);
      cB1[l] = cost;
      obj_l = __fmul_rn(cB[l], xB);
    }
    s_sum = warp_chain(0.0f, inf_l, m);
    s_obj = warp_chain(0.0f, obj_l, m);
    __syncwarp();
  };
  sums();
  K1_TICK(0);

  // ---- pivot loop --------------------------------------------------------
  // a pivot's rank-1 update waits for the next pivot's pricing, as in the
  // block and cluster shapes
  int status = empty ? INFEASIBLE : RUNNING;
  int stall = 0, it = 0;
  float last = INFINITY;
  bool pend = false;
  int pend_r = 0;
  float pend_div = 1.0f;
  for (; it < max_iters && status == RUNNING; ++it) {
    const float infeas_sum = s_sum;
    const bool phase1 = infeas_sum > feas_tol;
    const bool bland = stall >= STALL_LIMIT;
    const float* cBe = phase1 ? cB1 : cB;

    RevCand win = update_price_slice(T, nc, 0, nc, l, 32, m, pend, pend_r,
                                     pend_div, alpha, cBe, c, lo, hi, inb,
                                     atup, phase1, bland, cost_tol);
    K1_TICK(1);
    warp_cand_all(win);
    __syncwarp();  // the updated tableau, for the entering column below
    K1_TICK(2);
    const int q = win.i;
    const float dq = win.d;
    const bool any_elig = win.any != 0;

    const bool atq = atup[q] != 0;
    const bool fr_q = !isfinite(lo[q]) && !isfinite(hi[q]);
    const bool up_q = !inb[q] && (!atq || fr_q) && dq < -cost_tol;
    const float sigma = up_q ? 1.0f : -1.0f;
    float a = 0.0f, rt = INFINITY;
    bool hu = false;
    if (row) {
      a = T[l * nc + q];
      alpha[l] = a;
      rt = row_ratio(-sigma * a, xB, bl, bh, feas_tol, pivot_tol, &hu);
    }
    const float rmin = warp_min_all(rt);
    K1_TICK(3);
    RevCand pick{-INFINITY, INT_MAX, 0.0f, 0};
    if (row) {
      const bool tied = rt <= rmin + feas_tol;
      pick.v = bland ? (tied ? -(float)basis : -BIG) : (tied ? fabsf(a) : -1.0f);
      pick.i = l;
    }
    warp_cand_all(pick);
    const int r = pick.i;
    const float theta_r = __shfl_sync(FULL, rt, r);
    const float piv = __shfl_sync(FULL, a, r);
    const int p_col = __shfl_sync(FULL, basis, r);
    const bool leave_up = __shfl_sync(FULL, (int)hu, r) != 0;
    K1_TICK(4);

    const float lo_q = lo[q], hi_q = hi[q], c_q = c[q];
    const bool flo_q = isfinite(lo_q), fhi_q = isfinite(hi_q);
    const float lo_q0 = flo_q ? lo_q : 0.0f, hi_q0 = fhi_q ? hi_q : 0.0f;
    const float flip_theta = (flo_q && fhi_q) ? hi_q0 - lo_q0 : INFINITY;
    const bool row_blocks = rmin < flip_theta;
    const float theta = row_blocks ? theta_r : flip_theta;
    int new_status = RUNNING;
    if (!any_elig)
      new_status = phase1 ? INFEASIBLE : OPTIMAL;
    else if (!isfinite(theta))
      new_status = phase1 ? INFEASIBLE : UNBOUNDED;
    const bool stepping = new_status == RUNNING;
    const bool do_pivot = stepping && row_blocks;
    const bool do_flip = stepping && !row_blocks;
    // the rank-1 update, left to the next pivot's pricing
    pend = do_pivot;
    pend_r = r;
    pend_div = fabsf(piv) > PIVOT_FLOOR ? piv : 1.0f;
    K1_TICK(5);
    __syncwarp();  // every lane has read the flags of column q
    // row r's own entry of the entering column becomes piv - 1 for the
    // pending update (the next pricing reads it after the sums' sync)
    if (do_pivot && l == r) alpha[l] = piv - 1.0f;
    if ((do_pivot || do_flip) && row) {
      float zq = atq ? hi_q0 : lo_q0;
      if (!flo_q && !fhi_q) zq = 0.0f;
      xB = (do_pivot && l == r) ? __fadd_rn(zq, __fmul_rn(sigma, theta))
                                : __fadd_rn(xB, __fmul_rn(-sigma * a, theta));
    }
    if (l == 0) {
      if (do_flip) atup[q] = !atq;
      if (do_pivot) {
        atup[p_col] = leave_up;
        inb[p_col] = 0;
        inb[q] = 1;
      }
    }
    if (do_pivot && l == r) {
      basis = q;
      bl = lo_q;
      bh = hi_q;
      cB[l] = c_q;
    }
    __syncwarp();
    K1_TICK(6);

    sums();
    const float cur = phase1 ? infeas_sum : s_obj;
    stall = cur < last - 1e-9f ? 0 : stall + 1;
    last = cur;
    status = new_status;
    K1_TICK(7);
  }

  // ---- finalize ----------------------------------------------------------
  for (int j = l; j < nc; j += 32)
    z[j] = nonbasic_value(inb[j], atup[j], lo[j], hi[j]);
  __syncwarp();
  if (row) z[basis] += xB;
  __syncwarp();
  for (int j = l; j < nc; j += 32) {
    if (j < n) x_o[(size_t)b * n + j] = z[j];
    atup_o[lane_off + j] = atup[j];
  }
  if (row) basis_o[(size_t)b * m + l] = basis;
  if (l == 0) {
    float obj = 0.0f;
    for (int j = 0; j < nc; ++j)
      if (z[j] != 0.0f) obj = __fadd_rn(obj, __fmul_rn(c[j], z[j]));
    status_o[b] = status == RUNNING ? ITER_LIMIT : status;
    obj_o[b] = obj;
    iters_o[b] = it;
  }
  K1_CLOCK_STORE(clocked, b);
}

using K1Kernel = decltype(&dense_simplex_packed);

// The plan's launch configuration, after checking it: 0, or the CUDA error
// the launch would meet.  Each kernel's shared-memory limit is raised to
// the card's opt-in once per device, on its first use there.
int dense_config(int shape, int m, int n, int batch, int C, int threads,
                 int P, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr, K1Kernel* kern) {
  static bool raised[MAX_DEVICES][3] = {};
  const int nc = n + m;
  if (m <= 0 || n < 0 || batch <= 0 || shape < 0 || shape > 2)
    return (int)cudaErrorInvalidValue;
  if (shape == SHAPE_PACKED) {
    if (m > PACK_ROWS || nc > PACK_COLS || P < 1 || P > MAX_PACK ||
        threads != 32 * P || C != 1)
      return (int)cudaErrorInvalidValue;
  } else {
    if (threads < 64 || threads > MAX_THREADS || threads % 32 != 0 ||
        (shape == SHAPE_BLOCK && C != 1) ||
        (shape == SHAPE_CLUSTER && (C < 2 || C > MAX_CLUSTER)))
      return (int)cudaErrorInvalidValue;
  }
  const int cap = dynamic_smem_cap();
  const size_t bytes = dense_smem_bytes(shape, m, nc, C, P);
  if (cap <= 0 || bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  *kern = shape == SHAPE_PACKED  ? dense_simplex_packed
          : shape == SHAPE_BLOCK ? dense_simplex_kernel<false>
                                 : dense_simplex_kernel<true>;
  const int slot = device_slot();
  if (slot < 0 || !raised[slot][shape]) {
    cudaError_t e = cudaFuncSetAttribute(
        *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (e != cudaSuccess) return (int)e;
    if (slot >= 0) raised[slot][shape] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  const int blocks = shape == SHAPE_PACKED ? (batch + P - 1) / P : batch * C;
  cfg->gridDim = dim3((unsigned)blocks, 1, 1);
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
int dense_simplex_device_limits(int* smem_optin, int* sms) {
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
// cluster; for the wrapper's check of its own arithmetic).
long long dense_simplex_smem_bytes(int shape, int m, int n, int C, int P) {
  return (long long)dense_smem_bytes(shape, m, n + m, C, P);
}

// How many clusters of C blocks of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters; blocks for C = 1), or minus the CUDA
// error.
int dense_simplex_max_clusters(int shape, int m, int n, int C, int threads,
                               int P) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  K1Kernel kern;
  int err = dense_config(shape, m, n, 1, C, threads, P, 0, &cfg, attr, &kern);
  if (err) return -err;
  int count = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveClusters(&count, (const void*)kern, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// Launches K1 on `stream` as the wrapper's plan says: shape 0 (packed, P
// lanes a block of 32 P threads), 1 (a block of `threads` a lane) or 2 (a
// cluster of C such blocks a lane); returns 0 on success, else the CUDA
// error (a plan that does not fit is refused before the launch).  All
// pointers are device pointers: W (m, n+m), c/lo/hi (batch, n+m) f32, wb
// (batch, m) i32 with -1 = cold, wa (batch, n+m) i32; outputs status/iters
// (batch) i32, obj (batch) f32, x (batch, n) f32, basis (batch, m) i32,
// at_upper (batch, n+m) i32.
int dense_simplex_launch(const void* W, int m, int n, int batch,
                         const void* c, const void* lo, const void* hi,
                         const void* wb, const void* wa, int max_iters,
                         float feas_tol, float cost_tol, float pivot_tol,
                         int shape, int C, int threads, int P, void* status,
                         void* obj, void* x, void* basis, void* at_upper,
                         void* iters, void* stream) {
  if (batch <= 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  K1Kernel kern;
  int err = dense_config(shape, m, n, batch, C, threads, P,
                         static_cast<cudaStream_t>(stream), &cfg, attr, &kern);
  if (err) return err;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(W), m, n, batch,
      static_cast<const float*>(c), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const int*>(wb),
      static_cast<const int*>(wa), max_iters, feas_tol, cost_tol, pivot_tol,
      C, static_cast<int*>(status), static_cast<float*>(obj),
      static_cast<float*>(x), static_cast<int*>(basis),
      static_cast<int*>(at_upper), static_cast<int*>(iters));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef K1_CLOCKS
// Where the next launches write each lane's cycles by part: (batch, 8)
// unsigned 64-bit, in the order start, rank-1 update with pricing, pricing
// reduction, ratio test, row pick, step, xB update, sums (null: nowhere).
int dense_simplex_set_clocks(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return (int)cudaMemcpyToSymbol(k1_clocks, &p, sizeof(p));
}
#endif

}  // extern "C"
