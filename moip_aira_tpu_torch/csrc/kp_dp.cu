// K4 on Hopper: one item of the bi-objective 0/1-knapsack front DP.
//
// Replaces moip_aira_tpu/solver/kp_front.py:296 (the Pallas TPU kernel built
// by _pallas_runner, called by front_pallas).  Its plain PyTorch version,
// which the tests and chip_smoke.py hold this kernel against bit for bit, is
// moip_aira_tpu_torch/solver/kp_front.py::dp_table_ref; the wrapper is
// moip_aira_tpu_torch/solver/cuda_dp.py.
//
// What it computes: the table g (rows = cap + 1, cols = S + 1, int32,
// row-major, no padding) holds in g[c, s] the best first value of an item
// set of weight <= c whose second value is exactly s, -1 when there is
// none.  One launch applies one item (w, b, a):
//
//   out[c, s] = max(in[c, s], in[c-w, s-a] >= 0 ? in[c-w, s-a] + b : -1)
//
// and out[c, s] = in[c, s] where c < w or s < a.  The wrapper launches once
// per item and swaps the two tables between launches.
//
// What differs from the TPU kernel: that kernel updates one table in place,
// which is right only because its grid runs in order (items in sequence,
// capacity row blocks descending inside an item, so a block's source rows
// still hold the previous item's values).  Blocks here run in no order, so
// the update reads one table and writes the other (ping-pong).  That
// doubles the memory: two tables of 3 GiB at a 500-item instance (2KP500,
// 801.7 M cells), two of 8 GiB at the 2^31-cell ceiling of detection, both
// well inside the card's 80 GB.  An item of weight 0 (legal after
// detection's binary split) needs nothing special: it reads only `in`.  The
// TPU kernel's -1 sentinel frame and its aligned-down DMA with a roll in
// VMEM exist for the TPU's (8, 128) tiles; here the edges are masked by a
// comparison.  Offsets are 64-bit: c * cols + s passes 2^31 near the cell
// ceiling.
//
// What bounds it on this card: bytes.  A pass must read the previous table
// once and write the new one once, 8 bytes a cell, and a table of a real
// instance is far larger than the 50 MB L2, so it cannot stay on chip from
// one item to the next: 8 * 801.7 M / 3.35 TB/s = 1.91 ms a pass at 2KP500.
// The arithmetic (a compare, an add and a max a cell) is under a tenth of
// that at the card's int32 rate.  What the design does about it: threads
// walk s contiguously, so the direct read, the shifted read and the write
// are all coalesced; each thread keeps UNROLL cells' loads in flight before
// it stores; the grid has a row of blocks for each table row (and strides
// past the 65,535 rows gridDim.y allows), and the blocks start in row
// order, so the shifted source row c - w, read directly by the blocks w
// rows back shortly before, is partly still in L2.  A grid of about eight
// blocks per SM striding over the rows ran more than twice as long a pass
// at 2KP500 on the H100 (PERF.md).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libkp_dp.so kp_dp.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
    kp_dp_step(const int32_t* __restrict__ in, int32_t* __restrict__ out,
               int64_t rows, int64_t cols, int64_t w, int32_t b, int64_t a) {
  const int64_t tile = (int64_t)THREADS * UNROLL;
  for (int64_t c = blockIdx.y; c < rows; c += gridDim.y) {
    const int32_t* row = in + c * cols;
    int32_t* orow = out + c * cols;
    const bool has_src = c >= w;
    const int32_t* srow = in + (has_src ? c - w : 0) * cols;
    for (int64_t s0 = (int64_t)blockIdx.x * tile + threadIdx.x; s0 < cols;
         s0 += (int64_t)gridDim.x * tile) {
      int32_t keep[UNROLL];
      int32_t src[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int64_t s = s0 + (int64_t)k * THREADS;
        keep[k] = -1;
        src[k] = -1;
        if (s < cols) {
          keep[k] = row[s];
          if (has_src && s >= a) src[k] = srow[s - a];
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int64_t s = s0 + (int64_t)k * THREADS;
        if (s < cols) {
          const int32_t cand = src[k] >= 0 ? src[k] + b : -1;
          orow[s] = keep[k] > cand ? keep[k] : cand;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Applies one item (w, b, a) to the rows x cols table `in`, writing `out`
// (both device pointers of rows * cols int32, distinct); launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success).
// w and a must be >= 0; an item with w >= rows or a >= cols copies `in`.
int kp_dp_step_launch(const void* in, void* out, long long rows,
                      long long cols, long long w, int b, long long a,
                      void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  const long long tile = (long long)THREADS * UNROLL;
  const long long gx = (cols + tile - 1) / tile;
  const long long gy = rows < MAX_GRID_Y ? rows : MAX_GRID_Y;
  kp_dp_step<<<dim3((unsigned)gx, (unsigned)gy), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out),
      (int64_t)rows, (int64_t)cols, (int64_t)w, (int32_t)b, (int64_t)a);
  return (int)cudaGetLastError();
}

}  // extern "C"
