// Device helpers shared by the simplex kernels (dense_simplex.cu, K1, and
// revised_simplex.cu, K2): status codes and constants of the reference
// kernels, block-wide arg-max and minimum with the lowest index winning
// ties (as jnp.argmax and torch.argmax break them), and the in-order sum
// that the plain PyTorch versions reproduce bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {


constexpr int RUNNING = -1;
constexpr int OPTIMAL = 0;
constexpr int INFEASIBLE = 1;
constexpr int UNBOUNDED = 2;
constexpr int ITER_LIMIT = 3;

constexpr float BIG = 1e30f;
constexpr int STALL_LIMIT = 60;
constexpr float GJ_PIVOT_TOL = 1e-5f;
constexpr float PIVOT_FLOOR = 1e-12f;
constexpr int MAX_WARPS = 32;  // warps of the largest block (1024 threads)
// static __shared__ bytes the kernel declares on top of the dynamic part
constexpr int STATIC_SMEM_RESERVE = 1024;

struct Scratch {
  float v[MAX_WARPS];
  int i[MAX_WARPS];
};

// (a, ia) beats (b, ib): larger value, lower index among equals
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// block-wide argmax; every thread returns the winner
__device__ void block_argmax(float& v, int& i, Scratch* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_argmax(v, i);
  __syncthreads();  // the previous reduction's readers are done with s
  if (lane == 0) {
    s->v[warp] = v;
    s->i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? s->v[lane] : -INFINITY;
    i = lane < nw ? s->i[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      s->v[0] = v;
      s->i[0] = i;
    }
  }
  __syncthreads();
  v = s->v[0];
  i = s->i[0];
}

// block-wide minimum (exact in any order); every thread returns it
__device__ float block_min(float v, Scratch* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  __syncthreads();
  if (lane == 0) s->v[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? s->v[lane] : INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) s->v[0] = v;
  }
  __syncthreads();
  return s->v[0];
}

// sum of v[0..len) one term at a time in index order, rounded at every
// step: the order the plain version uses, so the two agree bit for bit
__device__ float seq_sum(const float* v, int len) {
  float acc = 0.0f;
  for (int k = 0; k < len; ++k) acc = __fadd_rn(acc, v[k]);
  return acc;
}

// value of nonbasic column j (0 for a basic one)
__device__ __forceinline__ float nonbasic_value(bool inb, bool at, float lo,
                                                float hi) {
  if (inb) return 0.0f;
  const bool flo = isfinite(lo), fhi = isfinite(hi);
  if (at && fhi) return hi;
  return flo ? lo : (fhi ? hi : 0.0f);
}

int max_dynamic_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin - STATIC_SMEM_RESERVE;
}

// A kernel's opt-in shared bytes and the limit cudaFuncSetAttribute raises
// belong to the current device, so the host side keeps what it reads or
// raises once per device ordinal; a device past MAX_DEVICES is asked at
// every launch.
constexpr int MAX_DEVICES = 64;

// the current device's ordinal when it has a slot below MAX_DEVICES, else -1
int device_slot() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

// max_dynamic_smem of the current device, read once per device
int dynamic_smem_cap() {
  static int cap[MAX_DEVICES] = {};
  const int slot = device_slot();
  if (slot < 0) return max_dynamic_smem();
  if (cap[slot] <= 0) cap[slot] = max_dynamic_smem();
  return cap[slot];
}

}  // namespace
