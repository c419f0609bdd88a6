// Latencies of the steps a K1 pivot chains, on the card: a dependent
// shared-memory load, a dependent float add, a dependent warp shuffle, a
// block barrier, clock64 itself, an IEEE float division, a cluster barrier
// and a dependent load from a peer block's shared memory (distributed
// shared memory), each in SM cycles a step (loop overhead included), and
// the SM clock (cycles over %globaltimer nanoseconds).  One line per block
// size (32, 128, 256 threads) and cluster size (1, 4).  csrc/dense_simplex.cu
// and PERF.md cite these figures.  Build and run on the machine with the
// card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/latency_bench \
//        tools/latency_bench.cu && /tmp/latency_bench

#include <cooperative_groups.h>

#include <cstdio>

namespace cg = cooperative_groups;

__device__ unsigned long long out[16];

__global__ void latencies(int iters, int C) {
  __shared__ int chain[1024];
  __shared__ float f[1024];
  const int tid = threadIdx.x;
  const bool report = tid == 0 && blockIdx.x == 0;
  for (int i = tid; i < 1024; i += blockDim.x) {
    chain[i] = (i + 1) & 1023;
    f[i] = 1.0f;
  }
  __syncthreads();
  long long t0, t1;
  int p = 0;
  float acc = 0.0f;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) p = chain[p];
  t1 = clock64();
  if (report) out[0] = (t1 - t0) / iters + (p == 12345);
  t0 = clock64();
  for (int i = 0; i < iters; ++i) acc = __fadd_rn(acc, f[i & 7]);
  t1 = clock64();
  if (report) out[1] = (t1 - t0) / iters + (acc == 12345.0f);
  int v = tid;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) v = __shfl_sync(0xffffffffu, v, (v + 1) & 31);
  t1 = clock64();
  if (report) out[2] = (t1 - t0) / iters + (v == 12345);
  t0 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  t1 = clock64();
  if (report) out[3] = (t1 - t0) / iters;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) acc += (float)(clock64() & 1);
  t1 = clock64();
  if (report) out[4] = (t1 - t0) / iters + (acc == 12345.0f);
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  t0 = clock64();
  for (int i = 0; i < 100 * iters; ++i) p = chain[p];
  t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (report) {
    out[5] = t1 - t0;
    out[6] = g1 - g0 + (p == 12345);
  }
  float d = 1.5f;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) d = f[i & 7] / d;
  t1 = clock64();
  if (report) out[7] = (t1 - t0) / iters + (d == 12345.0f);
  if (C > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    t0 = clock64();
    for (int i = 0; i < iters; ++i) cl.sync();
    t1 = clock64();
    if (report) out[8] = (t1 - t0) / iters;
    const int* peer = cl.map_shared_rank(chain, (cl.block_rank() + 1) % C);
    p = 0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) p = peer[p];
    t1 = clock64();
    if (report) out[9] = (t1 - t0) / iters + (p == 12345);
    cl.sync();  // no block leaves while a peer reads its shared memory
  }
}

int main() {
  unsigned long long h[16] = {};
  for (int threads : {32, 128, 256})
    for (int C : {1, 4}) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      cfg.gridDim = dim3(C);
      cfg.blockDim = dim3(threads);
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      for (int rep = 0; rep < 2; ++rep) cudaLaunchKernelEx(&cfg, latencies, 1000, C);
      cudaError_t e = cudaDeviceSynchronize();
      cudaMemcpyFromSymbol(h, out, sizeof(h));
      printf(
          "threads %d C %d: shared load %llu, fadd %llu, shuffle %llu, "
          "__syncthreads %llu, clock64 %llu, division %llu, cluster.sync "
          "%llu, peer shared load %llu cycles; SM clock %.3f GHz; %s\n",
          threads, C, h[0], h[1], h[2], h[3], h[4], h[7], C > 1 ? h[8] : 0ull,
          C > 1 ? h[9] : 0ull, (double)h[5] / (double)h[6],
          cudaGetErrorString(e));
      if (e != cudaSuccess) return 1;
    }
  return 0;
}
