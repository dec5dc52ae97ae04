// An empty ladder of cluster barriers with the pyramid's C entry: one
// cluster of kCluster blocks per frame passes kBarriers cluster.sync()s
// and does nothing else. scripts/probe_kernels.py times it as the latency
// floor of a pyramid whose small levels run in one cluster per frame, a
// barrier between levels (at 1080p ~18: 9 levels down from the quarter's
// second pool, 9 back up). Clusters of 16 are non-portable.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kBarriers = 18;
constexpr int kThreads = 1024;

__global__ void cluster_ladder_kernel(float* ws) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < kBarriers; ++i) cluster.sync();
  if (threadIdx.x == 0) ws[blockIdx.x] = (float)cluster.block_rank();
}

}  // namespace

extern "C" int vsc_pyramid(const float* q, float* out, float* ws, int N,
                           int h, int w, long long ws_floats, void* stream) {
  if ((long long)N * kCluster > ws_floats) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_ladder_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cluster_ladder_kernel, ws);
}
