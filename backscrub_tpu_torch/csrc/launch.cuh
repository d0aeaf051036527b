// Thread-block cluster launch, shared by the persistent body kernel
// (body_mega.cu: the cluster barrier's microbenchmark) and P4 (probes.cu:
// the squeeze-excite block on one cluster).
#pragma once

#include <cuda_runtime.h>

namespace {

// launch ``kern`` as ONE cluster of ``cluster`` CTAs of ``threads`` threads
// and ``smem`` dynamic shared bytes each; refuse (return an error, launch
// nothing) where the card cannot hold such a cluster.  Above 8 CTAs the
// size is non-portable and has to be allowed first.
template <typename... Args_>
int launch_cluster(void (*kern)(Args_...), int cluster, int threads, int smem,
                   cudaStream_t stream, Args_... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8 &&
      (e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg)) != cudaSuccess) return (int)e;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace
