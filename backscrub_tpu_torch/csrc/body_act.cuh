// The fused activations of the body kernels (body_mega.cu, gemm_wg.cuh,
// body_flat.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// activation codes shared with megakernel.py (_ACT_CODES)
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);                              // RELU
    case 2: return fminf(fmaxf(x, 0.0f), 6.0f);                 // RELU6
    case 3: {                                                   // HARD_SWISH
      float r = fminf(fmaxf(x + 3.0f, 0.0f), 6.0f);
      return __fmul_rn(__fmul_rn(x, r), 1.0f / 6.0f);
    }
    case 4: return 1.0f / (1.0f + expf(-x));                    // LOGISTIC
    default: return x;
  }
}

}  // namespace
