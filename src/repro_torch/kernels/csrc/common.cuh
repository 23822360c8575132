// Shared helpers of the port's CUDA kernels. Each kernel exposes a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError(), so the ctypes wrapper can raise on a refused launch.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_API extern "C" __attribute__((visibility("default")))

// Guide cell of a value in [0, 1): clip(floor(x * m), 0, m - 1) in float32,
// exactly as core.forest._cells and core.sample compute it.
__device__ __forceinline__ int rt_guide_cell(float x, int m) {
    int c = (int)floorf(__fmul_rn(x, (float)m));
    return min(max(c, 0), m - 1);
}
