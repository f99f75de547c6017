// XLA's integer semantics, for the kernels that index as JAX does.
#pragma once

#include <limits.h>

// XLA's f32 -> s32 convert (astype(int32)): truncation, NaN -> 0, saturated
__device__ __forceinline__ int xla_to_s32(float f) {
  if (isnan(f)) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f <= -2147483648.0f) return INT_MIN;
  return (int)f;
}

// int32 addition that wraps, as XLA's does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
