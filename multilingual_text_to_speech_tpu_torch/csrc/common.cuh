// Device helpers shared by the port's CUDA sources (fused_decoder.cu and
// fused_train_decoder.cu): bfloat16 rounding, the lowbias32 counter hash of
// the dropout and zoneout masks, warp and block reductions, and the opt-in
// for more than 48 KB of dynamic shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// The compute type CT of the serving decoder's instances (bfloat16 or
// float32) and its stream types (CT or int8): a float rounded to CT, held
// in float (float32: unchanged); a float stored as CT; any of them read
// as float.
template <class CT>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(CT) == 2)
    return round_bf16(x);
  else
    return x;
}

template <class CT>
__device__ __forceinline__ CT from_float(float x) {
  if constexpr (sizeof(CT) == 2)
    return __float2bfloat16_rn(x);
  else
    return x;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// lowbias32 counter hash of ops/pallas_decoder.py:181-193 (uint32 wraps)
__device__ __forceinline__ uint32_t rand_bits(uint32_t row, uint32_t col,
                                              uint32_t width, uint32_t seed0,
                                              uint32_t seed1, uint32_t salt) {
  uint32_t x = row * width + col;
  x = x + seed0 + salt * 0x9E3779B9u;
  x = x ^ (seed1 * 0x85EBCA6Bu);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// block-wide reduction; `scratch` holds 32 floats; every thread gets the
// result
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < n_warps ? scratch[lane] : (MAX ? -CUDART_INF_F : 0.0f);
  r = MAX ? warp_max(r) : warp_sum(r);
  return r;
}

// dynamic shared memory above the 48 KB default needs an opt-in
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
