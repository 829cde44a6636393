// Shared device helpers of the repro_torch kernels.
//
// Every cross-thread sum here has a fixed order (xor-butterfly within a warp,
// then warps in index order), so a kernel gives the same bits on every run
// for the same launch geometry: no float atomics anywhere.  The solver's
// accept/reject and back-search decisions depend on these sums, and its
// same-seed replay contract needs them to be reproducible.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Loads and stores of the LM kernels, which read bf16 or fp32 tensors and
// compute in fp32 (the TPU kernels' contract: fp32 accumulation, the output
// in the input's dtype).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Asynchronous 16-byte copies from global to shared memory (cp.async.cg):
// a copy with valid == false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max over the 32 lanes of a warp; every lane returns the same value.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sum over the 32 lanes of a warp; every lane returns the same value.
// The warp must be full (blockDim.x a multiple of 32).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the whole block; every thread returns the same value.
// `red` is shared scratch of at least 33 floats; blockDim.x a multiple of 32.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += red[w];
    red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// out[row] = (sum_b part[b * d + row]) / div over nb partial rows, one warp
// per output row, lanes striding over b in a fixed order.  Called by every
// warp of a block; `first_warp`/`warp_stride` spread the rows over warps.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ part,
                                                int nb, int d, float div,
                                                float* out, int first_warp,
                                                int warp_stride) {
  const int lane = threadIdx.x & 31;
  for (int row = first_warp; row < d; row += warp_stride) {
    float acc = 0.f;
    for (int b = lane; b < nb; b += 32) acc += part[(size_t)b * d + row];
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc / div;
  }
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
