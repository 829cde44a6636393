// Grouped-query flash attention of the LM prefill, fp32 accumulation.
//
// repro_flash_attention replaces src/repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (B9, body _flash_kernel):
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(dh)) v[b, j, h / G]
//   over the positions j the mask admits (causal: j <= i; sliding window:
//   j > i - window; always j < Skv), with q (B, Sq, Hq, dh),
//   k and v (B, Skv, Hkv, dh), G = Hq / Hkv, bf16 or fp32 in, q's dtype out.
//   The TPU kernel walked the KV blocks as a sequential grid axis with the
//   online-softmax state (m, l, acc) in VMEM scratch.  Here one block owns a
//   (batch, query head, 64-query tile) and loops over 64-key tiles itself,
//   with its Q, K, V and P tiles in shared memory and each thread's rows of
//   (m, l, acc) in registers.  Key tiles wholly above the causal diagonal or
//   before the window are skipped (the TPU grid could not skip them), and the
//   ragged edges of Sq and Skv are masked in the kernel, so no caller pads.
//   A masked score is the kernel's finite -1e30 and its probability is set
//   to 0, so a tile that a row sees wholly masked adds nothing and gives no
//   NaN in exp(m_prev - m_cur).
// Bound on an H100: the matrix products, 4 dh Sq(Sq+1)/2 FLOPs per (b, h)
//   over the causal half, far above the bytes (q, k, v read once).  This
//   first version is the simple right one: fp32 FMA on CUDA cores from
//   shared memory, 4x4 scores and 4 x dh/16 outputs per thread (the S and O
//   rows of a thread coincide, so the per-row rescale needs no exchange).
//   Its reach is a fraction of the 67 TFLOP/s fp32 rate; the tensor-core
//   (mma/wgmma on bf16 tiles) redesign is queued behind the port.
// Sums over a row's 16 lanes use a fixed xor butterfly: the same bits on
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBq = 64;          // query rows per block
constexpr int kBk = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads: 4 rows x 4 keys each
constexpr int kPs = kBk + 1;     // padded row of the P tile
constexpr float kNeg = -1e30f;   // the TPU kernel's finite mask value

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int DH>
constexpr int smem_bytes() {
  return (3 * kBq * (DH + 1) + kBq * kPs) * (int)sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int hq, int hkv, int causal, int window,
                       float scale) {
  constexpr int DP = DH + 1;     // padded rows: conflict-free column reads
  constexpr int NC = DH / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBq][DP], pre-scaled
  float* sK = sQ + kBq * DP;     // [kBk][DP]
  float* sV = sK + kBk * DP;     // [kBk][DP]
  float* sP = sV + kBk * DP;     // [kBq][kPs]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBq;
  const int hk = h / (hq / hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int e = threadIdx.x; e < kBq * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, s = q0 + r;
    float x = 0.f;
    if (s < sq) x = repro::to_f32(q[(((size_t)b * sq + s) * hq + h) * DH + d]) * scale;
    sQ[r * DP + d] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // key positions this query tile can see
  const int q_lo = q0;
  const int q_hi = min(q0 + kBq, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int kv0 = (kv_begin / kBk) * kBk; kv0 < kv_end; kv0 += kBk) {
    __syncthreads();             // the previous tile's K, V and P are consumed
    for (int e = threadIdx.x; e < kBk * DH; e += kThreads) {
      const int r = e / DH, d = e % DH, s = kv0 + r;
      float xk = 0.f, xv = 0.f;
      if (s < skv) {
        const size_t off = (((size_t)b * skv + s) * hkv + hk) * DH + d;
        xk = repro::to_f32(k[off]);
        xv = repro::to_f32(v[off]);
      }
      sK[r * DP + d] = xk;
      sV[r * DP + d] = xv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qp = q_lo + row;
      bool ok[4];
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + tx + 16 * j;
        ok[j] = kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        if (!ok[j]) sc[i][j] = kNeg;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        psum += p;
        sP[row * kPs + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + psum;      // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * kPs + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(sum16(l[i]), 1e-30f);
    const int s = q0 + ty + 16 * i;
    if (s < sq) {
      T* dst = o + (((size_t)b * sq + s) * hq + h) * DH;
#pragma unroll
      for (int j = 0; j < NC; ++j) dst[tx + 16 * j] = repro::from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int skv, int hq, int hkv, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr int bytes = smem_bytes<DH>();
  auto* kern = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBq - 1) / kBq, hq, b);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, hq, hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o,
             int b, int sq, int skv, int hq, int hkv, int causal, int window,
             float scale, cudaStream_t st) {
  switch (dh) {
    case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, sq, hq, dh); k, v (b, skv, hkv, dh); o (b, sq, hq, dh); all
// contiguous, of one dtype: bf16 when is_bf16, else fp32.  dh in {64, 80,
// 128} (the configs' head dims); hq a multiple of hkv.  Query row i sits at
// position i; window <= 0 means no window.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int is_bf16,
                                     int b, int sq, int skv, int hq, int hkv,
                                     int dh, int causal, int window,
                                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, b, sq, skv, hq, hkv, causal,
                                   window, scale, st);
  return dispatch<float>(dh, q, k, v, o, b, sq, skv, hq, hkv, causal, window,
                         scale, st);
}
