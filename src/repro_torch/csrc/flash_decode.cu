// One-token grouped-query attention over a KV cache (the LM decode step).
//
// repro_flash_decode replaces src/repro/kernels/flash_decode/kernel.py
// flash_decode_pallas (B10, body _decode_kernel):
//   out[b, h] = softmax_p(q[b, h] . k[b, p, h / G] / sqrt(dh)) v[b, p, h / G]
//   over the cache positions lo <= p <= idx (lo = idx - window + 1 with a
//   sliding window, else 0), q (B, Hq, dh), k and v (B, S, Hkv, dh), G =
//   Hq / Hkv, bf16 or fp32 in, q's dtype out, fp32 softmax and sums.  As in
//   the TPU kernel, all G query heads of a KV head ride along in one pass,
//   so the cache is read once per group.
// Bound on an H100: the bytes.  One token does 4 G dh FLOPs per 2 dh cache
//   elements read, far below the card's ops-per-byte balance, so the time is
//   the read of K and V over the filled positions.  The TPU kernel walked
//   the cache as a sequential grid axis; here (flash-decoding) the positions
//   are split over warps so that enough loads are in flight: at the serving
//   shape (B=8, Hkv=5) the 40 (batch, KV head) pairs alone would occupy 40 of
//   the 132 SMs.  Each warp owns one contiguous chunk of positions and keeps
//   its own (m, l, acc) for the G heads: a lane forms the scores of one
//   position (its K row in 16-byte loads, q from shared memory), the warp
//   rescales by its running max, and the lanes then own pairs of the dh
//   output columns for the P V product (V rows read coalesced, each lane's p
//   broadcast by shuffle).  A second kernel merges the per-warp partials of
//   each (batch, head) in chunk order: a fixed order, no float atomics, the
//   same bits on every run.  The wrapper sizes the chunks (multiples of 32
//   positions) to put about 16 warps on every SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // warps (chunks) per block
constexpr int kMaxG = 8;           // query heads per KV head
constexpr float kNeg = -1e30f;     // the TPU kernel's finite mask value

// VEC elements of T in one 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) dst[i] = repro::to_f32(e[i]);
}

template <typename T, int DH>
__global__ void __launch_bounds__(32 * kWarps)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int s, int hkv, int g, int lo, int hi, int chunk,
                      int nsplit, float scale) {
  constexpr int NP = (DH + 63) / 64;   // column pairs per lane
  constexpr int VN = Vec<T>::n;
  __shared__ float sq[kMaxG * DH];
  const int b = blockIdx.z, hk = blockIdx.y;
  const int hq = hkv * g;
  for (int e = threadIdx.x; e < g * DH; e += blockDim.x)
    sq[e] = repro::to_f32(q[((size_t)b * hq + hk * g) * DH + e]) * scale;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sp = blockIdx.x * kWarps + warp;
  if (sp >= nsplit) return;
  const int p0 = lo + sp * chunk;
  const int p1 = min(hi, p0 + chunk);
  const size_t row = (size_t)hkv * DH;                     // one position
  const T* kb = k + (size_t)b * s * row + (size_t)hk * DH;
  const T* vb = v + (size_t)b * s * row + (size_t)hk * DH;

  float m[kMaxG], l[kMaxG], acc[kMaxG][2 * NP];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) {
    m[gg] = kNeg;
    l[gg] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NP; ++c) acc[gg][c] = 0.f;
  }

  for (int t0 = p0; t0 < p1; t0 += 32) {
    const int pos = t0 + lane;
    const bool ok = pos < p1;
    float sc[kMaxG];
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) sc[gg] = 0.f;
    if (ok) {
      const T* kr = kb + (size_t)pos * row;
#pragma unroll 2
      for (int d0 = 0; d0 < DH; d0 += VN) {
        float kf[VN];
        load16(kr + d0, kf);
#pragma unroll
        for (int gg = 0; gg < kMaxG; ++gg) {
          if (gg < g) {
            float a = sc[gg];
#pragma unroll
            for (int e = 0; e < VN; ++e) a = fmaf(sq[gg * DH + d0 + e], kf[e], a);
            sc[gg] = a;
          }
        }
      }
    }
    float p[kMaxG];
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) {
      if (gg < g) {
        const float m_new = fmaxf(m[gg], repro::warp_max(ok ? sc[gg] : kNeg));
        const float alpha = expf(m[gg] - m_new);
        p[gg] = ok ? expf(sc[gg] - m_new) : 0.f;
        l[gg] = l[gg] * alpha + p[gg];                     // this lane's share
        m[gg] = m_new;
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) acc[gg][c] *= alpha;
      }
    }
    const int nt = min(32, p1 - t0);
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const T* vr = vb + (size_t)(t0 + j) * row;
      float vv[2 * NP];
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        const int d = pr * 64 + 2 * lane;
        vv[2 * pr] = d < DH ? repro::to_f32(vr[d]) : 0.f;
        vv[2 * pr + 1] = d < DH ? repro::to_f32(vr[d + 1]) : 0.f;
      }
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg) {
        if (gg < g) {
          const float pj = __shfl_sync(0xffffffffu, p[gg], j);
#pragma unroll
          for (int c = 0; c < 2 * NP; ++c) acc[gg][c] = fmaf(pj, vv[c], acc[gg][c]);
        }
      }
    }
  }

  const size_t base = ((size_t)b * hkv + hk) * nsplit + sp;  // (b, hk, sp)
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) {
    if (gg < g) {
      const float lsum = repro::warp_sum(l[gg]);
      if (lane == 0) {
        part_m[base * g + gg] = m[gg];
        part_l[base * g + gg] = lsum;
      }
      float* dst = part_acc + (base * g + gg) * DH;
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        const int d = pr * 64 + 2 * lane;
        if (d < DH) {
          dst[d] = acc[gg][2 * pr];
          dst[d + 1] = acc[gg][2 * pr + 1];
        }
      }
    }
  }
}

// One warp per (batch, query head): merge the nsplit partials in chunk order.
template <typename T, int DH>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    T* __restrict__ out, int hkv, int g,
                                    int nsplit) {
  const int b = blockIdx.y, h = blockIdx.x, lane = threadIdx.x;
  const int hk = h / g, gg = h % g;
  const size_t first = ((size_t)b * hkv + hk) * nsplit;    // (b, hk, 0)
  float mx = kNeg;
  for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, part_m[(first + sp) * g + gg]);
  constexpr int NC = (DH + 31) / 32;
  float o[NC], den = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const size_t at = (first + sp) * g + gg;
    const float wgt = expf(part_m[at] - mx);
    den = fmaf(part_l[at], wgt, den);
    const float* src = part_acc + at * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < DH) o[c] = fmaf(src[d], wgt, o[c]);
    }
  }
  den = fmaxf(den, 1e-30f);
  T* dst = out + ((size_t)b * hkv * g + h) * DH;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = c * 32 + lane;
    if (d < DH) dst[d] = repro::from_f32<T>(o[c] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, float* part_m,
           float* part_l, float* part_acc, void* out, int b, int s, int hkv,
           int g, int lo, int hi, int chunk, int nsplit, float scale,
           cudaStream_t st) {
  dim3 grid((nsplit + kWarps - 1) / kWarps, hkv, b);
  decode_partial_kernel<T, DH><<<grid, 32 * kWarps, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_m, part_l, part_acc, s, hkv, g, lo, hi,
      chunk, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, DH><<<dim3(hkv * g, b), 32, 0, st>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), hkv, g, nsplit);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, float* pm,
             float* pl, float* pa, void* out, int b, int s, int hkv, int g,
             int lo, int hi, int chunk, int nsplit, float scale,
             cudaStream_t st) {
  switch (dh) {
    case 64: return launch<T, 64>(q, k, v, pm, pl, pa, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
    case 80: return launch<T, 80>(q, k, v, pm, pl, pa, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
    case 128: return launch<T, 128>(q, k, v, pm, pl, pa, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, hkv * g, dh); k, v (b, s, hkv, dh), contiguous and 16-byte aligned,
// of one dtype (bf16 when is_bf16, else fp32); out like q.  Positions
// [lo, hi) are attended (hi = idx + 1), split into nsplit chunks of `chunk`
// positions; part_m, part_l (b, hkv, nsplit, g) and part_acc (b, hkv,
// nsplit, g, dh) fp32 scratch.  dh in {64, 80, 128}, 1 <= g <= 8.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  float* part_m, float* part_l,
                                  float* part_acc, void* out, int is_bf16,
                                  int b, int s, int hkv, int g, int dh, int lo,
                                  int hi, int chunk, int nsplit, float scale,
                                  void* stream) {
  if (g < 1 || g > kMaxG) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, part_m, part_l, part_acc, out,
                                   b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
  return dispatch<float>(dh, q, k, v, part_m, part_l, part_acc, out, b, s,
                         hkv, g, lo, hi, chunk, nsplit, scale, st);
}
