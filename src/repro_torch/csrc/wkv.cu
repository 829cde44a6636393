// The RWKV-6 WKV recurrence of the rwkv6 prefill, fp32 throughout.
//
// repro_wkv replaces src/repro/kernels/wkv/kernel.py wkv_chunked_pallas
// (B11, body _wkv_kernel): per (batch, head), with the (dh, dh) state S
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T
//   for r, k, v, w (B, S, H, dh) and u (H, dh); it also writes the final
//   state S_T (B, H, dh, dh), which the prefill hands to the decode cache
//   (the JAX package replays the recurrence for it).
//   The TPU kernel walked the chunks of the sequence as a sequential grid
//   axis and kept S in VMEM scratch, in the chunked linear-attention form.
//   Here one block owns a (batch, head) and walks the sequence itself with S
//   in registers: thread (j, ks) holds S[i][j] for the dh/4 keys i = ks
//   (mod 4), so a step costs each thread dh/4 fused updates and the block's
//   dh x 4 threads cover the state once.  This is the exact per-token
//   recurrence, which cannot overflow: the chunked form's exp(-log P) grows
//   past the fp32 range once a chunk's summed log-decay passes about -88.
//   r, k, v and w of 32 tokens at a time are staged in shared memory, so the
//   loads are coalesced and a step reads them as broadcasts.
// Bound on an H100: 4 B H S dh^2 fp32 operations against 20 B H S dh bytes
//   (r, k, v, w read once, out written once), dh/5 operations per byte:
//   12.8 at dh=64, below the card's 20 fp32 operations per byte, so the
//   bytes bound it on paper.  In practice the recurrence is serial in t and
//   the parallelism is B H blocks of dh x 4 threads (256 blocks of 256
//   threads at the rwkv6 serving shape, two per SM), so the chain of
//   dependent steps, not the memory, sets this kernel's time.  The sum over
//   the 4 key slices of out_t is a fixed xor butterfly: the same bits on
//   every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kKs = 4;   // key slices per value column

template <int DH>
struct WkvShape {
  static constexpr int threads = DH * kKs;
  static constexpr int steps = 32;                   // tokens staged at a time
  static constexpr int keys = DH / kKs;              // state entries per thread
};

template <int DH>
__global__ void __launch_bounds__(WkvShape<DH>::threads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ out,
           float* __restrict__ state_out, int s, int h) {
  using Sh = WkvShape<DH>;
  constexpr int T = Sh::steps;
  __shared__ float sr[T][DH], sk[T][DH], sv[T][DH], sw[T][DH];
  __shared__ float su[DH];
  const int hh = blockIdx.x, b = blockIdx.y;
  const int j = threadIdx.x / kKs, ks = threadIdx.x % kKs;
  if (threadIdx.x < DH) su[threadIdx.x] = u[(size_t)hh * DH + threadIdx.x];

  float st[Sh::keys];
#pragma unroll
  for (int ii = 0; ii < Sh::keys; ++ii) st[ii] = 0.f;

  const size_t tok = (size_t)h * DH;                 // stride of one token
  const size_t head0 = (size_t)b * s * tok + (size_t)hh * DH;
  for (int t0 = 0; t0 < s; t0 += T) {
    const int nt = min(T, s - t0);
    __syncthreads();                                 // the last chunk is consumed
    for (int e = threadIdx.x; e < nt * DH; e += Sh::threads) {
      const int tt = e / DH, d = e % DH;
      const size_t off = head0 + (size_t)(t0 + tt) * tok + d;
      sr[tt][d] = r[off];
      sk[tt][d] = k[off];
      sv[tt][d] = v[off];
      sw[tt][d] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = sv[tt][j];
      float o = 0.f;
#pragma unroll
      for (int ii = 0; ii < Sh::keys; ++ii) {
        const int i = ii * kKs + ks;
        const float kv = sk[tt][i] * vj;
        o = fmaf(sr[tt][i], st[ii] + su[i] * kv, o);
        st[ii] = fmaf(sw[tt][i], st[ii], kv);
      }
#pragma unroll
      for (int off = kKs / 2; off > 0; off >>= 1)
        o += __shfl_xor_sync(0xffffffffu, o, off);
      if (ks == 0) out[head0 + (size_t)(t0 + tt) * tok + j] = o;
    }
  }

  float* dst = state_out + ((size_t)b * h + hh) * DH * DH;
#pragma unroll
  for (int ii = 0; ii < Sh::keys; ++ii) dst[(size_t)(ii * kKs + ks) * DH + j] = st[ii];
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* out, float* state, int b, int s, int h,
           cudaStream_t st) {
  wkv_kernel<DH><<<dim3(h, b), WkvShape<DH>::threads, 0, st>>>(
      r, k, v, w, u, out, state, s, h);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, out (b, s, h, dh); u (h, dh); state (b, h, dh, dh) with
// state[b, h, i, j] = S[i][j] (key i, value j); all fp32 and contiguous.
// dh in {32, 64} (the rwkv configs' head dims).
extern "C" int repro_wkv(const float* r, const float* k, const float* v,
                         const float* w, const float* u, float* out,
                         float* state, int b, int s, int h, int dh,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(r, k, v, w, u, out, state, b, s, h, st);
    case 64: return launch<64>(r, k, v, w, u, out, state, b, s, h, st);
    default: return cudaErrorInvalidValue;
  }
}
