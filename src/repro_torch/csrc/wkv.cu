// The RWKV-6 WKV recurrence of the rwkv6 prefill, fp32 in and out.
//
// repro_wkv replaces src/repro/kernels/wkv/kernel.py wkv_chunked_pallas
// (B11, body _wkv_kernel): per (batch, head), with the (dh, dh) state S
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T
//   for r, k, v, w (B, S, H, dh) and u (H, dh); it also writes the final
//   state S_T (B, H, dh, dh), state[b, h, i, j] = S[i][j], which the prefill
//   hands to the decode cache (the JAX package replays the recurrence for it).
//
// Bound on an H100: 20 B H S dh bytes (r, k, v, w read once, out written
//   once) plus the final state, against 4 B H S dh^2 operations of the exact
//   recurrence: the bytes bound it (0.1014 ms at the rwkv6 serving shape).
//   The per-token recurrence cannot reach them: it needs at least 3 fp32
//   instructions per state entry and token, 0.11-0.15 ms on the FP32 pipe
//   before any load.  So this kernel leaves it, as the TPU kernel did.
//
// Design: the chunked form, overflow-safe, with its products on the tensor
//   cores.
//   - Chunks of kC = 16 tokens.  Every decay factor is a product of w's in
//     (0, 1] formed by multiplication inside the chunk, never a quotient:
//       Pex_t = prod_{u<t} w_u, Sfx_s = prod_{u>s} w_u, Pall = prod_u w_u,
//       out_t = (r_t * Pex_t)^T S + sum_{s<=t} A[t][s] v_s,
//       A[t][s] = sum_i r_t[i] k_s[i] prod_{s<u<t} w_u[i] (s < t),
//       A[t][t] = sum_i r_t[i] u[i] k_t[i] (the bonus, once per token),
//       S <- diag(Pall) S + sum_s (k_s * Sfx_s) v_s^T.
//     Inside each half of a chunk A comes from a running product walked
//     from s = t - 1 down; across the halves it is a dot of two factors
//     taken through the midpoint, r_t prod_{8<=u<t} w_u and k_s
//     prod_{s<u<8} w_u.  A factor can only underflow to 0, within 1e-38 of
//     its true value; it cannot overflow, where the TPU kernel's exp(-log P)
//     passes the fp32 range once a chunk's summed log-decay passes about
//     -88.  No logarithm or exponential is taken, so no factor is the
//     exponential of a difference of two long cumulative sums.
//   - The three products of a chunk, (C x dh)(dh x dv), (dh x C)(C x dv) and
//     (C x C)(C x dv), run as mma.sync m16n8k8 TF32 with the 3xTF32 split
//     (x = big + small, both TF32; big*big + big*small + small*big), which
//     keeps fp32 accuracy; the split is two integer operations and a
//     subtraction, done as the fragments are loaded.  The MMA warps keep S
//     transposed (value column j as the MMA row) in their accumulator
//     registers for the whole sequence; the product r S reads those
//     registers as its A operand by permuting the key index inside each
//     8-wide k-step (its B operand is read under the same permutation), so S
//     never goes through memory.
//   - One block per (batch, head): dh/16 MMA warps, each owning 16 value
//     columns, consume chunk c - 1 while dh/16 prep warps turn chunk c into
//     operands, one __syncthreads a chunk.  The prep warps work in two
//     halves side by side (the decay products of a column; the in-half
//     scores, reduced across lanes in a fixed order), then together on the
//     scores across the halves.  The value columns are split over warps, not
//     over blocks, so that the scores and the decay products are formed once
//     per chunk and head.
//   - r, k, v, w arrive by cp.async (16-byte copies; 4-byte ones when an
//     operand does not start on 16 bytes) into three raw stages: chunk c + 1
//     loads, chunk c is prepared, and the MMA warps read chunk c - 1's V
//     straight from its stage.  The prep warps issue chunk c + 1's copies
//     once chunk c has landed, not before their wait: copies issued earlier
//     stall them for as long as the copies take at the memory's rate.  A
//     ragged tail is masked in shared memory (r = k = v = 0, w = 1: the
//     state is left as it was).
//   Every sum has a fixed order and no float atomics are used: the same bits
//   on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kC = 16;      // tokens per chunk (the MMA row tile)
constexpr int kH = kC / 2;  // tokens per half chunk
constexpr int kPA = 20;     // padded row of the score tile (conflict-free B loads)
constexpr int kAhead = 1;   // chunks loading ahead of the one being prepared
constexpr int kRaw = kAhead + 2;   // raw stages: loading, prepared, V read by the MMAs

template <int DH>
struct Wkv {
  static constexpr int warps = DH / 16;            // prep warps = MMA warps
  static constexpr int prep = 32 * warps;          // prep threads (2 DH)
  static constexpr int threads = 2 * prep;
  static constexpr int lanes = DH / 8;             // lanes of a score group, 8 keys each
  static constexpr int P = DH + 8;                 // padded row (conflict-free fragments)
  static constexpr int tile = kC * P;              // one chunk tile (r, k, v, w, rd or kd)
  static constexpr int raw_stage = 4 * tile;       // r, k, v, w
  static constexpr int stage = 2 * tile + 2 * kC * kPA + DH;   // rd, kd, A big/small, Pall
  static constexpr int cross = 2 * kH * P;         // r and k factors across the halves
  static constexpr int floats = kRaw * raw_stage + 2 * stage + cross + DH;   // + u
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// x = big + small: big is x rounded to TF32 (10 fraction bits, ties away
// from zero, as cvt.rna.tf32.f32 rounds, in two integer operations), small
// = x - big exactly; the MMA reads small to TF32 precision, so big + small
// holds x to about 2^-21 relative, and the dropped small x small term of a
// product is below 2^-22 of it.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a b to fp32 accuracy, with a and b split into big + small and
// the small x small term dropped; the correction terms go first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(d, as, bb[0], bb[1]);
  mma(d, ab, bs[0], bs[1]);
  mma(d, ab, bb[0], bb[1]);
}

__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  split(x0, big[0], small[0]);
  split(x1, big[1], small[1]);
}

__device__ __forceinline__ void bar_prep(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Sum of x over the L lanes of an aligned lane group, on every lane.
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sums of v[0..8) over the L lanes (4 or 8) of an aligned lane group,
// scattered: afterwards lane li holds in v[m] the sum of entry li * (8 / L)
// + m, for m < 8 / L.  Each level keeps half of the entries (7 shuffles at
// L = 8 where 8 separate sums would take 24); the halves are swapped by an
// xor of bit patterns, so no entry is indexed at run time.
template <int L>
__device__ __forceinline__ void reduce_scatter8(float (&v)[8], int li) {
  static_assert(L == 4 || L == 8, "groups of 4 or 8 lanes");
  constexpr int levels = L == 8 ? 3 : 2;
#pragma unroll
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int o = L >> (lvl + 1);
    const int half = 4 >> lvl;
    const uint32_t up = (li & o) ? 0xffffffffu : 0u;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const uint32_t a = __float_as_uint(v[m]), b = __float_as_uint(v[m + half]);
      const uint32_t x = (a ^ b) & up;                 // up: keep b, send a
      v[m] = __uint_as_float(a ^ x) + __shfl_xor_sync(0xffffffffu, __uint_as_float(b ^ x), o);
    }
  }
}

// The operands one chunk's MMAs read: r * Pex and k * Sfx in fp32, the C x C
// scores A (strict upper triangle zero) split into TF32 halves, and Pall.
template <int DH>
struct Stage {
  float *rd, *kd, *pall;
  uint32_t *ab, *as;
  __device__ explicit Stage(float* base) {
    using W = Wkv<DH>;
    rd = base;
    kd = base + W::tile;
    ab = reinterpret_cast<uint32_t*>(base + 2 * W::tile);
    as = ab + kC * kPA;
    pall = reinterpret_cast<float*>(as + kC * kPA);
  }
};

// Chunk c's r, k, v, w into a raw stage (rows of P floats; rows past n
// masked: r = k = v = 0, w = 1), issued by the prep threads as one group of
// cp.async copies: 16-byte copies, or 4-byte ones on the unaligned path.
template <int DH, bool ALIGNED>
__device__ __forceinline__ void load_chunk(float* raw, const float* r, const float* k,
                                           const float* v, const float* w, size_t head0,
                                           size_t tok, int n, int pt) {
  using W = Wkv<DH>;
  constexpr int per = ALIGNED ? 4 : 1;             // floats a copy
  constexpr int row = DH / per;                    // copies a row
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
#pragma unroll
    for (int e = pt; e < kC * row; e += W::prep) {
      const int t = e / row, d = (e % row) * per;
      float* to = raw + a * W::tile + t * W::P + d;
      if (t < n) {
        const float* from = src + head0 + (size_t)t * tok + d;
        if constexpr (ALIGNED) repro::cp_async16(smem_addr(to), from);
        else cp_async4(smem_addr(to), from);
      } else {
#pragma unroll
        for (int q = 0; q < per; ++q) to[q] = a == 3 ? 1.f : 0.f;
      }
    }
  }
  repro::cp_async_commit();
}

// The prep warps: one raw chunk -> the operands of its MMAs, in two halves
// that run side by side: the first DH threads form the decay products of
// their column, the other DH the scores A[t][s] (s < t) inside each half of
// the chunk (t, s < 8 or t, s >= 8) by a running product walked from s = t - 1
// down.  Then all of them form the scores across the halves (t >= 8 > s)
// through the midpoint, as dots of r_t prod_{8<=u<t} w_u and k_s
// prod_{s<u<8} w_u, both factors <= 1.
template <int DH>
__device__ __forceinline__ void prep_chunk(const float* raw, Stage<DH> st, float* cross,
                                           const float* su, int pt) {
  using W = Wkv<DH>;
  constexpr int P = W::P;
  const float* R = raw;
  const float* K = raw + W::tile;
  const float* Wd = raw + 3 * W::tile;
  float* R8 = cross;                                 // rows t = 8 .. 15
  float* K8 = cross + kH * W::P;                    // rows s = 0 .. 7

  if (pt < DH) {
    // column i: r * Pex, Pall and r's cross factor running forward, k * Sfx
    // and k's cross factor running backward, each a product of the column's w
    const int i = pt;
    float x[kC], y[kC], wt[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      x[t] = R[t * P + i];
      y[t] = K[t * P + i];
      wt[t] = Wd[t * P + i];
    }
    float run = 1.f, run8 = 1.f, back = 1.f, back8 = 1.f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int tb = kC - 1 - t;
      st.rd[t * P + i] = x[t] * run;
      st.kd[tb * P + i] = y[tb] * back;
      if (t >= kH) {
        R8[(t - kH) * W::P + i] = x[t] * run8;
        run8 *= wt[t];
      }
      if (tb < kH) {
        K8[tb * W::P + i] = y[tb] * back8;
        back8 *= wt[tb];
      }
      run *= wt[t];
      back *= wt[tb];
    }
    st.pall[i] = run;
  } else {
    // scores inside the halves: group g of L lanes (keys 4 li .. 4 li + 3 and
    // the same DH / 2 on, on lane li) in half hf takes the rows tA = 8 hf + gg + 1 and tB = 8 hf +
    // 7 - gg (8 entries in all; gg = 3 takes row 8 hf + 4 and the bonus of
    // row 8 hf), walking s down from t - 1 with h = r_t prod_{s<u<t} w_u
    constexpr int L = W::lanes;
    const int q0 = pt - DH, g = q0 / L, li = q0 % L, hf = g / 4, gg = g % 4;
    const int nA = gg < 3 ? gg + 1 : 4;              // entries of row tA
    const int tA = kH * hf + nA;
    const int tB = gg < 3 ? kH * hf + kH - 1 - gg : kH * hf;
    auto ld8 = [&](const float* rowp, float4& a, float4& b) {
      a = *reinterpret_cast<const float4*>(rowp + 4 * li);
      b = *reinterpret_cast<const float4*>(rowp + 4 * li + DH / 2);
    };
    float4 u0, u1, rA0, rA1, rB0, rB1, kA0, kA1, kB0, kB1;
    ld8(su, u0, u1);
    ld8(R + tA * P, rA0, rA1);
    ld8(R + tB * P, rB0, rB1);
    ld8(K + tA * P, kA0, kA1);
    ld8(K + tB * P, kB0, kB1);
    auto mul4 = [](float4 a, float4 b) {
      return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
    };
    const float dA = group_sum<L>(
        repro::dot4(rA1, mul4(u1, kA1), repro::dot4(rA0, mul4(u0, kA0), 0.f)));
    const float dB = group_sum<L>(
        repro::dot4(rB1, mul4(u1, kB1), repro::dot4(rB0, mul4(u0, kB0), 0.f)));
    if (li == 0) split(dA, st.ab[tA * kPA + tA], st.as[tA * kPA + tA]);
    if (li == 1) split(dB, st.ab[tB * kPA + tB], st.as[tB * kPA + tB]);

    float vals[kH];
    float4 h0 = rA0, h1 = rA1;
#pragma unroll
    for (int q = 0; q < kH; ++q) {
      if (q == nA) {
        h0 = rB0;
        h1 = rB1;
      }
      const int s = q < nA ? tA - 1 - q : kH * hf + kH - 1 - q;
      float4 k0, k1, w0, w1;
      ld8(K + s * P, k0, k1);
      ld8(Wd + s * P, w0, w1);
      vals[q] = repro::dot4(h1, k1, repro::dot4(h0, k0, 0.f));
      h0 = mul4(h0, w0);
      h1 = mul4(h1, w1);
    }
    reduce_scatter8<L>(vals, li);
#pragma unroll
    for (int m = 0; m < kH / L; ++m) {
      const int q = li * (kH / L) + m;
      if (gg == 3 && q >= 4) continue;               // row 8 hf has no s < t
      const int t = q < nA ? tA : tB;
      const int s = q < nA ? tA - 1 - q : kH * hf + kH - 1 - q;
      split(vals[m], st.ab[t * kPA + s], st.as[t * kPA + s]);
    }
  }
  // scores across the halves, once every prep thread's factors are in:
  // entry (t, s) = (8 + e / 8, e % 8) by two lanes (keys 8c + 4 hb .. + 3)
  bar_prep(W::prep);
#pragma unroll
  for (int e2 = pt; e2 < 2 * kH * kH; e2 += W::prep) {
    const int e = e2 >> 1, hb = e2 & 1;
    const float* rr = R8 + (e / kH) * W::P + 4 * hb;
    const float* kk = K8 + (e % kH) * W::P + 4 * hb;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; c += 2) {
      a0 = repro::dot4(*reinterpret_cast<const float4*>(rr + 8 * c),
                       *reinterpret_cast<const float4*>(kk + 8 * c), a0);
      a1 = repro::dot4(*reinterpret_cast<const float4*>(rr + 8 * c + 8),
                       *reinterpret_cast<const float4*>(kk + 8 * c + 8), a1);
    }
    float total = a0 + a1;
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    if (hb == 0) {
      const int t = kH + e / kH, s = e % kH;
      split(total, st.ab[t * kPA + s], st.as[t * kPA + s]);
    }
  }
}

// One MMA warp: out of the chunk for its 16 value columns, then the state.
// S[p] is the accumulator tile of S^T rows j0 .. j0 + 15 (value columns),
// columns 8p .. 8p + 7 (keys): S[p][0] = S[8p + 2 tig][j0 + gid], [1] key + 1,
// [2] value + 8, [3] both.  rd, kd and V are fp32 in shared memory and are
// split into TF32 halves as their fragments are loaded.
template <int DH>
__device__ __forceinline__ void mma_chunk(Stage<DH> st, const float* V, float (&S)[DH / 8][4],
                                          float* out, size_t tok, int n, int j0, int lane) {
  using W = Wkv<DH>;
  constexpr int P = W::P;
  const int gid = lane >> 2, tig = lane & 3;

  // V^T as the A operand (rows j, k-steps over s), both halves, both k-steps
  uint32_t vb[2][4], vs[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* v0 = V + (8 * kk + tig) * P + j0 + gid;
    split(v0[0], vb[kk][0], vs[kk][0]);
    split(v0[8], vb[kk][1], vs[kk][1]);
    split(v0[4 * P], vb[kk][2], vs[kk][2]);
    split(v0[4 * P + 8], vb[kk][3], vs[kk][3]);
  }

  // out^T (rows j, columns t) = S^T (r * Pex)^T + V^T A^T, the big part and
  // the correction terms in separate accumulators
  float ob[2][4] = {}, os[2][4] = {};
#pragma unroll
  for (int p = 0; p < DH / 8; ++p) {
    // S^T's accumulator tile as an A operand: k = tig <-> key 8p + 2 tig,
    // k = tig + 4 <-> key 8p + 2 tig + 1 (the B loads below follow it)
    uint32_t sb[4], ss[4];
    split(S[p][0], sb[0], ss[0]);
    split(S[p][2], sb[1], ss[1]);
    split(S[p][1], sb[2], ss[2]);
    split(S[p][3], sb[3], ss[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(st.rd + (8 * nt + gid) * P + 8 * p +
                                                        2 * tig);
      uint32_t rb[2], rs[2];
      split2(x.x, x.y, rb, rs);
      mma(os[nt], ss, rb[0], rb[1]);
      mma(os[nt], sb, rs[0], rs[1]);
      mma(ob[nt], sb, rb[0], rb[1]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int o = (8 * nt + gid) * kPA + 8 * kk + tig;
      const uint32_t ab[2] = {st.ab[o], st.ab[o + 4]}, as[2] = {st.as[o], st.as[o + 4]};
      mma(os[nt], vs[kk], ab[0], ab[1]);
      mma(os[nt], vb[kk], as[0], as[1]);
      mma(ob[nt], vb[kk], ab[0], ab[1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 8 * nt + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
      if (t < n) out[(size_t)t * tok + j] = ob[nt][e] + os[nt][e];
    }
  }

  // S^T <- S^T diag(Pall) + V^T (k * Sfx)
#pragma unroll
  for (int p = 0; p < DH / 8; ++p) {
    const float2 pa = *reinterpret_cast<const float2*>(st.pall + 8 * p + 2 * tig);
    S[p][0] *= pa.x; S[p][1] *= pa.y; S[p][2] *= pa.x; S[p][3] *= pa.y;
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int p = 0; p < DH / 8; ++p) {
      const float* k0 = st.kd + (8 * kk + tig) * P + 8 * p + gid;
      uint32_t kb[2], ks[2];
      split2(k0[0], k0[4 * P], kb, ks);
      mma3(S[p], vb[kk], vs[kk], kb, ks);
    }
  }
}

template <int DH, bool ALIGNED>
__global__ void __launch_bounds__(Wkv<DH>::threads, 2)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ out,
           float* __restrict__ state_out, int s, int h) {
  using W = Wkv<DH>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* raw = sm;                                   // kRaw raw stages
  float* der = sm + kRaw * W::raw_stage;             // 2 operand stages
  float* cross = der + 2 * W::stage;                 // the cross factors (prep only)
  float* su = cross + W::cross;
  const int hh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_prep = warp < W::warps;
  const int nch = (s + kC - 1) / kC;
  const size_t tok = (size_t)h * DH;                 // stride of one token
  const size_t head0 = (size_t)b * s * tok + (size_t)hh * DH;

  // the strict upper triangles of the score tiles stay zero
  for (int e = threadIdx.x; e < 2 * kC * kPA; e += W::threads) {
    Stage<DH> st(der + (e / (kC * kPA)) * W::stage);
    st.ab[e % (kC * kPA)] = 0u;
    st.as[e % (kC * kPA)] = 0u;
  }
  auto load = [&](int c) {                          // chunk c's copies, one group
    if (c < nch)
      load_chunk<DH, ALIGNED>(raw + (c % kRaw) * W::raw_stage, r, k, v, w,
                              head0 + (size_t)c * kC * tok, tok, min(kC, s - c * kC),
                              threadIdx.x);
    else
      repro::cp_async_commit();                    // an empty group keeps the count
  };
  if (is_prep) {
    if (threadIdx.x < DH) su[threadIdx.x] = u[(size_t)hh * DH + threadIdx.x];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) load(c);
  }
  __syncthreads();

  float S[DH / 8][4];
#pragma unroll
  for (int p = 0; p < DH / 8; ++p) S[p][0] = S[p][1] = S[p][2] = S[p][3] = 0.f;
  const int j0 = 16 * (warp - W::warps);

  // iteration c: the prep warps issue chunk c + kAhead's copies and prepare
  // chunk c, while the MMA warps consume chunk c - 1 (its operands and its
  // raw V)
  for (int c = 0; c <= nch; ++c) {
    if (is_prep) {
      if (c < nch) {
        repro::cp_async_wait<kAhead - 1>();          // chunk c has landed (own copies)
        bar_prep(W::prep);                           // ... and every prep thread's
        load(c + kAhead);
        prep_chunk<DH>(raw + (c % kRaw) * W::raw_stage, Stage<DH>(der + (c & 1) * W::stage),
                       cross, su, threadIdx.x);
      }
    } else if (c > 0) {
      const int c0 = c - 1;
      mma_chunk<DH>(Stage<DH>(der + (c0 & 1) * W::stage),
                    raw + (c0 % kRaw) * W::raw_stage + 2 * W::tile, S,
                    out + head0 + (size_t)c0 * kC * tok, tok, min(kC, s - c0 * kC), j0, lane);
    }
    __syncthreads();
  }

  if (!is_prep) {
    float* dst = state_out + ((size_t)b * h + hh) * DH * DH;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int p = 0; p < DH / 8; ++p) {
      const int i = 8 * p + 2 * tig, j = j0 + gid;
      dst[(size_t)i * DH + j] = S[p][0];
      dst[(size_t)(i + 1) * DH + j] = S[p][1];
      dst[(size_t)i * DH + j + 8] = S[p][2];
      dst[(size_t)(i + 1) * DH + j + 8] = S[p][3];
    }
  }
}

template <int DH, bool ALIGNED>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* out, float* state, int b, int s, int h, cudaStream_t st) {
  using W = Wkv<DH>;
  auto kern = wkv_kernel<DH, ALIGNED>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(h, b), W::threads, W::bytes, st>>>(r, k, v, w, u, out, state, s, h);
  return cudaGetLastError();
}

template <int DH>
int launch_dh(const float* r, const float* k, const float* v, const float* w, const float* u,
              float* out, float* state, int b, int s, int h, int aligned, cudaStream_t st) {
  return aligned ? launch<DH, true>(r, k, v, w, u, out, state, b, s, h, st)
                 : launch<DH, false>(r, k, v, w, u, out, state, b, s, h, st);
}

}  // namespace

// r, k, v, w, out (b, s, h, dh); u (h, dh); state (b, h, dh, dh) with
// state[b, h, i, j] = S[i][j] (key i, value j); all fp32 and contiguous.
// dh in {32, 64} (the rwkv configs' head dims); aligned != 0 when r, k, v
// and w all start on 16 bytes (the 16-byte copy path).  Grid (h, b), 4 dh
// threads a block, repro_wkv_smem(dh) bytes of dynamic shared memory.
extern "C" int repro_wkv(const float* r, const float* k, const float* v, const float* w,
                         const float* u, float* out, float* state, int b, int s, int h,
                         int dh, int aligned, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_dh<32>(r, k, v, w, u, out, state, b, s, h, aligned, st);
    case 64: return launch_dh<64>(r, k, v, w, u, out, state, b, s, h, aligned, st);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block at head dim dh (0: no kernel).
extern "C" int repro_wkv_smem(int dh) {
  switch (dh) {
    case 32: return (int)Wkv<32>::bytes;
    case 64: return (int)Wkv<64>::bytes;
    default: return 0;
  }
}

// ---------------------------------------------------------------------------
// The backward: dr, dk, dv, dw, du of the same recurrence, given dO.
//
// Nothing of the TPU package is its twin: repro/kernels/wkv has no backward,
// and the JAX package's training differentiates its plain scan.  The port's
// training runs B11 on the card, so its gradient is a kernel too
// (kernels/wkv/ops.py wkv_train, a torch.autograd.Function).  With G_t =
// dL/dS_t (G_{S-1} = 0: the final state is not an output of the training
// call), the recurrence's reverse form:
//   a_t = v_t . g_t,  b_t = sum_i r_t[i] u[i] k_t[i]      (g_t = dO_t)
//   dr_t[i] = sum_j S_{t-1}[i][j] g_t[j] + u[i] k_t[i] a_t
//   dk_t[i] = sum_j G_t[i][j] v_t[j]     + r_t[i] u[i] a_t
//   dv_t[j] = sum_i G_t[i][j] k_t[i]     + g_t[j] b_t
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_b sum_t r_t[i] k_t[i] a_t
//   G_{t-1} = diag(w_t) G_t + r_t g_t^T.
// S_{t-1} is recomputed forward, never recovered by dividing by w (w =
// exp(-exp(.)) reaches 0 in fp32): a first pass over the sequence writes the
// state at the start of every kCk-token chunk to a scratch; the reverse pass
// then, chunk by chunk from the last, recomputes the chunk's kCk states
// from its start into shared memory and walks its tokens backward.
//
// Bound on an H100: the reverse form's five dh x dh updates and reductions,
// 10 B H S dh^2 FLOPs, against fp32's 67 TFLOP/s, and 36 B H S dh bytes (r,
// k, v, w, dO read, dr, dk, dv, dw written); the states' recomputation (2 B
// H S dh^2 more) and the scratch (4 B H ceil(S / kCk) dh^2 bytes each way)
// come on top.  The design is the simple one: a block per (batch, head),
// sequential in t.  Thread (i, quarter) owns row i of S and G, columns
// [quarter dh / 4, +dh / 4): S and G update elementwise, the row sums (dr,
// dk, dw) reduce over the row's 4 lanes by a fixed butterfly, and the column
// sums (dv) over the warp's 8 rows by a transposed butterfly (each step
// halves the values a lane holds), then over the warps in index order.
// du's per-(batch, head) partials are summed over the batch in order by a
// second launch.  No float atomics: the same bits on every run.
namespace wkvb {

constexpr int kCk = 8;      // tokens per chunk of the reverse pass

template <int DH>
struct Cfg {
  static constexpr int threads = 4 * DH;
  static constexpr int warps = threads / 32;
  static constexpr int E = DH / 4;                    // columns a thread owns
  static constexpr int states = kCk * E * threads;    // thread-private S_{t-1}
  static constexpr int inputs = 5 * kCk * DH;         // r, k, v, w, g of a chunk
  static constexpr int floats = states + inputs + 2 * kCk + kCk * warps * DH + DH;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// tokens [t0, t0 + n) of (b, s, h, DH) tensor x at (b, h) into dst [kCk][DH]
template <int DH>
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ x, int b, int t0,
                                           int n, int s, int h, int hh) {
  for (int e = threadIdx.x; e < n * DH; e += Cfg<DH>::threads) {
    const int t = e / DH, d = e % DH;
    dst[e] = x[(((size_t)b * s + t0 + t) * h + hh) * DH + d];
  }
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::threads, 1)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dout,
               float* __restrict__ ckpt, float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
               int s, int h) {
  using C = Cfg<DH>;
  constexpr int NT = C::threads, E = C::E;
  extern __shared__ float smem[];
  float* sSt = smem;                   // [kCk][E][NT]
  float* sr = sSt + C::states;         // [kCk][DH] each
  float* sk = sr + kCk * DH;
  float* sv = sk + kCk * DH;
  float* sw = sv + kCk * DH;
  float* sg = sw + kCk * DH;
  float* sA = sg + kCk * DH;           // a_t = v_t . g_t
  float* sB = sA + kCk;                // b_t = sum_i r_t u k_t
  float* sDv = sB + kCk;               // [kCk][warps][DH] per-warp column sums
  float* su = sDv + kCk * C::warps * DH;

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, j0 = (tid & 3) * E;
  const int nck = (s + kCk - 1) / kCk;
  float* my_ckpt = ckpt + ((size_t)b * h + hh) * nck * DH * DH;
  for (int d = tid; d < DH; d += NT) su[d] = u[hh * DH + d];

  // pass 1: the state at the start of every chunk
  float st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) st[e] = 0.f;
  for (int c = 0; c < nck; ++c) {
    const int t0 = c * kCk, n = min(kCk, s - t0);
    __syncthreads();
    load_chunk<DH>(sk, k, b, t0, n, s, h, hh);
    load_chunk<DH>(sv, v, b, t0, n, s, h, hh);
    load_chunk<DH>(sw, w, b, t0, n, s, h, hh);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) my_ckpt[(size_t)c * DH * DH + e * NT + tid] = st[e];
    for (int t = 0; t < n; ++t) {
      const float wi = sw[t * DH + i], ki = sk[t * DH + i];
#pragma unroll
      for (int e = 0; e < E; ++e) st[e] = fmaf(wi, st[e], ki * sv[t * DH + j0 + e]);
    }
  }

  // pass 2: backward, chunk by chunk from the last
  float gs[E];
#pragma unroll
  for (int e = 0; e < E; ++e) gs[e] = 0.f;
  float du_acc = 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kCk, n = min(kCk, s - t0);
    __syncthreads();                   // the previous chunk's shared data is consumed
    load_chunk<DH>(sr, r, b, t0, n, s, h, hh);
    load_chunk<DH>(sk, k, b, t0, n, s, h, hh);
    load_chunk<DH>(sv, v, b, t0, n, s, h, hh);
    load_chunk<DH>(sw, w, b, t0, n, s, h, hh);
    load_chunk<DH>(sg, dout, b, t0, n, s, h, hh);
    __syncthreads();
    for (int t = warp; t < n; t += C::warps) {   // the bonus term's two dots
      float a = 0.f, bb = 0.f;
      for (int d = lane; d < DH; d += 32) {
        a = fmaf(sv[t * DH + d], sg[t * DH + d], a);
        bb = fmaf(sr[t * DH + d] * su[d], sk[t * DH + d], bb);
      }
      a = repro::warp_sum(a);
      bb = repro::warp_sum(bb);
      if (lane == 0) {
        sA[t] = a;
        sB[t] = bb;
      }
    }
    // this thread's S_{t-1} for the chunk's tokens, from the chunk's start
#pragma unroll
    for (int e = 0; e < E; ++e) st[e] = my_ckpt[(size_t)c * DH * DH + e * NT + tid];
    for (int t = 0; t < n; ++t) {
      const float wi = sw[t * DH + i], ki = sk[t * DH + i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sSt[(t * E + e) * NT + tid] = st[e];
        st[e] = fmaf(wi, st[e], ki * sv[t * DH + j0 + e]);
      }
    }
    __syncthreads();                   // sA, sB

    for (int t = n - 1; t >= 0; --t) {
      const float ri = sr[t * DH + i], ki = sk[t * DH + i], wi = sw[t * DH + i];
      float sp[E], vv[E], gg[E], cs[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sp[e] = sSt[(t * E + e) * NT + tid];
        vv[e] = sv[t * DH + j0 + e];
        gg[e] = sg[t * DH + j0 + e];
      }
      float rw = 0.f, rk = 0.f, rr = 0.f;   // row partials of dw, dk, dr
#pragma unroll
      for (int e = 0; e < E; ++e) {
        rw = fmaf(gs[e], sp[e], rw);
        rk = fmaf(gs[e], vv[e], rk);
        rr = fmaf(sp[e], gg[e], rr);
        cs[e] = gs[e] * ki;                 // column partials of dv
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        rw += __shfl_xor_sync(0xffffffffu, rw, o);
        rk += __shfl_xor_sync(0xffffffffu, rk, o);
        rr += __shfl_xor_sync(0xffffffffu, rr, o);
      }
      // the warp's 8 rows: a transposed butterfly over lane bits 4, 3, 2;
      // after it this lane holds columns j0 + cb + [0, E / 8)
      int cb = 0;
#pragma unroll
      for (int step = 0; step < 3; ++step) {
        const int half = E >> (step + 1), mask = 16 >> step;
        const bool hi = lane & mask;
#pragma unroll
        for (int e = 0; e < half; ++e) {
          const float send = hi ? cs[e] : cs[e + half];
          const float keep = hi ? cs[e + half] : cs[e];
          cs[e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
        if (hi) cb += half;
      }
#pragma unroll
      for (int e = 0; e < E / 8; ++e) sDv[(t * C::warps + warp) * DH + j0 + cb + e] = cs[e];
      const size_t row = (((size_t)b * s + t0 + t) * h + hh) * DH + i;
      const float at = sA[t];
      switch (tid & 3) {
        case 0:
          dr[row] = rr + su[i] * ki * at;
          du_acc = fmaf(ri * ki, at, du_acc);
          break;
        case 1: dk[row] = rk + ri * su[i] * at; break;
        case 2: dw[row] = rw; break;
        default: break;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) gs[e] = fmaf(wi, gs[e], ri * gg[e]);
    }
    __syncthreads();                   // sDv
    for (int e = tid; e < n * DH; e += NT) {
      const int t = e / DH, j = e % DH;
      float acc = 0.f;
      for (int q = 0; q < C::warps; ++q) acc += sDv[(t * C::warps + q) * DH + j];
      dv[(((size_t)b * s + t0 + t) * h + hh) * DH + j] = acc + sg[e] * sB[t];
    }
  }
  if ((tid & 3) == 0) du_part[((size_t)b * h + hh) * DH + i] = du_acc;
}

// du[hh][i] = sum over b of du_part[b][hh][i], b in order
__global__ void wkv_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int b,
                              int hdh) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hdh) return;
  float acc = 0.f;
  for (int q = 0; q < b; ++q) acc += du_part[(size_t)q * hdh + e];
  du[e] = acc;
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* dout, float* ckpt, float* dr, float* dk, float* dv, float* dw,
           float* du_part, float* du, int b, int s, int h, cudaStream_t st) {
  using C = Cfg<DH>;
  auto* kern = wkv_bwd_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(h, b), C::threads, C::bytes, st>>>(r, k, v, w, u, dout, ckpt, dr, dk, dv, dw,
                                                 du_part, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hdh = h * DH;
  wkv_du_kernel<<<(hdh + 127) / 128, 128, 0, st>>>(du_part, du, b, hdh);
  return cudaGetLastError();
}

}  // namespace wkvb

// The backward of repro_wkv: r, k, v, w, dout, dr, dk, dv, dw (b, s, h, dh);
// u, du (h, dh); ckpt a (b, h, ceil(s / 8), dh, dh) scratch and du_part a
// (b, h, dh) scratch; all fp32 and contiguous, dh in {32, 64}.  Two launches
// (the reverse pass, the sum of du over b), each checked.
extern "C" int repro_wkv_bwd(const float* r, const float* k, const float* v, const float* w,
                             const float* u, const float* dout, float* ckpt, float* dr,
                             float* dk, float* dv, float* dw, float* du_part, float* du, int b,
                             int s, int h, int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return wkvb::launch<32>(r, k, v, w, u, dout, ckpt, dr, dk, dv, dw, du_part, du,
                                     b, s, h, st);
    case 64: return wkvb::launch<64>(r, k, v, w, u, dout, ckpt, dr, dk, dv, dw, du_part, du,
                                     b, s, h, st);
    default: return cudaErrorInvalidValue;
  }
}
