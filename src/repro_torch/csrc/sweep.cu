// The fused ICOA agent update (alpha = 1): one probe pass and one commit pass
// over the residual matrix R (D, N), each followed by a one-block epilogue
// that evaluates the O(D^2) closed-form algebra in fp32.
//
// repro_probe_sweep replaces src/repro/kernels/sweep/kernel.py
// probe_sweep_pallas (B5) and its epilogue _probe_finalize:
//   cross = s^T R (N,), p = R cross (D,), ||cross||^2, then the whole K-step
//   back-search schedule against m_inv.  cross and p are two orthogonal
//   reductions of the same tile, so each block loads a D x BN tile of R into
//   shared memory once: one thread per column forms cross (and ||cross||^2),
//   then one warp per row forms the partial p from the tile in shared memory.
//   Bound on an H100: the one read of R, about 2 FMAs per 4 bytes.  BN is
//   chosen by the wrapper so that the tile fits the 227 KB of shared memory.
//
// repro_commit_sweep replaces kernel.py commit_sweep_pallas (B7) and its
// epilogue _commit_finalize:
//   w = R delta / m and <delta, delta> in one streaming pass (the row_gram
//   scheme), then u, z1 = m_inv[i], z2 = m_inv u, the SMW pivots, obj_post,
//   accept = (obj_post > threshold) && can_tx, and the rank-2 m_inv / s update
//   selected by accept, so a reject leaves m_inv and s bitwise unchanged.
//   Bound: the one read of R.  eta, threshold and can_tx are read from device
//   memory, so the agent loop commits without a host round trip.
//
// repro_probe_sweep_batched and repro_commit_sweep_batched replace
// probe_sweep_pallas_batched (B6) and commit_sweep_pallas_batched (B8): the
// same agent update for B independent Monte-Carlo trials, every operand with
// a leading trial axis (R (B, D, N), m_inv (B, D, D), s (B, D); eta,
// threshold and can_tx (B,) device tensors) while agent i, the step schedule
// and the diagonal constants are shared by the batch.  The trial is one more
// grid dimension of the same pass kernels (blockIdx.y), with its own partial
// rows, and the one-block epilogue becomes one epilogue block per trial
// (blockIdx.x), each running the closed form against that trial's m_inv, s
// and eta.  A trial therefore sums the same N blocks in the same order as the
// single-trial launch: slice b of a batched launch equals the single-trial
// launch on trial b bit for bit, and a rejected trial keeps its m_inv and s
// bitwise while its neighbours commit.  Bound: B times the one read of R.
//
// All cross-block sums are two-pass in a fixed order (no atomics): the
// accept/reject and first-improving-step decisions must not flicker between
// runs.  The rank-2 update forms each outer-product entry with
// non-contracted multiplies so that m_inv stays exactly symmetric.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCommitBn = 1024;
constexpr int kCommitThreads = 256;
constexpr int kFinishThreads = 512;

// ---------------------------------------------------------------- probe pass
// blockDim.x = bn (a multiple of 32); dynamic shared memory holds the
// (d, bn) tile, cross for the bn columns, s, and reduction scratch.
__global__ void probe_pass_kernel(const float* __restrict__ r,
                                  const float* __restrict__ s,
                                  float* __restrict__ cross,
                                  float* __restrict__ part_p,
                                  float* __restrict__ part_gg, int d, int n) {
  extern __shared__ float smem[];
  const int bn = blockDim.x;
  // blockIdx.y is the trial: its own R, s, cross and partial rows
  r += (size_t)blockIdx.y * d * n;
  s += (size_t)blockIdx.y * d;
  cross += (size_t)blockIdx.y * n;
  part_p += (size_t)blockIdx.y * gridDim.x * d;
  part_gg += (size_t)blockIdx.y * gridDim.x;
  float* tile = smem;              // d * bn
  float* cs = tile + (size_t)d * bn;  // bn
  float* ss = cs + bn;             // d
  float* red = ss + d;             // 33
  const int t = threadIdx.x;
  for (int k = t; k < d; k += bn) ss[k] = s[k];
  __syncthreads();

  const int col = blockIdx.x * bn + t;
  const bool valid = col < n;
  float c = 0.f;
#pragma unroll 4
  for (int row = 0; row < d; ++row) {
    const float x = valid ? r[(size_t)row * n + col] : 0.f;
    tile[(size_t)row * bn + t] = x;
    c = fmaf(ss[row], x, c);
  }
  cs[t] = c;
  if (valid) cross[col] = c;
  const float gg = repro::block_sum(c * c, red);  // also orders cs/tile writes
  if (t == 0) part_gg[blockIdx.x] = gg;

  const int warp = t >> 5, lane = t & 31, nw = bn >> 5;
  for (int row = warp; row < d; row += nw) {
    const float* tr = tile + (size_t)row * bn;
    float acc = 0.f;
    for (int q = lane; q < bn; q += 32) acc = fmaf(tr[q], cs[q], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) part_p[(size_t)blockIdx.x * d + row] = acc;
  }
}

// One block of kFinishThreads per trial (blockIdx.x).  Dynamic shared
// memory: p (d), q (d), red (33).
__global__ void __launch_bounds__(kFinishThreads)
probe_finish_kernel(const float* __restrict__ part_p,
                    const float* __restrict__ part_gg, int nb,
                    const float* __restrict__ minv,
                    const float* __restrict__ s,
                    const float* __restrict__ eta_p,
                    const float* __restrict__ steps, int k_steps, int d,
                    int i, float m, float* __restrict__ etas,
                    float* __restrict__ p_out, float* __restrict__ gnorm_out) {
  extern __shared__ float smem[];
  const size_t b_ = blockIdx.x;                             // the trial
  part_p += b_ * nb * d;
  part_gg += b_ * nb;
  minv += b_ * d * d;
  s += b_ * d;
  eta_p += b_;
  etas += b_ * k_steps;
  p_out += b_ * d;
  gnorm_out += b_;
  float* p = smem;
  float* q = p + d;
  float* red = q + d;
  const int t = threadIdx.x, warp = t >> 5, nw = kFinishThreads >> 5;

  repro::reduce_partials(part_p, nb, d, 1.f, p, warp, nw);  // R cross
  float g = 0.f;
  for (int b = t; b < nb; b += kFinishThreads) g += part_gg[b];
  const float gg_cross = repro::block_sum(g, red);          // syncs p too

  const float s_i = s[i];
  const float scale = 2.0f * s_i / m;
  const float gnorm = sqrtf(gg_cross) * fabsf(scale) + 1e-30f;
  const float coef = scale / (m * gnorm);
  for (int k = t; k < d; k += kFinishThreads) {
    p[k] = coef * p[k];                                     // R g_unit / m
    p_out[k] = p[k];
  }
  __syncthreads();
  const int lane = t & 31;
  for (int row = warp; row < d; row += nw) {                // q = m_inv p
    const float* mr = minv + (size_t)row * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(mr[c], p[c], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) q[row] = acc;
  }
  float pa = 0.f, pe = 0.f;
  __syncthreads();
  for (int k = t; k < d; k += kFinishThreads) {
    pa = fmaf(p[k], q[k], pa);
    pe = fmaf(p[k], s[k], pe);
  }
  const float a = repro::block_sum(pa, red);                // <p, q>
  const float e = repro::block_sum(pe, red);                // <p, s>
  const float b = q[i];
  const float c = minv[(size_t)i * d + i];
  const float t1 = s_i;
  const float ratio = scale / gnorm;
  const float gg = ratio * ratio * gg_cross;                // <g_unit, g_unit>
  const float c2h = gg / (2.0f * m);
  const float eta = eta_p[0];
  for (int k = t; k < k_steps; k += kFinishThreads) {
    const float st = steps[k];
    const float beta = c2h * st * st;                       // alpha = 1: c1h = 0
    const float k12 = 1.0f - st * b + beta * c;
    const float k22 = st * st * a - 2.0f * st * beta * b + beta * beta * c;
    const float t2 = -st * e + beta * t1;
    const float det = c * k22 - k12 * k12;
    etas[k] = eta - (k22 * t1 * t1 - 2.0f * k12 * t1 * t2 + c * t2 * t2) / det;
  }
  if (t == 0) gnorm_out[0] = gnorm;
}

// --------------------------------------------------------------- commit pass
__global__ void __launch_bounds__(kCommitThreads)
commit_pass_kernel(const float* __restrict__ r,
                   const float* __restrict__ delta,
                   float* __restrict__ part_w, float* __restrict__ part_dd,
                   int d, int n) {
  // blockIdx.y is the trial: its own R, delta and partial rows
  r += (size_t)blockIdx.y * d * n;
  delta += (size_t)blockIdx.y * n;
  part_w += (size_t)blockIdx.y * gridDim.x * d;
  part_dd += (size_t)blockIdx.y * gridDim.x;
  __shared__ float ds[kCommitBn];
  __shared__ float red[33];
  const int n0 = blockIdx.x * kCommitBn;
  const int cols = min(kCommitBn, n - n0);
  float dd = 0.f;
  for (int t = threadIdx.x; t < kCommitBn; t += kCommitThreads) {
    const float x = t < cols ? delta[n0 + t] : 0.f;
    ds[t] = x;
    dd = fmaf(x, x, dd);
  }
  dd = repro::block_sum(dd, red);                           // syncs ds too
  if (threadIdx.x == 0) part_dd[blockIdx.x] = dd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < d; row += kCommitThreads / 32) {
    const float* rr = r + (size_t)row * n + n0;
    float acc = 0.f;
#pragma unroll 8
    for (int c = lane; c < cols; c += 32) acc = fmaf(rr[c], ds[c], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) part_w[(size_t)blockIdx.x * d + row] = acc;
  }
}

// One block of kFinishThreads per trial (blockIdx.x).  Dynamic shared
// memory: u (d), z2 (d), red (33).
__global__ void __launch_bounds__(kFinishThreads)
commit_finish_kernel(const float* __restrict__ part_w,
                     const float* __restrict__ part_dd, int nb,
                     const float* __restrict__ minv,
                     const float* __restrict__ s,
                     const float* __restrict__ eta_p,
                     const float* __restrict__ threshold_p,
                     const float* __restrict__ can_tx_p, int d, int i,
                     float m, float diag_keep, float diag_add,
                     float* __restrict__ minv_out, float* __restrict__ s_out,
                     float* __restrict__ u_out, float* __restrict__ stats) {
  extern __shared__ float smem[];
  const size_t b_ = blockIdx.x;                             // the trial
  part_w += b_ * nb * d;
  part_dd += b_ * nb;
  minv += b_ * d * d;
  s += b_ * d;
  eta_p += b_;
  threshold_p += b_;
  can_tx_p += b_;
  minv_out += b_ * d * d;
  s_out += b_ * d;
  u_out += b_ * d;
  stats += 2 * b_;
  float* u = smem;
  float* z2 = u + d;
  float* red = z2 + d;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int nw = kFinishThreads >> 5;

  repro::reduce_partials(part_w, nb, d, m, u, warp, nw);    // w = R delta / m
  float g = 0.f;
  for (int b = t; b < nb; b += kFinishThreads) g += part_dd[b];
  const float dd_auto = repro::block_sum(g, red) / (2.0f * m);  // syncs u
  if (t == 0) u[i] = diag_keep * (u[i] + dd_auto) + diag_add;
  __syncthreads();

  for (int row = warp; row < d; row += nw) {                // z2 = m_inv u
    const float* mr = minv + (size_t)row * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(mr[c], u[c], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) z2[row] = acc;
  }
  __syncthreads();
  float p22 = 0.f, pt2 = 0.f;
  for (int k = t; k < d; k += kFinishThreads) {
    p22 = fmaf(u[k], z2[k], p22);
    pt2 = fmaf(u[k], s[k], pt2);
  }
  const float k22 = repro::block_sum(p22, red);
  const float t2 = repro::block_sum(pt2, red);
  const float* z1 = minv + (size_t)i * d;                   // m_inv e_i (symmetric)
  const float k11 = z1[i];
  const float k12 = 1.0f + z2[i];
  const float det = k11 * k22 - k12 * k12;
  const float t1 = s[i];
  const float obj_post =
      eta_p[0] - (k22 * t1 * t1 - 2.0f * k12 * t1 * t2 + k11 * t2 * t2) / det;
  const bool accept = (obj_post > threshold_p[0]) && (can_tx_p[0] > 0.5f);

  if (accept) {
    const float c1 = (k22 * t1 - k12 * t2) / det;
    const float c2 = (k11 * t2 - k12 * t1) / det;
    for (int idx = t; idx < d * d; idx += kFinishThreads) {
      const int ra = idx / d, cb = idx % d;
      // each product formed alone (no FMA contraction), so entry (a, b)
      // and entry (b, a) get the same bits
      const float o11 = __fmul_rn(z1[ra], z1[cb]);
      const float o12 = __fadd_rn(__fmul_rn(z1[ra], z2[cb]),
                                  __fmul_rn(z2[ra], z1[cb]));
      const float o22 = __fmul_rn(z2[ra], z2[cb]);
      const float corr = (k22 * o11 - k12 * o12 + k11 * o22) / det;
      minv_out[idx] = minv[idx] - corr;
    }
    for (int k = t; k < d; k += kFinishThreads) {
      s_out[k] = s[k] - c1 * z1[k] - c2 * z2[k];
      u_out[k] = u[k];
    }
  } else {
    for (int idx = t; idx < d * d; idx += kFinishThreads) minv_out[idx] = minv[idx];
    for (int k = t; k < d; k += kFinishThreads) {
      s_out[k] = s[k];
      u_out[k] = 0.f;
    }
  }
  if (t == 0) {
    stats[0] = obj_post;
    stats[1] = accept ? 1.f : 0.f;
  }
}

int launch_probe(const float* r, const float* minv, const float* s,
                 const float* eta, const float* steps, float* cross,
                 float* part_p, float* part_gg, float* etas, float* p,
                 float* gnorm, int d, int n, int bn, int k_steps, int i,
                 int batch, cudaStream_t st) {
  const int nb = (n + bn - 1) / bn;
  const size_t smem = ((size_t)d * bn + bn + d + 33) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  probe_pass_kernel<<<dim3(nb, batch), bn, smem, st>>>(r, s, cross, part_p,
                                                       part_gg, d, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = ((size_t)2 * d + 33) * sizeof(float);
  probe_finish_kernel<<<batch, kFinishThreads, smem2, st>>>(
      part_p, part_gg, nb, minv, s, eta, steps, k_steps, d, i, (float)n, etas,
      p, gnorm);
  return cudaGetLastError();
}

int launch_commit(const float* r, const float* delta, const float* minv,
                  const float* s, const float* eta, const float* threshold,
                  const float* can_tx, float* part_w, float* part_dd,
                  float* minv_out, float* s_out, float* u_out, float* stats,
                  int d, int n, int i, float diag_keep, float diag_add,
                  int batch, cudaStream_t st) {
  const int nb = (n + kCommitBn - 1) / kCommitBn;
  commit_pass_kernel<<<dim3(nb, batch), kCommitThreads, 0, st>>>(
      r, delta, part_w, part_dd, d, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = ((size_t)2 * d + 33) * sizeof(float);
  commit_finish_kernel<<<batch, kFinishThreads, smem2, st>>>(
      part_w, part_dd, nb, minv, s, eta, threshold, can_tx, d, i, (float)n,
      diag_keep, diag_add, minv_out, s_out, u_out, stats);
  return cudaGetLastError();
}

}  // namespace

// r (d, n), s (d,), m_inv (d, d), steps (k_steps,), eta (1,) fp32.
// Scratch: part_p (nb, d), part_gg (nb,) with nb = ceil(n / bn).
// Outputs: cross (n,), etas (k_steps,), p (d,), gnorm (1,).
extern "C" int repro_probe_sweep(const float* r, const float* minv,
                                 const float* s, const float* eta,
                                 const float* steps, float* cross,
                                 float* part_p, float* part_gg, float* etas,
                                 float* p, float* gnorm, int d, int n, int bn,
                                 int k_steps, int i, void* stream) {
  return launch_probe(r, minv, s, eta, steps, cross, part_p, part_gg, etas, p,
                      gnorm, d, n, bn, k_steps, i, 1,
                      static_cast<cudaStream_t>(stream));
}

// Every operand of repro_probe_sweep with a leading trial axis of `batch`
// (r (batch, d, n), m_inv (batch, d, d), s (batch, d), eta (batch,), scratch
// (batch, nb, d) and (batch, nb), outputs (batch, ...)), except steps
// (k_steps,), which every trial shares.  bn is the single-trial launch's.
extern "C" int repro_probe_sweep_batched(
    const float* r, const float* minv, const float* s, const float* eta,
    const float* steps, float* cross, float* part_p, float* part_gg,
    float* etas, float* p, float* gnorm, int d, int n, int bn, int k_steps,
    int i, int batch, void* stream) {
  return launch_probe(r, minv, s, eta, steps, cross, part_p, part_gg, etas, p,
                      gnorm, d, n, bn, k_steps, i, batch,
                      static_cast<cudaStream_t>(stream));
}

// r (d, n), delta (n,), m_inv (d, d), s (d,); eta, threshold, can_tx (1,)
// device scalars.  Scratch: part_w (nb, d), part_dd (nb,), nb = ceil(n/1024).
// Outputs: m_inv' (d, d), s' (d,), u_eff (d,), stats (2,) = (obj_post, accept).
extern "C" int repro_commit_sweep(const float* r, const float* delta,
                                  const float* minv, const float* s,
                                  const float* eta, const float* threshold,
                                  const float* can_tx, float* part_w,
                                  float* part_dd, float* minv_out,
                                  float* s_out, float* u_out, float* stats,
                                  int d, int n, int i, float diag_keep,
                                  float diag_add, void* stream) {
  return launch_commit(r, delta, minv, s, eta, threshold, can_tx, part_w,
                       part_dd, minv_out, s_out, u_out, stats, d, n, i,
                       diag_keep, diag_add, 1, static_cast<cudaStream_t>(stream));
}

// Every operand of repro_commit_sweep with a leading trial axis of `batch`:
// delta (batch, n); eta, threshold, can_tx (batch,); stats (batch, 2).
// diag_keep and diag_add are shared by the batch.
extern "C" int repro_commit_sweep_batched(
    const float* r, const float* delta, const float* minv, const float* s,
    const float* eta, const float* threshold, const float* can_tx,
    float* part_w, float* part_dd, float* minv_out, float* s_out,
    float* u_out, float* stats, int d, int n, int i, float diag_keep,
    float diag_add, int batch, void* stream) {
  return launch_commit(r, delta, minv, s, eta, threshold, can_tx, part_w,
                       part_dd, minv_out, s_out, u_out, stats, d, n, i,
                       diag_keep, diag_add, batch,
                       static_cast<cudaStream_t>(stream));
}
