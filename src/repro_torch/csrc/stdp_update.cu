// Dense local STDP weight update: replaces
// repro/kernels/stdp_update.py::stdp_dense_update.
//
//   dw = lr * (a_plus * x_pre_exc[c, s] * spikes[c, t]
//              - a_minus * spk_exc[c, s] * x_post[c, t])
//   w' = where(w > 0, clip(w + dw, 0, w_max), w)
//
// Bound on the card: bytes. Every weight is read and written once (the
// clip applies to every weight, so no tile can be left out): 7.09 GB per
// step on a 24x24 grid of 1240-neuron columns, a few flops per 8 bytes.
// The design streams the weights coalesced along targets: one CTA per
// (column, 128-source block, 128-target block) tile, target blocks of a
// source block adjacent in the 1-D grid; 256 threads, thread i owns target
// t0 + i % 128 and every second source row of the tile, unrolled so that
// several row loads are in flight. The tile's source vectors (x_pre_exc,
// spk_exc) are staged in shared memory, its target vectors (spikes,
// x_post) held in registers. A tile whose source and target spike slices
// are both silent skips the products and only applies the clip, as the
// TPU kernel does: there dw is exactly 0, so the result is the same.
//
// Tenant axis (the batched service under STDP): B tenants' own weights,
// (B * C, N, N), need no other indexing. With `active` ((B,) int32 over
// tenants of cols_per_tenant columns, or NULL for all), the tiles of an
// inactive tenant copy its weights through exactly: the batched engine's
// freeze of a finished or quarantined tenant, with no second pass over
// the weights.
//
// The arithmetic is grouped as XLA groups the JAX reference
// (kernels/ref.py::stdp_dense_update_ref emulates the same):
//   w' = fma(lr, fma(a_plus, pot, -(a_minus * dep)), w)
// with the explicit intrinsics below, so that nvcc's own FMA contraction
// cannot regroup it and the kernel equals its plain version to the bit.
#include "kernels.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / repro::BLK;   // source rows per pass

struct StdpParams {
  float a_plus, a_minus, lr, w_max;
};

__global__ void __launch_bounds__(THREADS) stdp_dense_update_kernel(
    const float* __restrict__ w, const float* __restrict__ x_pre_exc,
    const float* __restrict__ spk_exc, const float* __restrict__ spikes,
    const float* __restrict__ x_post, float* __restrict__ out, int n,
    int n_blk, const int* __restrict__ active, int cols_per_tenant,
    StdpParams p) {
  __shared__ float xpre_sh[repro::BLK];
  __shared__ float sspk_sh[repro::BLK];
  const int tblk = blockIdx.x % n_blk;
  const int rest = blockIdx.x / n_blk;
  const int sblk = rest % n_blk;
  const size_t col = rest / n_blk;
  const int s0 = sblk * repro::BLK, t0 = tblk * repro::BLK;
  const int tx = threadIdx.x % repro::BLK, ty = threadIdx.x / repro::BLK;
  const int t = t0 + tx;
  if (active != nullptr && active[col / cols_per_tenant] == 0) {
    if (t >= n) return;
    const int rows = min(repro::BLK, n - s0);
    const size_t base = (col * n + s0) * n + t;
#pragma unroll 8
    for (int r = ty; r < rows; r += ROW_STEP) {
      out[base + (size_t)r * n] = w[base + (size_t)r * n];
    }
    return;
  }

  bool any_active = false;
  if (ty == 0) {
    const int s = s0 + tx;
    float xs = 0.0f, ss = 0.0f;
    if (s < n) {
      xs = x_pre_exc[col * n + s];
      ss = spk_exc[col * n + s];
    }
    xpre_sh[tx] = xs;
    sspk_sh[tx] = ss;
    any_active = ss != 0.0f;
  }
  float ts = 0.0f, xq = 0.0f;
  if (t < n) {
    ts = spikes[col * n + t];
    xq = x_post[col * n + t];
  }
  any_active = any_active || (ty == 0 && ts != 0.0f);
  const bool any_event = __syncthreads_or(any_active);
  if (t >= n) return;  // no barrier below

  const int rows = min(repro::BLK, n - s0);
  const size_t base = (col * n + s0) * n + t;
  const float* wp = w + base;
  float* op = out + base;
  if (any_event) {
#pragma unroll 8
    for (int r = ty; r < rows; r += ROW_STEP) {
      const float wv = wp[(size_t)r * n];
      const float pot = __fmul_rn(xpre_sh[r], ts);
      const float dep = __fmul_rn(sspk_sh[r], xq);
      const float y = __fmaf_rn(p.a_plus, pot, -__fmul_rn(p.a_minus, dep));
      op[(size_t)r * n] =
          repro::clip_positive(wv, __fmaf_rn(p.lr, y, wv), p.w_max);
    }
  } else {
#pragma unroll 8
    for (int r = ty; r < rows; r += ROW_STEP) {
      const float wv = wp[(size_t)r * n];
      op[(size_t)r * n] = repro::clip_positive(wv, wv, p.w_max);
    }
  }
}

}  // namespace

extern "C" int repro_stdp_dense_update(const float* w, const float* x_pre_exc,
                                       const float* spk_exc,
                                       const float* spikes,
                                       const float* x_post, float* out, int c,
                                       int n, const int* active,
                                       int cols_per_tenant, float a_plus,
                                       float a_minus, float lr, float w_max,
                                       cudaStream_t stream) {
  if (c <= 0 || n <= 0) return 0;
  if (active != nullptr && (cols_per_tenant <= 0 || c % cols_per_tenant)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_blk = (n + repro::BLK - 1) / repro::BLK;
  const long long blocks = (long long)c * n_blk * n_blk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stdp_dense_update_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      w, x_pre_exc, spk_exc, spikes, x_post, out, n, (int)n_blk, active,
      cols_per_tenant, StdpParams{a_plus, a_minus, lr, w_max});
  return (int)cudaGetLastError();
}
