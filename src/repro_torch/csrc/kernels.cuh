// Device code shared by the port's kernels (lif_step, synapse_matmul,
// ell_gather, fused_step, stdp_update). Float32 throughout; int32
// refractory counters.
//
// Every multiply-add below is written with __fmaf_rn / __fmul_rn /
// __fadd_rn so that nvcc does not choose the grouping: the LIF update
// reproduces the grouping XLA gives the JAX reference's jitted step on
// the CPU, which the plain PyTorch version (kernels/ref.py) emulates too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Width of a target block (threads per CTA) and of a source block of the
// block-event skip (the 128-block of the TPU kernels).
constexpr int BLK = 128;

struct LifParams {
  float decay_v, decay_c, gain, g_c, alpha_c, v_rest, v_reset, v_thr;
  int arp;
};

// What lif_update wrote to v_out and s_out, for the fused epilogues.
struct LifOut {
  float v, s;
};

// One dt of LIF+SFA for one neuron (core/neuron.py lif_sfa_step):
//   drive = cur - g_c*c;  v1 = v_rest + (v - v_rest)*decay_v + drive*gain
//   clamp to v_reset while refractory; spike on v1 >= v_thr;
//   c' = c*decay_c + alpha_c*spike;  refrac' = arp on a spike, else max(r-1, 0)
__device__ __forceinline__ LifOut lif_update(const LifParams& p, float v,
                                             float c, int refrac, float cur,
                                             float* v_out, float* c_out,
                                             int* r_out, float* s_out) {
  const float drive = __fmaf_rn(-p.g_c, c, cur);
  float v1 = __fadd_rn(p.v_rest,
                       __fmaf_rn(__fsub_rn(v, p.v_rest), p.decay_v,
                                 __fmul_rn(drive, p.gain)));
  const bool refractory = refrac > 0;
  if (refractory) v1 = p.v_reset;
  const bool spike = (v1 >= p.v_thr) && !refractory;
  const float s = spike ? 1.0f : 0.0f;
  const float v2 = spike ? p.v_reset : v1;
  *v_out = v2;
  *c_out = __fmaf_rn(c, p.decay_c, __fmul_rn(p.alpha_c, s));
  *r_out = spike ? p.arp : max(refrac - 1, 0);
  *s_out = s;
  return LifOut{v2, s};
}

// Shared memory of local_delivery: one 128-source block's spike values and
// source offsets, compacted to the sources that spiked, and per-warp counts.
struct LocalShared {
  float s[BLK];
  int j[BLK];
  int warp_count[BLK / 32];
};

// Local delivery for target t of one column, run by a whole CTA of BLK
// threads (thread i owns target t0 + i):
//   sum_s spikes_c[s] * w_c[s, t]   (w_c is [src, tgt], row-major, n x n)
// For each 128-source block the CTA compacts the sources that spiked into
// shared memory (ballot + per-warp counts, ascending order kept). A silent
// block is skipped before any of its weight rows is read (counted in
// *silent); in an active block only the rows of sources that spiked are
// read, each as coalesced 128-float segments (neighbouring threads read
// neighbouring t), and the loop over the compacted list is unrolled so
// that several row loads are in flight at once. Sums in float32, sources
// in ascending order.
__device__ __forceinline__ float local_delivery(
    const float* __restrict__ spikes_c, const float* __restrict__ w_c, int n,
    int t, LocalShared& sh, int* silent) {
  float acc = 0.0f;
  const bool valid_t = t < n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s0 = 0; s0 < n; s0 += BLK) {
    const int s = s0 + threadIdx.x;
    const float sv = s < n ? spikes_c[s] : 0.0f;
    const bool active = sv != 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, active);
    __syncthreads();  // every thread is done reading the previous list
    if (lane == 0) sh.warp_count[warp] = __popc(mask);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int i = 0; i < BLK / 32; ++i) {
      const int c = sh.warp_count[i];
      base += i < warp ? c : 0;
      total += c;
    }
    if (active) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      sh.s[pos] = sv;
      sh.j[pos] = threadIdx.x;
    }
    __syncthreads();
    if (total == 0) {
      ++*silent;
      continue;
    }
    if (valid_t) {
      const float* wp = w_c + (size_t)s0 * n + t;
#pragma unroll 8
      for (int i = 0; i < total; ++i) {
        acc = __fmaf_rn(sh.s[i], wp[(size_t)sh.j[i] * n], acc);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One ELL row by one warp: sum_k tbl_c[idx_row[k]] * w_row[k]. Lanes stride
// over k, so the idx and weight reads coalesce; the table is gathered from
// device memory through L2. An index outside [0, t_len) gives NaN (as the
// reference's out-of-bounds gather fills) instead of reading out of
// bounds. Every lane returns the sum.
__device__ __forceinline__ float ell_row(const float* __restrict__ tbl_c,
                                         int t_len,
                                         const int* __restrict__ idx_row,
                                         const float* __restrict__ w_row,
                                         int k, int lane) {
  float acc = 0.0f;
#pragma unroll 4
  for (int j = lane; j < k; j += 32) {
    const int i = idx_row[j];
    const float g = (unsigned)i < (unsigned)t_len ? __ldg(tbl_c + i)
                                                  : __int_as_float(0x7fc00000);
    acc = __fmaf_rn(g, w_row[j], acc);
  }
  return warp_sum(acc);
}

inline LifParams lif_params(float decay_v, float decay_c, float gain,
                            float g_c, float alpha_c, float v_rest,
                            float v_reset, float v_thr, int arp) {
  return LifParams{decay_v, decay_c, gain, g_c, alpha_c,
                   v_rest,  v_reset, v_thr, arp};
}

}  // namespace repro
