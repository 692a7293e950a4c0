// Fused column step: replaces repro/kernels/fused_step.py::fused_step,
// with its STDP-trace and guard-flag epilogues.
//
// Per target neuron: block-skipped local product -> + ELL gather -> +
// external drive -> LIF+SFA, in the order of the reference step
// ((local + remote) + ext), with the membrane state, adaptation and
// currents never leaving the chip between the stages.
//
// Bound on the card: bytes, the sum of the parts: the weight rows the
// spikes need (3.54 GB per step on a 24x24 grid if none were skipped), the
// ELL idx+weights (1.42 GB), the state in and out. One CTA per (column,
// 128-target block); thread i of a CTA owns target t0 + i. It accumulates
// the local product in a register (synapse_matmul's skip: silent
// 128-source blocks and silent sources are never read), then the CTA's
// four warps take its 128 ELL rows one warp per row (coalesced idx/weight
// reads, table gathered through L2) into shared memory, and each thread
// finishes its neuron. Nothing of the ELL layout is held resident: the TPU
// kernel's 4 MB VMEM column tiling does not carry over.
//
// Launch order: the target blocks of one column are neighbours in the 1-D
// grid, so the CTAs in flight at any time cover a few hundred columns and
// their table rows (~99 KB each on the paper's stencil) stay in L2. With
// the column index fastest, every column's row is in flight at once, the
// 57 MB table no longer fits the 50 MB L2, and each 4-byte gather costs a
// 32-byte sector from device memory.
//
// Epilogues, as template instances so that the static variant's code is
// what it was without them:
// - STDP: x_pre' = fma(x_pre, dp, s), x_post' = fma(x_post, dm, s), the
//   trace decay and bump of core/plasticity.py in XLA's grouping (two
//   more (C, N) reads and writes);
// - GUARD: per column, bit 0 where a valid v' is non-finite and bit 1
//   where one lies outside [v_floor, v_ceil] (no --use_fast_math, so
//   isfinite holds), by a warp ballot and one atomicOr per warp into
//   flags[col], which the caller zeroes.
#include "kernels.cuh"

namespace {

struct StdpEpilogue {
  const float* x_pre;
  const float* x_post;
  float* x_pre_out;
  float* x_post_out;
  float dp, dm;
};

struct GuardEpilogue {
  int* flags;
  float v_floor, v_ceil;
};

template <bool STDP, bool GUARD>
__global__ void fused_step_kernel(
    const float* __restrict__ s_loc, const float* __restrict__ w,
    const float* __restrict__ tbl, const int* __restrict__ idx,
    const float* __restrict__ rem_w, const float* __restrict__ ext,
    const float* __restrict__ v, const float* __restrict__ c,
    const int* __restrict__ refrac, float* __restrict__ v_out,
    float* __restrict__ c_out, int* __restrict__ r_out,
    float* __restrict__ s_out, int n, int n_tblk, int t_len, int k,
    repro::LifParams p, unsigned long long* silent_count, StdpEpilogue st,
    GuardEpilogue gd) {
  __shared__ repro::LocalShared sh;
  __shared__ float rem_sh[repro::BLK];
  const int col = blockIdx.x / n_tblk;
  const int tblk = blockIdx.x % n_tblk;
  const int t0 = tblk * repro::BLK;
  const int t = t0 + threadIdx.x;

  int silent = 0;
  const float local = repro::local_delivery(
      s_loc + (size_t)col * n, w + (size_t)col * n * n, n, t, sh, &silent);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* tbl_c = tbl + (size_t)col * t_len;
  for (int r = warp; r < repro::BLK && t0 + r < n; r += repro::BLK / 32) {
    const size_t row = (size_t)col * n + t0 + r;
    const float sum =
        repro::ell_row(tbl_c, t_len, idx + row * k, rem_w + row * k, k, lane);
    if (lane == 0) rem_sh[r] = sum;
  }
  __syncthreads();

  bool bad_nan = false, bad_rng = false;
  if (t < n) {
    const size_t i = (size_t)col * n + t;
    const float cur = __fadd_rn(__fadd_rn(local, rem_sh[threadIdx.x]), ext[i]);
    const repro::LifOut o =
        repro::lif_update(p, v[i], c[i], refrac[i], cur, v_out + i,
                          c_out + i, r_out + i, s_out + i);
    if constexpr (STDP) {
      st.x_pre_out[i] = __fmaf_rn(st.x_pre[i], st.dp, o.s);
      st.x_post_out[i] = __fmaf_rn(st.x_post[i], st.dm, o.s);
    }
    if constexpr (GUARD) {
      bad_nan = !isfinite(o.v);
      bad_rng = o.v < gd.v_floor || o.v > gd.v_ceil;
    }
  }
  if constexpr (GUARD) {
    const int bits = (__ballot_sync(0xffffffffu, bad_nan) ? 1 : 0) |
                     (__ballot_sync(0xffffffffu, bad_rng) ? 2 : 0);
    if (lane == 0 && bits != 0) atomicOr(gd.flags + col, bits);
  }
  // every target block of a column sees the same source blocks: count once
  if (silent_count != nullptr && tblk == 0 && threadIdx.x == 0 &&
      silent > 0) {
    atomicAdd(silent_count, (unsigned long long)silent);
  }
}

}  // namespace

// x_pre == NULL selects the variant without the STDP epilogue, flags ==
// NULL the one without the guard epilogue.
extern "C" int repro_fused_step(
    const float* s_loc, const float* w, const float* tbl, const int* idx,
    const float* rem_w, const float* ext, const float* v, const float* c,
    const int* refrac, float* v_out, float* c_out, int* r_out, float* s_out,
    int n_cols, int n, int t_len, int k, float decay_v, float decay_c,
    float gain, float g_c, float alpha_c, float v_rest, float v_reset,
    float v_thr, int arp, unsigned long long* silent_count,
    const float* x_pre, const float* x_post, float* x_pre_out,
    float* x_post_out, float dp, float dm, int* flags, float v_floor,
    float v_ceil, cudaStream_t stream) {
  if (n_cols <= 0 || n <= 0) return 0;
  const int n_tblk = (n + repro::BLK - 1) / repro::BLK;
  const bool stdp = x_pre != nullptr, guard = flags != nullptr;
  const auto kernel =
      stdp ? (guard ? &fused_step_kernel<true, true>
                    : &fused_step_kernel<true, false>)
           : (guard ? &fused_step_kernel<false, true>
                    : &fused_step_kernel<false, false>);
  kernel<<<(unsigned)n_cols * n_tblk, repro::BLK, 0, stream>>>(
      s_loc, w, tbl, idx, rem_w, ext, v, c, refrac, v_out, c_out, r_out,
      s_out, n, n_tblk, t_len, k,
      repro::lif_params(decay_v, decay_c, gain, g_c, alpha_c, v_rest,
                        v_reset, v_thr, arp),
      silent_count, StdpEpilogue{x_pre, x_post, x_pre_out, x_post_out, dp, dm},
      GuardEpilogue{flags, v_floor, v_ceil});
  return (int)cudaGetLastError();
}
