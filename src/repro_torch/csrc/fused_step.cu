// Fused column step (static, guard off): replaces
// repro/kernels/fused_step.py::fused_step without its STDP-trace and
// guard-flag epilogues.
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
#include "kernels.cuh"

namespace {

__global__ void fused_step_kernel(
    const float* __restrict__ s_loc, const float* __restrict__ w,
    const float* __restrict__ tbl, const int* __restrict__ idx,
    const float* __restrict__ rem_w, const float* __restrict__ ext,
    const float* __restrict__ v, const float* __restrict__ c,
    const int* __restrict__ refrac, float* __restrict__ v_out,
    float* __restrict__ c_out, int* __restrict__ r_out,
    float* __restrict__ s_out, int n, int n_tblk, int t_len, int k,
    repro::LifParams p, unsigned long long* silent_count) {
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

  if (t < n) {
    const size_t i = (size_t)col * n + t;
    const float cur = __fadd_rn(__fadd_rn(local, rem_sh[threadIdx.x]), ext[i]);
    repro::lif_update(p, v[i], c[i], refrac[i], cur, v_out + i, c_out + i,
                      r_out + i, s_out + i);
  }
  // every target block of a column sees the same source blocks: count once
  if (silent_count != nullptr && tblk == 0 && threadIdx.x == 0 &&
      silent > 0) {
    atomicAdd(silent_count, (unsigned long long)silent);
  }
}

}  // namespace

extern "C" int repro_fused_step(
    const float* s_loc, const float* w, const float* tbl, const int* idx,
    const float* rem_w, const float* ext, const float* v, const float* c,
    const int* refrac, float* v_out, float* c_out, int* r_out, float* s_out,
    int n_cols, int n, int t_len, int k, float decay_v, float decay_c,
    float gain, float g_c, float alpha_c, float v_rest, float v_reset,
    float v_thr, int arp, unsigned long long* silent_count,
    cudaStream_t stream) {
  if (n_cols <= 0 || n <= 0) return 0;
  const int n_tblk = (n + repro::BLK - 1) / repro::BLK;
  fused_step_kernel<<<(unsigned)n_cols * n_tblk, repro::BLK, 0, stream>>>(
      s_loc, w, tbl, idx, rem_w, ext, v, c, refrac, v_out, c_out, r_out,
      s_out, n, n_tblk, t_len, k,
      repro::lif_params(decay_v, decay_c, gain, g_c, alpha_c, v_rest,
                        v_reset, v_thr, arp),
      silent_count);
  return (int)cudaGetLastError();
}
