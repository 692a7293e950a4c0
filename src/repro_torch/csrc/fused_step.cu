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
// ELL idx+weights (1.42 GB), the state in and out. The ELL half is the
// design of ell_gather.cu: persistent CTAs, two per SM, over the (column,
// 256-target block) items, with the column's table row staged in shared
// memory by cp.async and reloaded only when the column changes, and the
// idx and weights streamed as 16-byte vectors, two rows in flight per
// warp. Gathered from device memory, the table would cost a 32-byte L2
// sector per 4-byte gather.
//
// Unlike ell_gather's, these items do not cost the same: spikes cluster,
// and a column's local product reads one weight row per spiking source
// (chip_smoke.py reports how many, per column and per CTA under equal
// shares: on a 24x24 grid the busiest columns have dozens of times the
// mean). CTAs therefore claim chunks of items in order from a counter
// (guided self-scheduling: about remaining / (2 * CTAs) items a claim,
// down to one), so a CTA that meets a busy column claims fewer, and
// consecutive items of a column still mostly share a CTA and its row.
//
// On a column change the CTA also stages the column's spikes (one commit
// group ahead of the table row) and compacts the sources that spiked into
// a list in shared memory, in ascending order, counting the 128-source
// blocks that are silent once per column (the item with target block 0).
// An item's local product reads only the weight rows of the listed
// sources, coalesced along targets: the first PREFETCH rows are requested
// before the ELL stream and summed after it, the rest eight in flight.
// It is the same sum, in the same order, as synapse_matmul's; a silent
// block's rows are never read.
//
// Thread i of a CTA owns target t0 + i of the item: its state, drive and
// traces are loaded first, so that they arrive under the ELL stream.
//
// Every item's sums are taken in a fixed order whichever CTA takes it, so
// a rerun gives the same bits.
//
// Epilogues, as template instances so that the static variant's code is
// what it is without them:
// - STDP: x_pre' = fma(x_pre, dp, s), x_post' = fma(x_post, dm, s), the
//   trace decay and bump of core/plasticity.py in XLA's grouping (two
//   more (C, N) reads and writes);
// - GUARD: per column, bit 0 where a valid v' is non-finite and bit 1
//   where one lies outside [v_floor, v_ceil] (no --use_fast_math, so
//   isfinite holds), by a warp ballot and one atomicOr per warp into
//   flags[col], which the caller zeroes.
// A table too wide for two CTAs per SM takes the wide instances
// (STAGED = false): the same loop, the table read through L2, one item per
// CTA.
//
// Tenant axis (the batched service): B tenants' rows, n_rows = B * C,
// row b * C + c of tenant b. Every per-neuron input and output, the table
// and the guard flags have a row per (tenant, column); the ELL idx has
// C rows (every tenant's network is the same), and the local weights and
// the ELL weights have w_rows and rw_rows rows, C when the tenants share
// them (static runs) and n_rows when each trains its own (STDP): row r
// reads weight row r % w_rows. B = 1 is the single-tenant launch, item
// for item. B > 1 on a staged table takes the cluster instances
// (CLUSTER, kernels/plan.py path "cluster"): groups of up to 8 tenants as
// thread-block clusters, CTA rank g taking tenant g of its group through
// the same items as its cluster, the same loop (repro::cluster_claim,
// repro::group_item in kernels.cuh), so that the group's CTAs read each
// ELL block and shared weight row within one item of each other and HBM
// serves it once a group. Each (tenant, column) stages its own table row
// and spikes: B rows of 99 KB would not fit one CTA. (Before, the items
// went in the order (column, tenant, target block) on the staged path:
// the first claims, about 21 items, handed a column's 4 tenants x 5
// target blocks to one CTA one after another, each tenant reading the
// column's 2.46 MB of ELL rows from HBM again, evict-first. Wide tables
// still take those items.)
#include "kernels.cuh"

namespace {

// Weight rows of the local product requested before the ELL stream.
constexpr int PREFETCH = 8;

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

template <bool STAGED, bool STDP, bool GUARD, bool CLUSTER>
__global__ void __launch_bounds__(repro::TB, 2) fused_step_kernel(
    const float* __restrict__ s_loc, const float* __restrict__ w,
    const float* __restrict__ tbl, const int* __restrict__ idx,
    const float* __restrict__ rem_w, const float* __restrict__ ext,
    const float* __restrict__ v, const float* __restrict__ c,
    const int* __restrict__ refrac, float* __restrict__ v_out,
    float* __restrict__ c_out, int* __restrict__ r_out,
    float* __restrict__ s_out, int n_rows, int tenants, int w_rows,
    int rw_rows, int n, int n_tblk, int t_len, int k, bool vec,
    repro::LifParams p, unsigned long long* silent_count,
    StdpEpilogue st, GuardEpilogue gd, int* next_item, repro::Groups g) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* tbl_sh = reinterpret_cast<float*>(smem);
  smem += repro::ell_gather_smem(STAGED, t_len);
  float* spk_sh = reinterpret_cast<float*>(smem);
  smem += repro::round16(4 * n);
  int* list_sh = reinterpret_cast<int*>(smem);
  smem += repro::round16(4 * n);
  float* rem_sh = reinterpret_cast<float*>(smem);
  int* warp_count = reinterpret_cast<int*>(rem_sh + 2 * repro::TB);
  int* claim = warp_count + repro::TB_WARPS;

  const int lane = threadIdx.x & 31;
  const int items =
      CLUSTER ? g.n_cols * g.groups * n_tblk : n_rows * n_tblk;
  unsigned rank = 0;
  if constexpr (CLUSTER) rank = repro::cluster_rank();
  int row_prev = -1, n_spiking = 0, silent = 0, n_done = 0;
  for (;;) {
    int c0, c1;
    if constexpr (CLUSTER) {
      const int2 chunk =
          repro::cluster_claim(next_item, items, claim, rank, g.size);
      c0 = chunk.x;
      c1 = chunk.y;
    } else {
      if (threadIdx.x == 0) {
        const int seen = *reinterpret_cast<volatile int*>(next_item);
        const int size = max(1, (items - seen) / (2 * (int)gridDim.x));
        const int start = atomicAdd(next_item, size);
        claim[0] = start;
        claim[1] = min(start + size, items);
      }
      __syncthreads();
      c0 = claim[0];
      c1 = claim[1];
    }
    if (c0 >= items) break;
    // claim is rewritten only after the chunk's own barriers
    for (int it = c0; it < c1; ++it) {
      repro::Item item;
      if constexpr (CLUSTER) {
        // no CTA of the cluster starts this item before every CTA has
        // started the one before
        if (it > c0) repro::cluster_wait();
        repro::cluster_arrive();
        const repro::GroupItem gi = repro::group_item(g, it, rank, n_tblk);
        if (!gi.valid) continue;  // a rank past its group's last tenant
        item = repro::Item{gi.col, gi.row, gi.tblk};
      } else {
        item = repro::tenant_item(it, tenants, n_rows, n_tblk);
      }
      const int row = item.row;
      const int tblk = item.tblk;
      const int t0 = tblk * repro::TB;
      const int t = t0 + threadIdx.x;
      const bool valid = t < n;
      const size_t i = (size_t)row * n + t;
      float v_i = 0.0f, c_i = 0.0f, ext_i = 0.0f;
      float xp_i = 0.0f, xq_i = 0.0f;
      int r_i = 0;
      if (valid) {
        v_i = v[i];
        c_i = c[i];
        r_i = refrac[i];
        ext_i = ext[i];
        if constexpr (STDP) {
          xp_i = st.x_pre[i];
          xq_i = st.x_post[i];
        }
      }
      const float* tbl_c = tbl + (size_t)row * t_len;
      const bool col_changed = row != row_prev;
      if (col_changed) {
        __syncthreads();  // every thread is done with the previous column
        repro::stage_async(spk_sh, s_loc + (size_t)row * n, n);
        if constexpr (STAGED) {
          repro::stage_async(tbl_sh, tbl_c, t_len);
          repro::cp_async_wait<1>();  // the spikes; the row may still fly
        } else {
          repro::cp_async_wait<0>();
        }
        __syncthreads();
        n_spiking = repro::list_spiking(spk_sh, n, list_sh, warp_count,
                                        tblk == 0, &silent);
        row_prev = row;
      }

      // the first PREFETCH weight rows of the local product are requested
      // now and consumed after the ELL stream, which hides their latency
      const float* wp = w + (size_t)(row % w_rows) * n * n + t;
      float pre[PREFETCH];
#pragma unroll
      for (int j = 0; j < PREFETCH; ++j) {
        pre[j] = valid && j < n_spiking ? wp[(size_t)list_sh[j] * n] : 0.0f;
      }

      if (STAGED && col_changed) {
        repro::cp_async_wait<0>();  // the table row
        __syncthreads();
      }
      // the sums of consecutive items alternate buffers, so an item's ELL
      // rows need not wait for the last item's epilogue
      float* rem = rem_sh + (n_done++ & 1) * repro::TB;
      repro::ell_rows<!CLUSTER>(
          repro::TableRow<STAGED>{STAGED ? tbl_sh : tbl_c, t_len},
          idx + ((size_t)item.col * n + t0) * k,
          rem_w + ((size_t)(row % rw_rows) * n + t0) * k,
          min(repro::TB, n - t0), k, vec,
          [&](int r, float sum) { rem[r] = sum; });
      __syncthreads();

      // local product over the listed sources, ascending
      float local = 0.0f;
      if (valid) {
#pragma unroll
        for (int j = 0; j < PREFETCH; ++j) {
          if (j < n_spiking) {
            local = __fmaf_rn(spk_sh[list_sh[j]], pre[j], local);
          }
        }
#pragma unroll 8
        for (int j = PREFETCH; j < n_spiking; ++j) {
          const int s = list_sh[j];
          local = __fmaf_rn(spk_sh[s], wp[(size_t)s * n], local);
        }
      }

      bool bad_nan = false, bad_rng = false;
      if (valid) {
        const float cur =
            __fadd_rn(__fadd_rn(local, rem[threadIdx.x]), ext_i);
        const repro::LifOut o =
            repro::lif_update(p, v_i, c_i, r_i, cur, v_out + i, c_out + i,
                              r_out + i, s_out + i);
        if constexpr (STDP) {
          st.x_pre_out[i] = __fmaf_rn(xp_i, st.dp, o.s);
          st.x_post_out[i] = __fmaf_rn(xq_i, st.dm, o.s);
        }
        if constexpr (GUARD) {
          bad_nan = !isfinite(o.v);
          bad_rng = o.v < gd.v_floor || o.v > gd.v_ceil;
        }
      }
      if constexpr (GUARD) {
        const int bits = (__ballot_sync(0xffffffffu, bad_nan) ? 1 : 0) |
                         (__ballot_sync(0xffffffffu, bad_rng) ? 2 : 0);
        if (lane == 0 && bits != 0) atomicOr(gd.flags + row, bits);
      }
    }
    if constexpr (CLUSTER) {
      if (c1 > c0) repro::cluster_wait();  // the chunk's last arrival
    }
  }
  // each row's source blocks were counted once, by the CTA that took its
  // target block 0 (claims are increasing, so it met the row there)
  if (silent_count != nullptr && threadIdx.x == 0 && silent > 0) {
    atomicAdd(silent_count, (unsigned long long)silent);
  }
}

using FusedKernel = decltype(&fused_step_kernel<true, false, false, false>);

template <bool STAGED, bool CLUSTER>
FusedKernel fused_instance(bool stdp, bool guard) {
  return stdp ? (guard ? &fused_step_kernel<STAGED, true, true, CLUSTER>
                       : &fused_step_kernel<STAGED, true, false, CLUSTER>)
              : (guard ? &fused_step_kernel<STAGED, false, true, CLUSTER>
                       : &fused_step_kernel<STAGED, false, false, CLUSTER>);
}

}  // namespace

// n_rows = tenants * C rows (C = the idx's columns); w_rows and rw_rows,
// the rows of w and rem_w, are C or n_rows. x_pre == NULL selects the
// variant without the STDP epilogue, flags == NULL the one without the
// guard epilogue; path (0 wide, 1 staged, 2 cluster), ctas, smem_bytes,
// and on the cluster path the CTAs of a cluster and the tenant groups,
// are kernels/plan.py's choice for these shapes; next_item is the claim
// counter, one int the caller zeroes. A cluster launch the card refuses
// returns its error: no other instance stands behind it.
extern "C" int repro_fused_step(
    const float* s_loc, const float* w, const float* tbl, const int* idx,
    const float* rem_w, const float* ext, const float* v, const float* c,
    const int* refrac, float* v_out, float* c_out, int* r_out, float* s_out,
    int n_rows, int tenants, int w_rows, int rw_rows, int n, int t_len, int k,
    float decay_v, float decay_c,
    float gain, float g_c, float alpha_c, float v_rest, float v_reset,
    float v_thr, int arp, unsigned long long* silent_count,
    const float* x_pre, const float* x_post, float* x_pre_out,
    float* x_post_out, float dp, float dm, int* flags, float v_floor,
    float v_ceil, int path, int ctas, int smem_bytes, int cluster,
    int groups, int* next_item, cudaStream_t stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (ctas <= 0 || next_item == nullptr || tenants <= 0 ||
      n_rows % tenants != 0 || w_rows <= 0 || rw_rows <= 0 || path < 0 ||
      path > 2 || smem_bytes < repro::fused_step_smem(path != 0, t_len, n)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tblk = (n + repro::TB - 1) / repro::TB;
  const bool stdp = x_pre != nullptr, guard = flags != nullptr;
  const repro::Groups g = repro::make_groups(n_rows, tenants, cluster, groups);
  if (path == 2 && (g.size == 0 || ctas % g.size != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = path == 2   ? fused_instance<true, true>(stdp, guard)
                      : path == 1 ? fused_instance<true, false>(stdp, guard)
                                  : fused_instance<false, false>(stdp, guard);
  const cudaError_t err = repro::set_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const repro::LifParams lif = repro::lif_params(
      decay_v, decay_c, gain, g_c, alpha_c, v_rest, v_reset, v_thr, arp);
  const StdpEpilogue st{x_pre, x_post, x_pre_out, x_post_out, dp, dm};
  const GuardEpilogue gd{flags, v_floor, v_ceil};
  const bool vec = repro::ell_vec(idx, rem_w, k);
  if (path == 2) {
    return (int)repro::launch_cluster(
        kernel, ctas, g.size, smem_bytes, stream, s_loc, w, tbl, idx, rem_w,
        ext, v, c, refrac, v_out, c_out, r_out, s_out, n_rows, tenants,
        w_rows, rw_rows, n, n_tblk, t_len, k, vec, lif, silent_count, st, gd,
        next_item, g);
  }
  kernel<<<(unsigned)ctas, repro::TB, smem_bytes, stream>>>(
      s_loc, w, tbl, idx, rem_w, ext, v, c, refrac, v_out, c_out, r_out,
      s_out, n_rows, tenants, w_rows, rw_rows, n, n_tblk, t_len, k, vec, lif,
      silent_count, st, gd, next_item, g);
  return (int)cudaGetLastError();
}
