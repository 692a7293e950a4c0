// Remote ELL STDP update. No Pallas counterpart: replaces the plain-jnp
// remote rule of repro/core/plasticity.py:115-133 (stdp_update's rem_w
// branch).
//
//   pre  = tbl[c, idx[c, n, k]]          (the neighbour pre-trace table)
//   dw   = lr * (a_plus * pre * spikes[c, n] - a_minus * pre * x_post[c, n]
//                * 0.5)
//   w'   = where(w > 0, clip(w + dw, 0, w_max), w)      (float32)
//
// Bound on the card: bytes. Each synapse's index and weight are read once
// and its new weight written once, 12 bytes (2.13 GB per step on a 24x24
// grid of 1240-neuron columns with 248 remote synapses per neuron), beside
// the table (57.1 MB) and the two (C, N) vectors. The gathers must not
// cost more than that, so the design is ell_gather's (csrc/ell_gather.cu):
// persistent CTAs, two per SM, each taking a contiguous, equal share of
// the (column, 256-row block) items, stage their column's pre-trace row in
// shared memory with cp.async (99.2 KB on the paper's stencil) and reload
// it only when the column changes. One warp per row (neuron): the neuron's
// spike and post-trace terms are warp-uniform, its idx and weights stream
// as 16-byte vectors (two rows of up to 64 vectors per lane in flight)
// cached in L2 only (__ldcg: the evict-first __ldcs that ell_gather uses
// ran slower here on the card, where a third of the traffic is stores),
// and its new weights go out as 16-byte evict-first stores (__stcs). The
// indices are read as the int32 they are. A table too wide for two rows
// per SM takes the wide instance, read through L2, one item per CTA
// (kernels/plan.py chooses from the shapes).
//
// Tenant axis (the batched service under STDP): B tenants' tables,
// spikes, post-traces and new weights, B * C rows, row b * C + c updating
// through column c's idx (shared by every tenant) the weight row
// (b * C + c) % w_rows (each tenant's own when w_rows = B * C). Items go in
// the order (column, tenant, target block), so the tenants of a column
// read its idx rows from HBM about once. With `active` ((B,) int32, or
// NULL for all), an inactive tenant's rows are its weights copied through
// exactly: the batched engine's freeze of a finished or quarantined
// tenant, with no second pass over the weights.
//
// The arithmetic is grouped as XLA groups the reference's jitted step on
// the CPU, and as kernels/ref.py::stdp_remote_update_ref emulates it:
//   w' = clip(fma(lr, spiked ? fma(pre, spk*a_plus, -dep) : -dep, w))
//   with dep = (pre * (x_post * a_minus)) * 0.5,
// written with the explicit intrinsics, so the kernel equals its plain
// version to the bit. Out of place, as the reference.
#include "kernels.cuh"

namespace {

struct RemoteParams {
  float a_plus, a_minus, lr, w_max;
};

// One neuron's terms, the same for each of its synapses.
struct RowTerms {
  float xa, sa;   // x_post * a_minus, spikes * a_plus
  bool spiked;
};

__device__ __forceinline__ RowTerms row_terms(const RemoteParams& p,
                                              float spk, float x_post) {
  return RowTerms{__fmul_rn(x_post, p.a_minus), __fmul_rn(spk, p.a_plus),
                  spk != 0.0f};
}

__device__ __forceinline__ float rule(const RemoteParams& p,
                                      const RowTerms& t, float pre, float w) {
  const float dep = __fmul_rn(__fmul_rn(pre, t.xa), 0.5f);
  const float y = t.spiked ? __fmaf_rn(pre, t.sa, -dep) : -dep;
  return repro::clip_positive(w, __fmaf_rn(y, p.lr, w), p.w_max);
}

// The rule on ELL rows [0, rows) of one item, rows of K entries from (idx,
// w, out, spk, x_post) on; one warp per row, rows r = warp, warp +
// TB_WARPS, ... . vec (K a multiple of 4, idx, w and out 16-byte
// aligned): 16-byte vectors, R rows of up to 32 * H vectors per lane in
// flight, as repro::ell_rows reads them; otherwise 4-byte accesses.
template <bool STAGED>
__device__ __forceinline__ void update_rows(
    repro::TableRow<STAGED> tbl, const int* __restrict__ idx,
    const float* __restrict__ w, float* __restrict__ out,
    const float* __restrict__ spk, const float* __restrict__ x_post,
    int rows, int k, bool vec, const RemoteParams& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (vec) {
    constexpr int R = 2, H = 2;
    const int kq = k >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int r0 = warp; r0 < rows; r0 += R * repro::TB_WARPS) {
      RowTerms terms[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int r = r0 + u * repro::TB_WARPS;
        terms[u] = r < rows ? row_terms(p, spk[r], x_post[r])
                            : RowTerms{0.0f, 0.0f, false};
      }
      for (int g0 = 0; g0 < kq; g0 += 32 * H) {
        int4 iv[R][H];
        float4 wv[R][H];
#pragma unroll
        for (int u = 0; u < R; ++u) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int r = r0 + u * repro::TB_WARPS, g = g0 + h * 32 + lane;
            if (r < rows && g < kq) {
              const size_t off = (size_t)r * kq + g;
              iv[u][h] = __ldcg(idx4 + off);
              wv[u][h] = __ldcg(w4 + off);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int r = r0 + u * repro::TB_WARPS, g = g0 + h * 32 + lane;
            if (r < rows && g < kq) {
              const int4 i = iv[u][h];
              const float4 x = wv[u][h];
              const RowTerms& t = terms[u];
              __stcs(out4 + (size_t)r * kq + g,
                     make_float4(rule(p, t, tbl(i.x), x.x),
                                 rule(p, t, tbl(i.y), x.y),
                                 rule(p, t, tbl(i.z), x.z),
                                 rule(p, t, tbl(i.w), x.w)));
            }
          }
        }
      }
    }
  } else {
    for (int r = warp; r < rows; r += repro::TB_WARPS) {
      const RowTerms t = row_terms(p, spk[r], x_post[r]);
      const size_t row = (size_t)r * k;
#pragma unroll 4
      for (int j = lane; j < k; j += 32) {
        const float pre = tbl(__ldcg(idx + row + j));
        __stcs(out + row + j, rule(p, t, pre, __ldcg(w + row + j)));
      }
    }
  }
}

// An inactive tenant's ELL rows [0, rows) of K weights, copied through.
__device__ __forceinline__ void copy_rows(const float* __restrict__ w,
                                          float* __restrict__ out, int rows,
                                          int k, bool vec) {
  if (vec) {
    const int kq = k >> 2;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int g = threadIdx.x; g < rows * kq; g += repro::TB) {
      __stcs(out4 + g, __ldcg(w4 + g));
    }
  } else {
    for (int j = threadIdx.x; j < rows * k; j += repro::TB) {
      __stcs(out + j, __ldcg(w + j));
    }
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(repro::TB, 2)
    stdp_remote_update_kernel(const float* __restrict__ tbl,
                              const int* __restrict__ idx,
                              const float* __restrict__ w,
                              const float* __restrict__ spikes,
                              const float* __restrict__ x_post,
                              float* __restrict__ out, int n_rows,
                              int tenants, int w_rows,
                              const int* __restrict__ active, int n,
                              int n_tblk, int t_len, int k, bool vec,
                              RemoteParams p) {
  extern __shared__ float4 smem4[];
  float* tbl_sh = reinterpret_cast<float*>(smem4);
  // a contiguous, equal share of the items (kernels/plan.py
  // Plan.item_range), as ell_gather_kernel takes them
  const long long items = (long long)n_rows * n_tblk;
  const long long i0 = blockIdx.x * items / gridDim.x;
  const long long i1 = (blockIdx.x + 1) * items / gridDim.x;
  const int cols = n_rows / tenants;
  int row_prev = -1;
  for (long long it = i0; it < i1; ++it) {
    const repro::Item item =
        repro::tenant_item((int)it, tenants, n_rows, n_tblk);
    const int row = item.row;
    const int r0 = item.tblk * repro::TB;
    const int rows = min(repro::TB, n - r0);
    const float* w0 = w + ((size_t)(row % w_rows) * n + r0) * k;
    float* out0 = out + ((size_t)row * n + r0) * k;
    if (active != nullptr && active[row / cols] == 0) {
      copy_rows(w0, out0, rows, k, vec);
      continue;
    }
    const float* tbl_c = tbl + (size_t)row * t_len;
    if constexpr (STAGED) {
      if (row != row_prev) {
        __syncthreads();  // every warp is done with the previous row
        repro::stage_async(tbl_sh, tbl_c, t_len);
        repro::cp_async_wait<0>();
        __syncthreads();
        row_prev = row;
      }
    }
    const size_t v0 = (size_t)row * n + r0;
    update_rows(repro::TableRow<STAGED>{STAGED ? tbl_sh : tbl_c, t_len},
                idx + ((size_t)item.col * n + r0) * k, w0, out0, spikes + v0,
                x_post + v0, rows, k, vec, p);
  }
}

}  // namespace

// n_rows = tenants * C rows of tbl, spikes, x_post and out (C = the
// idx's columns), w_rows = C or n_rows rows of w; active: (tenants,) int32
// or NULL. staged, ctas, smem_bytes: kernels/plan.py's choice for these
// shapes.
extern "C" int repro_stdp_remote_update(
    const float* tbl, const int* idx, const float* w, const float* spikes,
    const float* x_post, float* out, int n_rows, int tenants, int w_rows,
    const int* active, int n, int t_len, int k, float a_plus, float a_minus,
    float lr, float w_max, int staged, int ctas, int smem_bytes,
    cudaStream_t stream) {
  if (n_rows <= 0 || n <= 0 || k <= 0) return 0;
  if (ctas <= 0 || tenants <= 0 || n_rows % tenants != 0 || w_rows <= 0 ||
      smem_bytes < repro::ell_gather_smem(staged, t_len)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tblk = (n + repro::TB - 1) / repro::TB;
  const auto kernel = staged ? &stdp_remote_update_kernel<true>
                             : &stdp_remote_update_kernel<false>;
  const cudaError_t err = repro::set_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec = repro::ell_vec(idx, w, k) && repro::aligned16(out);
  kernel<<<(unsigned)ctas, repro::TB, smem_bytes, stream>>>(
      tbl, idx, w, spikes, x_post, out, n_rows, tenants, w_rows, active, n,
      n_tblk, t_len, k, vec, RemoteParams{a_plus, a_minus, lr, w_max});
  return (int)cudaGetLastError();
}
