// Remote ELL synaptic delivery: replaces
// repro/kernels/ell_gather.py::ell_gather (both its single-block _kernel
// and the table-tiled _kernel_tiled).
//
//   out[c, n] = sum_k tbl[c, idx[c, n, k]] * w[c, n, k]   (float32)
//
// Bound on the card: bytes. The idx and weight rows are read once each
// (8 bytes per synapse: 1.42 GB per step on a 24x24 grid of 1240-neuron
// columns with 248 remote synapses per neuron). The table gathers must
// not cost more: gathered 4 bytes at a time from device memory, each one
// takes a 32-byte L2 sector, four times the idx and weight bytes.
//
// So, like the TPU kernel that pins the row in VMEM, a CTA stages its
// column's table row (99.2 KB on the paper's stencil) in shared memory
// with cp.async and gathers from there. CTAs are persistent, two per SM
// (kernels/plan.py chooses the grid from the shapes): each takes a
// contiguous, equal share of the (column, 256-row block) items, which all
// cost the same, and reloads the row only when its column changes: on a
// 24x24 grid 3 or 4 rows per CTA instead of one per item. One warp per
// output row reads its idx and weights as coalesced 16-byte vectors, two
// rows in flight per warp (repro::ell_rows).
//
// A table too wide for two rows per SM (radius-6 exponential stencils,
// ~720 KB a row) takes the wide instance: the same loop with the table
// read from device memory through L2, one item per CTA.
//
// Tenant axis (the batched service): B tenants' tables, B * C rows, row
// b * C + c gathering through column c's idx (shared by every tenant) and
// through weight row (b * C + c) % w_rows (w_rows = C when the weights
// are shared too). The items go in the order (column, tenant, target
// block), so the B tenants of a column run on neighbouring CTAs and its
// idx and weight rows come from HBM about once and from L2 after that;
// each tenant's table row is still staged on its own. B = 1 is the
// single-tenant launch, item for item.
#include "kernels.cuh"

namespace {

template <bool STAGED>
__global__ void __launch_bounds__(repro::TB, 2)
    ell_gather_kernel(const float* __restrict__ tbl,
                      const int* __restrict__ idx,
                      const float* __restrict__ w, float* __restrict__ out,
                      int n_rows, int tenants, int w_rows, int n, int n_tblk,
                      int t_len, int k, bool vec) {
  extern __shared__ float4 smem4[];
  float* tbl_sh = reinterpret_cast<float*>(smem4);
  // a contiguous, equal share of the items (kernels/plan.py
  // Plan.item_range): every item costs the same here
  const long long items = (long long)n_rows * n_tblk;
  const long long i0 = blockIdx.x * items / gridDim.x;
  const long long i1 = (blockIdx.x + 1) * items / gridDim.x;
  int row_prev = -1;
  for (long long it = i0; it < i1; ++it) {
    const repro::Item item =
        repro::tenant_item((int)it, tenants, n_rows, n_tblk);
    const int row = item.row;
    const int r0 = item.tblk * repro::TB;
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
    const size_t out0 = (size_t)row * n + r0;
    repro::ell_rows(
        repro::TableRow<STAGED>{STAGED ? tbl_sh : tbl_c, t_len},
        idx + ((size_t)item.col * n + r0) * k,
        w + ((size_t)(row % w_rows) * n + r0) * k, min(repro::TB, n - r0), k,
        vec, [&](int r, float sum) { out[out0 + r] = sum; });
  }
}

}  // namespace

// n_rows = tenants * C table rows (C = the idx's columns), w_rows = C or
// n_rows weight rows; staged, ctas, smem_bytes: kernels/plan.py's choice
// for these shapes.
extern "C" int repro_ell_gather(const float* tbl, const int* idx,
                                const float* w, float* out, int n_rows,
                                int tenants, int w_rows, int n, int t_len,
                                int k, int staged, int ctas, int smem_bytes,
                                cudaStream_t stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (ctas <= 0 || tenants <= 0 || n_rows % tenants != 0 || w_rows <= 0 ||
      smem_bytes < repro::ell_gather_smem(staged, t_len)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tblk = (n + repro::TB - 1) / repro::TB;
  const auto kernel =
      staged ? &ell_gather_kernel<true> : &ell_gather_kernel<false>;
  const cudaError_t err = repro::set_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, repro::TB, smem_bytes, stream>>>(
      tbl, idx, w, out, n_rows, tenants, w_rows, n, n_tblk, t_len, k,
      repro::ell_vec(idx, w, k));
  return (int)cudaGetLastError();
}
