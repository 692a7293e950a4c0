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
// are shared too). B = 1 is the single-tenant launch, item for item. B > 1
// on a staged table takes the cluster instance (kernels/plan.py, path
// "cluster"; fused_step.cu's layout): groups of up to 8 tenants as
// thread-block clusters, CTA rank g staging tenant g's table row, the
// cluster's CTAs claiming (column, group, target block) items together
// and walking them within one item of each other, so that HBM serves each
// idx and shared weight row once a group and L2 the group's other CTAs.
// (Before, the items went in the order (column, tenant, target block) in
// equal contiguous shares: a column's tenants fell to one CTA one after
// another, each reading the column's idx and weights from HBM again,
// evict-first. Wide tables still take those items.)
#include "kernels.cuh"

namespace {

// The gather of one (row, target block) item: the row's table staged
// when it changes, its ELL rows summed into out.
template <bool STAGED, bool STREAM>
__device__ __forceinline__ void gather_item(
    const repro::Item& item, const float* __restrict__ tbl,
    const int* __restrict__ idx, const float* __restrict__ w,
    float* __restrict__ out, float* tbl_sh, int w_rows, int n, int t_len,
    int k, bool vec, int& row_prev) {
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
  repro::ell_rows<STREAM>(
      repro::TableRow<STAGED>{STAGED ? tbl_sh : tbl_c, t_len},
      idx + ((size_t)item.col * n + r0) * k,
      w + ((size_t)(row % w_rows) * n + r0) * k, min(repro::TB, n - r0), k,
      vec, [&](int r, float sum) { out[out0 + r] = sum; });
}

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
    gather_item<STAGED, true>(
        repro::tenant_item((int)it, tenants, n_rows, n_tblk), tbl, idx, w,
        out, tbl_sh, w_rows, n, t_len, k, vec, row_prev);
  }
}

// The cluster instance: chunks of group items claimed by the cluster, its
// CTAs within one item of each other (fused_step.cu's cluster loop).
__global__ void __launch_bounds__(repro::TB, 2)
    ell_gather_cluster_kernel(const float* __restrict__ tbl,
                              const int* __restrict__ idx,
                              const float* __restrict__ w,
                              float* __restrict__ out, repro::Groups g,
                              int w_rows, int n, int n_tblk, int t_len, int k,
                              bool vec, int* next_item) {
  extern __shared__ float4 smem4[];
  float* tbl_sh = reinterpret_cast<float*>(smem4);
  int* claim = reinterpret_cast<int*>(smem4) + repro::round16(4 * t_len) / 4;
  const int items = g.n_cols * g.groups * n_tblk;
  const unsigned rank = repro::cluster_rank();
  int row_prev = -1;
  for (;;) {
    const int2 chunk =
        repro::cluster_claim(next_item, items, claim, rank, g.size);
    if (chunk.x >= items) break;
    for (int it = chunk.x; it < chunk.y; ++it) {
      if (it > chunk.x) repro::cluster_wait();
      repro::cluster_arrive();
      const repro::GroupItem gi = repro::group_item(g, it, rank, n_tblk);
      if (gi.valid) {
        gather_item<true, false>(repro::Item{gi.col, gi.row, gi.tblk}, tbl,
                                 idx, w, out, tbl_sh, w_rows, n, t_len, k,
                                 vec, row_prev);
      }
    }
    repro::cluster_wait();  // the chunk's last arrival
  }
}

}  // namespace

// n_rows = tenants * C table rows (C = the idx's columns), w_rows = C or
// n_rows weight rows; path (0 wide, 1 staged, 2 cluster), ctas,
// smem_bytes, and on the cluster path the CTAs of a cluster and the
// tenant groups: kernels/plan.py's choice for these shapes; next_item,
// the cluster path's claim counter (one int the caller zeroes). A cluster
// launch the card refuses returns its error.
extern "C" int repro_ell_gather(const float* tbl, const int* idx,
                                const float* w, float* out, int n_rows,
                                int tenants, int w_rows, int n, int t_len,
                                int k, int path, int ctas, int smem_bytes,
                                int cluster, int groups, int* next_item,
                                cudaStream_t stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (ctas <= 0 || tenants <= 0 || n_rows % tenants != 0 || w_rows <= 0 ||
      path < 0 || path > 2 ||
      smem_bytes < (path == 2 ? repro::ell_gather_cluster_smem(t_len)
                              : repro::ell_gather_smem(path == 1, t_len))) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tblk = (n + repro::TB - 1) / repro::TB;
  const bool vec = repro::ell_vec(idx, w, k);
  if (path == 2) {
    const repro::Groups g =
        repro::make_groups(n_rows, tenants, cluster, groups);
    if (g.size == 0 || ctas % g.size != 0 || next_item == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    const auto kernel = &ell_gather_cluster_kernel;
    const cudaError_t err = repro::set_smem(kernel, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)repro::launch_cluster(kernel, ctas, g.size, smem_bytes,
                                      stream, tbl, idx, w, out, g, w_rows, n,
                                      n_tblk, t_len, k, vec, next_item);
  }
  const auto kernel =
      path == 1 ? &ell_gather_kernel<true> : &ell_gather_kernel<false>;
  const cudaError_t err = repro::set_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, repro::TB, smem_bytes, stream>>>(
      tbl, idx, w, out, n_rows, tenants, w_rows, n, n_tblk, t_len, k, vec);
  return (int)cudaGetLastError();
}
