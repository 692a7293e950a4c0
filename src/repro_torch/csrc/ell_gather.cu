// Remote ELL synaptic delivery: replaces
// repro/kernels/ell_gather.py::ell_gather (both its single-block _kernel
// and the table-tiled _kernel_tiled).
//
//   out[c, n] = sum_k tbl[c, idx[c, n, k]] * w[c, n, k]   (float32)
//
// Bound on the card: bytes. The idx and weight rows are read once each
// (8 bytes per synapse: 1.42 GB per step on a 24x24 grid of 1240-neuron
// columns with 248 remote synapses per neuron); the table reads are
// gathers that mostly hit L2 (one column's row is ~99 KB, the whole table
// ~57 MB). One warp per (c, n) row: lanes stride over k so the idx and
// weight reads coalesce, gather the table straight from device memory, and
// finish with a warp-shuffle reduction. No table row is staged in shared
// memory, so there is no row-length limit and no tiled variant: a table
// wider than the TPU kernel's 131,072-lane block runs the same code.
#include "kernels.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void ell_gather_kernel(const float* __restrict__ tbl,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, long long rows,
                                  int n, int t_len, int k) {
  const long long row =
      (long long)blockIdx.x * WARPS + threadIdx.x / 32;  // (c, n) flattened
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const long long col = row / n;
  const float acc = repro::ell_row(tbl + col * t_len, t_len, idx + row * k,
                                   w + row * k, k, lane);
  if (lane == 0) out[row] = acc;
}

}  // namespace

extern "C" int repro_ell_gather(const float* tbl, const int* idx,
                                const float* w, float* out, int c, int n,
                                int t_len, int k, cudaStream_t stream) {
  const long long rows = (long long)c * n;
  if (rows <= 0) return 0;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  ell_gather_kernel<<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      tbl, idx, w, out, rows, n, t_len, k);
  return (int)cudaGetLastError();
}
