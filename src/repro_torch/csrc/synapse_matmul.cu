// Block-event-driven local synaptic delivery: replaces
// repro/kernels/synapse_matmul.py::synapse_matmul.
//
//   out[c, t] = sum_s spikes[c, s] * w[c, s, t]      (float32 accumulation)
//
// Bound on the card: bytes. It is a batched vector-matrix product (one
// spike vector per column), not a tensor-core shape: every weight read is
// used once. Read densely, the weights of a 24x24 grid of 1240-neuron
// columns are 3.54 GB per step. The design reads only what the spikes
// need: one CTA per (column, 128-target block), one thread per target.
// For each 128-source block the CTA compacts the sources that spiked into
// shared memory; an all-silent block is skipped before its weight tile is
// loaded, and in an active block only the rows of sources that spiked are
// read, each as coalesced 128-float segments, several rows in flight at
// once. All-silent input gives exact zeros.
#include "kernels.cuh"

namespace {

__global__ void synapse_matmul_kernel(const float* __restrict__ spikes,
                                      const float* __restrict__ w,
                                      float* __restrict__ out, int n,
                                      int n_tblk,
                                      unsigned long long* silent_count) {
  __shared__ repro::LocalShared sh;
  const int col = blockIdx.x / n_tblk;
  const int tblk = blockIdx.x % n_tblk;
  const int t = tblk * repro::BLK + threadIdx.x;
  int silent = 0;
  const float acc = repro::local_delivery(
      spikes + (size_t)col * n, w + (size_t)col * n * n, n, t, sh, &silent);
  if (t < n) out[(size_t)col * n + t] = acc;
  // every target block of a column sees the same source blocks: count once
  if (silent_count != nullptr && tblk == 0 && threadIdx.x == 0 &&
      silent > 0) {
    atomicAdd(silent_count, (unsigned long long)silent);
  }
}

}  // namespace

extern "C" int repro_synapse_matmul(const float* spikes, const float* w,
                                    float* out, int c, int n,
                                    unsigned long long* silent_count,
                                    cudaStream_t stream) {
  if (c <= 0 || n <= 0) return 0;
  const int n_tblk = (n + repro::BLK - 1) / repro::BLK;
  synapse_matmul_kernel<<<(unsigned)c * n_tblk, repro::BLK, 0, stream>>>(
      spikes, w, out, n, n_tblk, silent_count);
  return (int)cudaGetLastError();
}
