// LIF+SFA neuron update: replaces repro/kernels/lif_step.py::lif_step.
//
// Bound on the card: bytes. Per neuron it reads v, c, refrac, cur and
// writes v', c', refrac', spikes: 32 bytes and ~10 flops, far below the
// H100's ~20 flops per byte of device memory. The design is the simplest
// that streams at the memory rate: one thread per neuron, each access
// coalesced, no shared memory. The grid covers every neuron in one pass;
// the loop strides only past the grid's x limit of 2^31 - 1 blocks.
#include "kernels.cuh"

namespace {

__global__ void lif_step_kernel(const float* __restrict__ v,
                                const float* __restrict__ c,
                                const int* __restrict__ refrac,
                                const float* __restrict__ cur,
                                float* __restrict__ v_out,
                                float* __restrict__ c_out,
                                int* __restrict__ r_out,
                                float* __restrict__ s_out, long long n,
                                repro::LifParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    repro::lif_update(p, v[i], c[i], refrac[i], cur[i], v_out + i, c_out + i,
                      r_out + i, s_out + i);
  }
}

}  // namespace

extern "C" int repro_lif_step(const float* v, const float* c,
                              const int* refrac, const float* cur,
                              float* v_out, float* c_out, int* r_out,
                              float* s_out, long long n, float decay_v,
                              float decay_c, float gain, float g_c,
                              float alpha_c, float v_rest, float v_reset,
                              float v_thr, int arp, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  lif_step_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      v, c, refrac, cur, v_out, c_out, r_out, s_out, n,
      repro::lif_params(decay_v, decay_c, gain, g_c, alpha_c, v_rest,
                        v_reset, v_thr, arp));
  return (int)cudaGetLastError();
}
