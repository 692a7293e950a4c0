// LIF+SFA neuron update: replaces repro/kernels/lif_step.py::lif_step.
//
// Bound on the card: bytes. Per neuron it reads v, c, refrac, cur and
// writes v', c', refrac', spikes: 32 bytes and ~10 flops, far below the
// H100's ~20 flops per byte of device memory (22.9 MB per step on a 24x24
// grid of 1240-neuron columns: 0.0068 ms at 3.35 TB/s, close to the time
// of an empty launch).
//
// So the design makes as few, as wide and as early memory requests as it
// can. Each thread takes UNROLL groups of four neurons as 16-byte vectors
// (float4 for v, c, cur and the three float outputs, int4 for refrac),
// loads all 4 * UNROLL vectors before the first use, streams them past L1
// (__ldcs, read once) and writes evict-first (__stcs). One pass of the
// grid covers every neuron: at GRID_24 349 CTAs of 128 threads, one wave
// on 132 SMs. The vector path needs n % 4 == 0 and all eight arrays
// 16-byte aligned; otherwise the same loop runs over single neurons (the
// C entry chooses from the shapes and pointers, never on failure). The arithmetic is
// repro::lif_update's, so both paths equal the plain version to the bit.
#include <type_traits>

#include "kernels.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;   // vectors (or single neurons) a thread

__device__ __forceinline__ void update(const repro::LifParams& p, float v,
                                       float c, int r, float cur, float& vo,
                                       float& co, int& ro, float& so) {
  repro::lif_update(p, v, c, r, cur, &vo, &co, &ro, &so);
}

__device__ __forceinline__ void update(const repro::LifParams& p, float4 v,
                                       float4 c, int4 r, float4 cur,
                                       float4& vo, float4& co, int4& ro,
                                       float4& so) {
  update(p, v.x, c.x, r.x, cur.x, vo.x, co.x, ro.x, so.x);
  update(p, v.y, c.y, r.y, cur.y, vo.y, co.y, ro.y, so.y);
  update(p, v.z, c.z, r.z, cur.z, vo.z, co.z, ro.z, so.z);
  update(p, v.w, c.w, r.w, cur.w, vo.w, co.w, ro.w, so.w);
}

// items: groups of four neurons (VEC) or neurons. A CTA takes THREADS *
// UNROLL consecutive items, thread i the items i, i + THREADS, ...; the
// loop strides on only past the grid's x limit of 2^31 - 1 blocks.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) lif_step_kernel(
    const float* __restrict__ v, const float* __restrict__ c,
    const int* __restrict__ refrac, const float* __restrict__ cur,
    float* __restrict__ v_out, float* __restrict__ c_out,
    int* __restrict__ r_out, float* __restrict__ s_out, long long items,
    repro::LifParams p) {
  using F = std::conditional_t<VEC, float4, float>;
  using I = std::conditional_t<VEC, int4, int>;
  const F* v_in = reinterpret_cast<const F*>(v);
  const F* c_in = reinterpret_cast<const F*>(c);
  const I* r_in = reinterpret_cast<const I*>(refrac);
  const F* cur_in = reinterpret_cast<const F*>(cur);
  const long long tile = (long long)THREADS * UNROLL;
  const long long stride = (long long)gridDim.x * tile;
  for (long long base = (long long)blockIdx.x * tile + threadIdx.x;
       base < items; base += stride) {
    F vv[UNROLL], cv[UNROLL], uv[UNROLL];
    I rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < items) {
        vv[u] = __ldcs(v_in + i);
        cv[u] = __ldcs(c_in + i);
        rv[u] = __ldcs(r_in + i);
        uv[u] = __ldcs(cur_in + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < items) {
        F vo, co, so;
        I ro;
        update(p, vv[u], cv[u], rv[u], uv[u], vo, co, ro, so);
        __stcs(reinterpret_cast<F*>(v_out) + i, vo);
        __stcs(reinterpret_cast<F*>(c_out) + i, co);
        __stcs(reinterpret_cast<I*>(r_out) + i, ro);
        __stcs(reinterpret_cast<F*>(s_out) + i, so);
      }
    }
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
  using repro::aligned16;
  const bool vec = n % 4 == 0 && aligned16(v) && aligned16(c) &&
                   aligned16(refrac) && aligned16(cur) && aligned16(v_out) &&
                   aligned16(c_out) && aligned16(r_out) && aligned16(s_out);
  const long long items = vec ? n / 4 : n;
  const long long tile = (long long)THREADS * UNROLL;
  long long blocks = (items + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  const auto kernel = vec ? &lif_step_kernel<true> : &lif_step_kernel<false>;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      v, c, refrac, cur, v_out, c_out, r_out, s_out, items,
      repro::lif_params(decay_v, decay_c, gain, g_c, alpha_c, v_rest,
                        v_reset, v_thr, arp));
  return (int)cudaGetLastError();
}
