// Block-event-driven local synaptic delivery: replaces
// repro/kernels/synapse_matmul.py::synapse_matmul.
//
//   out[c, t] = sum_s spikes[c, s] * w[c, s, t]      (float32 accumulation)
//
// Bound on the card: bytes. It is a batched vector-matrix product (one
// spike vector per column), not a tensor-core shape: every weight read is
// used once, and only the rows of the sources that spiked are needed (on
// a 24x24 grid of 1240-neuron columns, 30.5 MB of the 3.54 GB of weights
// at step 20).
//
// One CTA of TB threads per (column, TB-target block) item, thread i
// owning target t0 + i. The CTA stages its column's spikes with cp.async;
// an all-silent column is done at once (zeros; its 128-source blocks
// counted as silent). Otherwise it lists the column's spiking sources
// once, in ascending order (repro::list_spiking, as fused_step does,
// counting the silent 128-source blocks on the item with target block 0),
// with their spike values beside them, and streams the listed sources'
// row segments w[c, s, t0 : t0 + TB] through a ring of SM_STAGES stages
// of SM_ROWS rows in shared memory: cp.async, 16-byte copies where the
// rows are 16-byte aligned, (SM_STAGES - 1) * SM_ROWS rows in flight
// while a stage is summed, one barrier a stage. A silent block's rows are
// never read.
//
// Each target's sum is one __fmaf_rn chain from 0 over the listed sources
// in ascending order: the order of fused_step's local product, so the two
// give the same bits, and a rerun gives the same bits.
//
// Tenant axis (the batched service): B tenants' spikes, B * C rows, row
// b * C + c reading weight column c (w has C columns, shared by every
// tenant). The CTAs go in the order (column, tenant, target block), so the
// B tenants of a column run on neighbouring CTAs and the weight rows they
// both need come from HBM once and from L2 after that. B = 1 is the
// single-tenant launch, CTA for CTA.
//
// What sets its time (PERF.md): a column's items each stream all of the
// column's listed rows, and one CTA streams rows at a few tens of GB/s
// however deep the ring, so the items of the busiest column (hundreds of
// spiking sources) finish last; the silent majority costs a round trip
// for the spikes per item.
#include "kernels.cuh"

namespace {

constexpr int T = repro::TB;
constexpr int G = repro::SM_ROWS;
constexpr int S = repro::SM_STAGES;

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Starts copying the row segments of list entries [j0, j0 + rows) (the
// item's targets [0, width)) into ring stage dst, row r at dst + r * T, as
// one commit group. vec: 16-byte copies, T / 4 threads to a row and 4
// rows a pass; else thread i copies its own target of every row.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ wt,
                                           const int* list, int j0, int rows,
                                           int n, int width, bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec) {
    constexpr int GPR = T / 4, RPP = T / GPR;
    const int g = threadIdx.x % GPR, r0 = threadIdx.x / GPR;
    if (4 * g < width) {
#pragma unroll
      for (int r = r0; r < G; r += RPP) {
        if (r < rows) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           d + 4u * (r * T + 4 * g)),
                       "l"(wt + (size_t)list[j0 + r] * n + 4 * g)
                       : "memory");
        }
      }
    }
  } else if ((int)threadIdx.x < width) {
    for (int r = 0; r < rows; ++r) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4u * (r * T + threadIdx.x)),
                   "l"(wt + (size_t)list[j0 + r] * n + threadIdx.x)
                   : "memory");
    }
  }
  commit_group();
}

__global__ void __launch_bounds__(T) synapse_matmul_kernel(
    const float* __restrict__ spikes, const float* __restrict__ w,
    float* __restrict__ out, int n_rows, int tenants, int n, int n_tblk,
    bool vec, unsigned long long* silent_count) {
  // [ring (the spikes staged at its start) | list | val | warp counts]
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* ring = reinterpret_cast<float*>(smem);
  float* spk = ring;
  smem += repro::synapse_matmul_ring(n);
  int* list = reinterpret_cast<int*>(smem);
  smem += repro::round16(4 * n);
  float* val = reinterpret_cast<float*>(smem);
  smem += repro::round16(4 * n);
  int* warp_count = reinterpret_cast<int*>(smem);

  const repro::Item item =
      repro::tenant_item((int)blockIdx.x, tenants, n_rows, n_tblk);
  const int tblk = item.tblk;
  const int t0 = tblk * T, width = min(T, n - t0);
  repro::stage_async(spk, spikes + (size_t)item.row * n, n);
  repro::cp_async_wait<0>();
  __syncthreads();
  int silent = 0, total = 0;
  bool any = false;
  for (int i = threadIdx.x; i < n; i += T) any |= spk[i] != 0.0f;
  if (__syncthreads_or(any)) {
    total = repro::list_spiking(spk, n, list, warp_count, tblk == 0,
                                &silent);
    for (int j = threadIdx.x; j < total; j += T) val[j] = spk[list[j]];
    __syncthreads();  // the spikes are read: the ring may be written
  } else if (tblk == 0) {
    silent = (n + repro::BLK - 1) / repro::BLK;
  }

  float acc = 0.0f;
  const int stages = (total + G - 1) / G;
  if (stages > 0) {
    const float* wt = w + (size_t)item.col * n * n + t0;
#pragma unroll
    for (int g = 0; g < S - 1; ++g) {
      if (g < stages) {
        stage_rows(ring + g * G * T, wt, list, g * G, min(G, total - g * G),
                   n, width, vec);
      } else {
        commit_group();
      }
    }
    int slot = 0, slot_in = S - 1;
    for (int g = 0; g < stages; ++g) {
      // stage g has landed (at most S - 2 younger groups pending), and
      // every thread is done with the stage before it, whose slot refills
      repro::cp_async_wait<S - 2>();
      __syncthreads();
      const int ga = g + S - 1;
      if (ga < stages) {
        stage_rows(ring + slot_in * G * T, wt, list, ga * G,
                   min(G, total - ga * G), n, width, vec);
      } else {
        commit_group();
      }
      slot_in = slot_in + 1 == S ? 0 : slot_in + 1;
      const float* src = ring + slot * G * T + threadIdx.x;
      const int j0 = g * G, rows = min(G, total - j0);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r < rows) acc = __fmaf_rn(val[j0 + r], src[r * T], acc);
      }
      slot = slot + 1 == S ? 0 : slot + 1;
    }
  }
  if ((int)threadIdx.x < width) {
    out[(size_t)item.row * n + t0 + threadIdx.x] = acc;
  }
  // every target block of a row sees the same source blocks: count once
  if (silent_count != nullptr && threadIdx.x == 0 && silent > 0) {
    atomicAdd(silent_count, (unsigned long long)silent);
  }
}

}  // namespace

// n_rows = tenants * C spike rows over the C weight columns; smem_bytes
// is kernels/plan.py's choice for these shapes, at least
// repro::synapse_matmul_smem(n), which the card must be able to give one
// CTA (else an error, never a slower path); one CTA per item.
extern "C" int repro_synapse_matmul(const float* spikes, const float* w,
                                    float* out, int n_rows, int tenants,
                                    int n, unsigned long long* silent_count,
                                    int smem_bytes, cudaStream_t stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (tenants <= 0 || n_rows % tenants != 0 ||
      smem_bytes < repro::synapse_matmul_smem(n)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = repro::set_smem(synapse_matmul_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tblk = (n + T - 1) / T;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  synapse_matmul_kernel<<<(unsigned)n_rows * n_tblk, T, smem_bytes,
                          stream>>>(spikes, w, out, n_rows, tenants, n,
                                    n_tblk, vec, silent_count);
  return (int)cudaGetLastError();
}
