// Device code shared by the port's kernels (lif_step, synapse_matmul,
// ell_gather, fused_step, stdp_update, stdp_remote). Float32 throughout;
// int32 refractory counters and ELL indices.
//
// Every multiply-add below is written with __fmaf_rn / __fmul_rn /
// __fadd_rn so that nvcc does not choose the grouping: the LIF update
// reproduces the grouping XLA gives the JAX reference's jitted step on
// the CPU, which the plain PyTorch version (kernels/ref.py) emulates too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Width of a target block (threads per CTA) and of a source block of the
// block-event skip (the 128-block of the TPU kernels).
constexpr int BLK = 128;

struct LifParams {
  float decay_v, decay_c, gain, g_c, alpha_c, v_rest, v_reset, v_thr;
  int arp;
};

// What lif_update wrote to v_out and s_out, for the fused epilogues.
struct LifOut {
  float v, s;
};

// One dt of LIF+SFA for one neuron (core/neuron.py lif_sfa_step):
//   drive = cur - g_c*c;  v1 = v_rest + (v - v_rest)*decay_v + drive*gain
//   clamp to v_reset while refractory; spike on v1 >= v_thr;
//   c' = c*decay_c + alpha_c*spike;  refrac' = arp on a spike, else max(r-1, 0)
__device__ __forceinline__ LifOut lif_update(const LifParams& p, float v,
                                             float c, int refrac, float cur,
                                             float* v_out, float* c_out,
                                             int* r_out, float* s_out) {
  const float drive = __fmaf_rn(-p.g_c, c, cur);
  float v1 = __fadd_rn(p.v_rest,
                       __fmaf_rn(__fsub_rn(v, p.v_rest), p.decay_v,
                                 __fmul_rn(drive, p.gain)));
  const bool refractory = refrac > 0;
  if (refractory) v1 = p.v_reset;
  const bool spike = (v1 >= p.v_thr) && !refractory;
  const float s = spike ? 1.0f : 0.0f;
  const float v2 = spike ? p.v_reset : v1;
  *v_out = v2;
  *c_out = __fmaf_rn(c, p.decay_c, __fmul_rn(p.alpha_c, s));
  *r_out = spike ? p.arp : max(refrac - 1, 0);
  *s_out = s;
  return LifOut{v2, s};
}

// The STDP weight clip of both plasticity rules (stdp_update, stdp_remote):
// jnp.where(w > 0, jnp.clip(nw, 0, w_max), w), the clip as
// min(max(x, 0), w_max); a NaN passes through, as there.
__device__ __forceinline__ float clip_positive(float w, float nw,
                                              float w_max) {
  if (!(w > 0.0f)) return w;
  return nw < 0.0f ? 0.0f : (nw > w_max ? w_max : nw);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Threads of a CTA of ell_gather, fused_step and synapse_matmul, which is
// also the width of their (column, target block) work items.
// kernels/plan.py (TARGET_BLOCK) mirrors it.
constexpr int TB = 256;
constexpr int TB_WARPS = TB / 32;

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Compacts the sources s < n with spk[s] != 0 into list[0, total) in
// ascending order (ballot, per-warp counts, TB sources a pass); with
// count_silent, adds the silent 128-source blocks to *silent. The whole
// CTA of TB threads calls it. Returns total; the list is visible to the
// whole CTA on return. fused_step and synapse_matmul build their local
// product on it, so both sum a target's terms in this order.
__device__ __forceinline__ int list_spiking(const float* spk, int n,
                                            int* list, int* warp_count,
                                            bool count_silent, int* silent) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int s0 = 0; s0 < n; s0 += TB) {
    const int s = s0 + threadIdx.x;
    const bool active = s < n && spk[s] != 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, active);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int base = 0, pass = 0;
#pragma unroll
    for (int i = 0; i < TB_WARPS; ++i) {
      const int c = warp_count[i];
      base += i < warp ? c : 0;
      pass += c;
    }
    if (active) list[total + base + __popc(mask & ((1u << lane) - 1u))] = s;
    if (count_silent && threadIdx.x == 0) {
      constexpr int W = BLK / 32;  // warps per 128-source block
      for (int b = 0; b < TB / BLK && s0 + b * BLK < n; ++b) {
        int c = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) c += warp_count[b * W + i];
        *silent += c == 0;
      }
    }
    total += pass;
    __syncthreads();  // the list is written; warp_count may be rewritten
  }
  return total;
}

// synapse_matmul's ring: SM_STAGES stages of SM_ROWS weight-row segments
// of TB floats, (SM_STAGES - 1) * SM_ROWS rows in flight while a stage is
// summed. kernels/plan.py (RING_ROWS, RING_STAGES) mirrors it.
constexpr int SM_ROWS = 16;
constexpr int SM_STAGES = 4;
constexpr int SM_RING = SM_STAGES * SM_ROWS * TB * 4;

// Dynamic shared memory of one CTA; kernels/plan.py::smem_bytes mirrors it.
// ell_gather: the column's table row when staged. fused_step: that, then
// the column's spikes and the list of its spiking sources (n each), the
// ELL sums of two items (2 TB), per-warp counts and the claimed chunk.
// synapse_matmul: the ring (the column's spikes are staged at its start,
// so it is at least n floats), the list of spiking sources and their
// spike values (n each), per-warp counts.
__host__ __device__ constexpr int ell_gather_smem(bool staged, int t_len) {
  return staged ? round16(4 * t_len) : 0;
}
// the cluster path: the staged row, then the claimed chunk (fused_step's
// layout already ends with it)
__host__ __device__ constexpr int ell_gather_cluster_smem(int t_len) {
  return ell_gather_smem(true, t_len) + 16;
}
__host__ __device__ constexpr int fused_step_smem(bool staged, int t_len,
                                                  int n) {
  return ell_gather_smem(staged, t_len) + 2 * round16(4 * n) + 8 * TB +
         4 * TB_WARPS + 8;
}
__host__ __device__ constexpr int synapse_matmul_ring(int n) {
  return SM_RING > round16(4 * n) ? SM_RING : round16(4 * n);
}
__host__ __device__ constexpr int synapse_matmul_smem(int n) {
  return synapse_matmul_ring(n) + 2 * round16(4 * n) + 4 * TB_WARPS;
}

// Starts copying `count` floats from device memory to shared memory `dst`
// (16-byte aligned) with cp.async, as one commit group: 16-byte copies
// while `src` is 16-byte aligned, 4-byte copies for the tail or all of an
// unaligned row. The whole CTA calls it; cp_async_wait<N> + __syncthreads
// make the copy visible.
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ src,
                                            int count) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int groups = count >> 2;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + 16u * g),
                   "l"(src + 4 * g)
                   : "memory");
    }
    head = groups << 2;
  }
  for (int i = head + threadIdx.x; i < count; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4u * i),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The table a CTA gathers from: its column's row staged in shared memory
// (STAGED), or the row in device memory read through L2 (tables wider
// than the shared-memory budget). An index outside [0, t_len) gives NaN
// (as the reference's out-of-bounds gather fills) instead of reading out
// of bounds.
template <bool STAGED>
struct TableRow {
  const float* p;
  int t_len;
  __device__ __forceinline__ float operator()(int i) const {
    if ((unsigned)i >= (unsigned)t_len) return __int_as_float(0x7fc00000);
    if constexpr (STAGED) {
      return p[i];
    } else {
      return __ldg(p + i);
    }
  }
};

// ELL rows of one item: sink(r, sum_k tbl[idx[r, k]] * w[r, k]) for r in
// [0, rows), rows of K entries from (idx, w) on. One warp per row, the
// CTA's warps taking rows r = warp, warp + TB_WARPS, ...; every lane of
// the warp holds the sum, lane 0 sinks it. With STREAM the idx and
// weights stream past L1 marked evict-first (__ldcs): right where each
// byte is read once (the single-tenant launch, the wide path).
// The tenant-group clusters below read each line once per tenant of the
// group, and load without that hint (__ldg), so that L2 keeps the lines
// for the group's other CTAs.
//
// vec (K a multiple of 4 and both rows 16-byte aligned): lanes read 16
// bytes of idx and 16 of weights at a time, coalesced, and each warp keeps
// two rows of up to 64 int4 each in flight (128 bytes per lane) before it
// gathers: K = 248 is 62 int4 per row, one pass. Otherwise lanes stride
// over k with 4-byte reads. Each lane sums its own entries in order, then
// the warp reduces by shuffles: a fixed order, so a rerun gives the same
// bits.
template <bool STREAM, class T>
__device__ __forceinline__ T ell_load(const T* p) {
  if constexpr (STREAM) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

template <bool STREAM, bool STAGED, class Sink>
__device__ __forceinline__ void ell_rows(TableRow<STAGED> tbl,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ w,
                                         int rows, int k, bool vec,
                                         Sink sink) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (vec) {
    constexpr int R = 2, H = 2;  // rows in flight, int4 per lane per row
    const int kq = k >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int r0 = warp; r0 < rows; r0 += R * TB_WARPS) {
      float acc[R];
#pragma unroll
      for (int u = 0; u < R; ++u) acc[u] = 0.0f;
      for (int g0 = 0; g0 < kq; g0 += 32 * H) {
        int4 iv[R][H];
        float4 wv[R][H];
#pragma unroll
        for (int u = 0; u < R; ++u) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int r = r0 + u * TB_WARPS, g = g0 + h * 32 + lane;
            iv[u][h] = make_int4(0, 0, 0, 0);
            wv[u][h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (r < rows && g < kq) {
              const size_t off = (size_t)r * kq + g;
              iv[u][h] = ell_load<STREAM>(idx4 + off);
              wv[u][h] = ell_load<STREAM>(w4 + off);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int r = r0 + u * TB_WARPS, g = g0 + h * 32 + lane;
            if (r < rows && g < kq) {
              float a = acc[u];
              a = __fmaf_rn(tbl(iv[u][h].x), wv[u][h].x, a);
              a = __fmaf_rn(tbl(iv[u][h].y), wv[u][h].y, a);
              a = __fmaf_rn(tbl(iv[u][h].z), wv[u][h].z, a);
              a = __fmaf_rn(tbl(iv[u][h].w), wv[u][h].w, a);
              acc[u] = a;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int r = r0 + u * TB_WARPS;
        const float sum = warp_sum(acc[u]);
        if (lane == 0 && r < rows) sink(r, sum);
      }
    }
  } else {
    for (int r = warp; r < rows; r += TB_WARPS) {
      const int* ir = idx + (size_t)r * k;
      const float* wr = w + (size_t)r * k;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = lane; j < k; j += 32) {
        acc = __fmaf_rn(tbl(ell_load<STREAM>(ir + j)),
                        ell_load<STREAM>(wr + j), acc);
      }
      const float sum = warp_sum(acc);
      if (lane == 0) sink(r, sum);
    }
  }
}

// One (row, target block) work item of a tenant-axis launch: n_rows =
// tenants * C rows, row b * C + col of tenant b, items in the order
// (col, tenant, target block), so that the tenants of a column are
// neighbours (and tenants = 1 is the order (col, target block)).
struct Item {
  int col, row, tblk;
};

__device__ __forceinline__ Item tenant_item(int it, int tenants, int n_rows,
                                            int n_tblk) {
  if (tenants == 1) {  // the single-tenant order, with its two divisions
    const int col = it / n_tblk;
    return Item{col, col, it - col * n_tblk};
  }
  const int per_col = tenants * n_tblk;
  const int col = it / per_col;
  const int rest = it - col * per_col;
  const int b = rest / n_tblk;
  return Item{col, b * (n_rows / tenants) + col, rest - b * n_tblk};
}

// ---------------------------------------------------------------------
// The tenant-group cluster path of ell_gather and fused_step (tenants >
// 1, table row staged; kernels/plan.py, path "cluster", chooses it from
// the shapes and mirrors CLUSTER_MAX).
//
// B tenants split into `groups` groups of at most CLUSTER_MAX; a group
// runs as a thread-block cluster of `size` CTAs, two CTAs per SM as on
// the staged path, CTA rank g holding tenant grp * size + g's table row
// (and fused_step's spikes and spiking-source list) as one CTA of the
// staged path holds its row's. The unit of work is a group item (column,
// group, target block), in that order: rank 0 claims chunks of them from
// the counter (guided self-scheduling over the clusters), every CTA reads
// the chunk over DSMEM, and all CTAs of the cluster walk its items
// together, no CTA starting an item before every CTA of the cluster has
// started the one before (a split cluster barrier). So the block's idx
// and weight rows are requested by the group's CTAs within one item of
// each other, from the same GPC: the first request of each line goes to
// HBM and the others find it in L2, where items claimed one tenant after
// another would read the block from HBM once a tenant. These loads are
// not marked evict-first (ell_rows<false>),
// since the group's other CTAs read the same lines. Each CTA sums its
// rows exactly as the staged path does, so one cluster launch gives the
// bits of one launch per tenant and of the single-tenant launch.
//
// (The two designs that move the block between the cluster's CTAs lost
// to this one on the card: a ring of bulk copies multicast into every
// CTA's shared memory leaves one CTA per SM and a few stages beside the
// 99 KB table row, too little in flight; gathering the other tenants'
// rows from their CTAs' tables over DSMEM is an order of magnitude
// slower than a gather from the CTA's own shared memory, as
// tools/cluster_gather_probe.py measures; PERF.md.)
constexpr int CLUSTER_MAX = 8;

struct Groups {
  int n_cols;   // C, the columns of each tenant (the idx's rows)
  int tenants;  // B
  int groups;   // tenant groups
  int size;     // CTAs of a cluster, tenants of a group
};

// A group item as CTA `rank` sees it: its tenant's row, valid while the
// group has a tenant at that rank.
struct GroupItem {
  int col, row, tblk;
  bool valid;
};

__device__ __forceinline__ GroupItem group_item(const Groups& g, int it,
                                                unsigned rank, int n_tblk) {
  const int per_col = g.groups * n_tblk;
  const int col = it / per_col;
  const int rest = it - col * per_col;
  const int grp = rest / n_tblk;
  const int b = grp * g.size + (int)rank;
  return GroupItem{col, b * g.n_cols + col, rest - grp * n_tblk,
                   b < g.tenants};
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every CTA of the cluster. cluster_sync orders
// shared-memory accesses (DSMEM too) across the cluster; the split form,
// cluster_arrive now and cluster_wait later, only keeps the CTAs within a
// phase of each other.
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// the int at `p`'s offset in the shared memory of CTA `rank`
__device__ __forceinline__ int ld_peer(const int* p, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// The cluster's next chunk [c0, c1) of `items` group items, guided
// self-scheduling over the clusters: rank 0 claims about remaining /
// (2 * clusters) items, and each CTA copies the claim into its own
// claim[0..1] (two ints of shared memory). The whole cluster calls it.
__device__ __forceinline__ int2 cluster_claim(int* next_item, int items,
                                              int* claim, unsigned rank,
                                              int size) {
  if (rank == 0 && threadIdx.x == 0) {
    const int clusters = (int)gridDim.x / size;
    const int seen = *reinterpret_cast<volatile int*>(next_item);
    const int chunk = max(1, (items - seen) / (2 * clusters));
    const int start = atomicAdd(next_item, chunk);
    claim[0] = start;
    claim[1] = min(start + chunk, items);
  }
  cluster_sync();  // rank 0's claim is written
  if (threadIdx.x == 0) {
    const int c0 = ld_peer(&claim[0], 0), c1 = ld_peer(&claim[1], 0);
    claim[0] = c0;
    claim[1] = c1;
  }
  cluster_sync();  // every CTA has read it before rank 0 claims again
  return make_int2(claim[0], claim[1]);
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Whether (idx, w) can be read as 16-byte vectors: K a multiple of 4 and
// both arrays 16-byte aligned (then so is every row).
inline bool ell_vec(const int* idx, const float* w, int k) {
  return k % 4 == 0 && aligned16(idx) && aligned16(w);
}

// Sets the dynamic shared memory of a kernel instance and checks it
// against the device's per-block limit: a row that does not fit is an
// error, never a silent fallback.
template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, int smem_bytes) {
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (smem_bytes < 0 || smem_bytes > max_optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The groups of a cluster launch of n_rows = tenants * C rows as
// kernels/plan.py planned them; size 0 where the plan does not hold
// together.
inline Groups make_groups(int n_rows, int tenants, int cluster,
                          int groups) {
  Groups g{n_rows / tenants, tenants, groups, cluster};
  const bool ok = tenants > 1 && cluster >= 1 && cluster <= CLUSTER_MAX &&
                  groups >= 1 && groups * cluster >= tenants &&
                  (groups - 1) * cluster < tenants;
  if (!ok) g.size = 0;
  return g;
}

// Launches `kernel` on `ctas` CTAs of TB threads in clusters of `cluster`
// CTAs; returns the launch's error (a cluster the card cannot place is
// one).
template <class... Params, class... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int ctas,
                                  int cluster, int smem_bytes,
                                  cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(TB, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

inline LifParams lif_params(float decay_v, float decay_c, float gain,
                            float g_c, float alpha_c, float v_rest,
                            float v_reset, float v_thr, int arp) {
  return LifParams{decay_v, decay_c, gain, g_c, alpha_c,
                   v_rest,  v_reset, v_thr, arp};
}

}  // namespace repro
