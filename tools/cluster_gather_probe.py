#!/usr/bin/env python3
"""Gathers from a CTA's own shared memory against gathers from another
CTA's shared memory in its thread-block cluster (DSMEM), on one NVIDIA
H100.

    python3 tools/cluster_gather_probe.py

The tenant-axis ELL kernels (``csrc/ell_gather.cu``, ``csrc/fused_step.cu``)
could share one read of an ELL block among a cluster of CTAs, one CTA per
tenant, if each CTA gathered the other tenants' sums from their CTAs'
table rows over DSMEM. This probe times that inner loop alone at the
service's shapes: CTAs of 256 threads, a 24,800-float table row in
shared memory (``GRID_24``), 248 int32 indices a row read as 16-byte
vectors from device memory (64 rows a CTA, small enough to stay in L2),
two rows in flight per warp, 20 passes; each lane sums its gathers. It
runs one and two CTAs per SM, clusters of 1, 2 and 4, and gathers from
the CTA's own table (a plain shared load, or ``ld.shared::cluster`` to
its own rank) or from the next rank's (``ld.shared::cluster`` through
``mapa``), and prints the time of one launch (CUDA events, after one
warm-up launch) and the gathers per microsecond per SM. It builds its
kernel with the CUDA toolkit's ``nvcc`` into ``build/probe/`` and needs
the card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe"

SOURCE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(unsigned base, int i) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(base + 4u * (unsigned)i) : "memory");
  return v;
}

__global__ void __launch_bounds__(256, 1)
    probe(float* out, const int* idx, int t_len, int passes, int offset,
          int cluster_load, int rows, int k) {
  extern __shared__ float4 smem4[];
  float* tbl = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < t_len; i += blockDim.x) {
    tbl[i] = (float)(i & 7);
  }
  unsigned rank, size, base;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(size));
  cluster_sync();
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(base) : "r"(smem_u32(tbl)), "r"((rank + offset) % size));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kq = k >> 2;
  const int4* idx4 =
      reinterpret_cast<const int4*>(idx) + (size_t)blockIdx.x * rows * kq;
  float total = 0.0f;
  for (int pass = 0; pass < passes; ++pass) {
    for (int r0 = warp; r0 < rows; r0 += 16) {
      int4 iv[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + u * 8, g = h * 32 + lane;
          iv[u][h] = r < rows && g < kq ? idx4[(size_t)r * kq + g]
                                        : make_int4(0, 0, 0, 0);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int4 v = iv[u][h];
          total += cluster_load
              ? ld_cluster(base, v.x) + ld_cluster(base, v.y) +
                    ld_cluster(base, v.z) + ld_cluster(base, v.w)
              : tbl[v.x] + tbl[v.y] + tbl[v.z] + tbl[v.w];
        }
    }
  }
  cluster_sync();  // no CTA leaves while another may read its table
  out[blockIdx.x * blockDim.x + threadIdx.x] = total;
}

extern "C" int run_probe(float* out, const int* idx, int t_len, int passes,
                         int offset, int cluster_load, int rows, int k,
                         int ctas, int cluster, int smem, float* ms) {
  cudaError_t err = cudaFuncSetAttribute(
      probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  err = cudaLaunchKernelEx(&cfg, probe, out, idx, t_len, passes, offset,
                           cluster_load, rows, k);
  if (err != cudaSuccess) return (int)err;
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, probe, out, idx, t_len, passes, offset,
                     cluster_load, rows, k);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""

T_LEN, K, ROWS, PASSES = 24_800, 248, 64, 20


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import nvcc_path
    nvcc = nvcc_path()
    if nvcc is None:
        raise SystemExit("cluster_gather_probe: nvcc not found")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cluster_gather_probe.cu").write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(OUT / "cluster_gather_probe.so"),
                    str(OUT / "cluster_gather_probe.cu")], check=True)
    lib = ctypes.CDLL(str(OUT / "cluster_gather_probe.so"))
    lib.run_probe.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                              + [ctypes.c_void_p])
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cluster_gather_probe: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    out = torch.zeros(2 * sms * 256, device="cuda")
    idx = torch.randint(0, T_LEN, (2 * sms * ROWS * K,), dtype=torch.int32,
                        device="cuda")
    ms = ctypes.c_float()
    cases = [("own table, shared load", 0, 0), ("own table, DSMEM load", 0, 1),
             ("next rank's table, DSMEM load", 1, 1)]
    for per_sm, smem in ((1, 200_000), (2, 111_000)):
        for cluster in (1, 2, 4):
            ctas = sms * per_sm // cluster * cluster
            for label, offset, dsmem in cases:
                if cluster == 1 and offset:
                    continue
                rc = lib.run_probe(out.data_ptr(), idx.data_ptr(), T_LEN,
                                   PASSES, offset, dsmem, ROWS, K, ctas,
                                   cluster, smem, ctypes.byref(ms))
                if rc != 0:
                    raise SystemExit(f"launch failed: CUDA error {rc}")
                gathers = ctas * ROWS * K * PASSES
                print(f"{per_sm} CTA/SM, clusters of {cluster}, {label}: "
                      f"{ms.value:.4f} ms, "
                      f"{gathers / (ms.value * 1e3) / sms:.1f} gathers/us/SM",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
