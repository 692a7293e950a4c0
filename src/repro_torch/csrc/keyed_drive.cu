// Poisson drive of one step, keyed as the JAX reference keys it.
//
// No Pallas counterpart: this replaces repro/core/network.py::
// external_drive, a plain-jnp function, i.e. jax.random.poisson (Knuth's
// loop, lam < 10) of every global column under the threefry2x32 key
//   fold_in(fold_in(PRNGKey(seed + 0xE57), t), col_ids[c])
// (kernels/ref.py::keyed_poisson_ref is the plain version). Iteration j
// of a column draws its uniforms from the j-th subkey of the column's
// split chain (rng_{j+1} = threefry(rng_j, (0, 0)), subkey_j =
// threefry(rng_j, (0, 1))); neuron i hashes the counter (0, i) under it.
// A count is J - 1, where J is the number of draws after which the
// float32 sum of log(u) is first -lam or below.
//
// Bound on the card: operations. Each draw is one threefry2x32 (20 rounds
// of add, rotate, xor and 5 key injections, about 80 integer operations)
// and a logf; a neuron makes count + 1 draws (2.6 on average at lam =
// 1.62), and it writes 8 bytes (count and current). The design: one
// thread per neuron, CTAs of 256 neurons of one column; thread 0 derives
// the column's key in a prologue and grows the split chain in shared
// memory, CHAIN subkeys at a time, as far as the CTA's slowest neuron
// needs; every thread stops drawing when its own sum is done. logf, never
// __logf (no --use_fast_math): the kernel rounds as torch.log on the card
// does, so it equals its plain version to the bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHAIN = 8;   // subkeys grown at a time (counts up to 7)

struct Key {
  unsigned a, b;
};

__device__ __forceinline__ void mix(unsigned& x0, unsigned& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry2x32 of the counter (c0, c1) under key k (Random123; the
// rotations and key schedule of jax/_src/prng.py).
__device__ __forceinline__ Key threefry(Key k, unsigned c0, unsigned c1) {
  const unsigned k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  unsigned x0 = c0 + k.a, x1 = c1 + k.b;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k.b; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k.a + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k.a; x1 += k.b + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k.b; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k.a + 5u;
  return Key{x0, x1};
}

__global__ void __launch_bounds__(THREADS)
keyed_drive_kernel(const int* __restrict__ col_ids, float* __restrict__ counts,
                   float* __restrict__ cur, int n, int blocks_per_col,
                   unsigned seed_word, unsigned t, float neg_lam,
                   float j_ext) {
  __shared__ Key sub[CHAIN];
  const int c = blockIdx.x / blocks_per_col;
  const int i = (blockIdx.x % blocks_per_col) * THREADS + threadIdx.x;
  const bool in_col = i < n;   // the rest only take part in the barriers
  Key rng{0u, 0u};
  if (threadIdx.x == 0) {
    const Key step = threefry(Key{0u, seed_word}, 0u, t);
    rng = threefry(step, 0u, static_cast<unsigned>(col_ids[c]));
  }
  float log_prod = 0.0f;
  int draws = 0;
  for (;;) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < CHAIN; ++j) {
        sub[j] = threefry(rng, 0u, 1u);
        rng = threefry(rng, 0u, 0u);
      }
    }
    __syncthreads();
    if (in_col) {
      for (int j = 0; j < CHAIN && log_prod > neg_lam; ++j) {
        const Key b = threefry(sub[j], 0u, static_cast<unsigned>(i));
        const float u =
            __uint_as_float(((b.a ^ b.b) >> 9) | 0x3F800000u) - 1.0f;
        log_prod += logf(u);
        ++draws;
      }
    }
    // also the barrier before thread 0 overwrites the chain
    if (!__syncthreads_or(in_col && log_prod > neg_lam)) break;
  }
  if (in_col) {
    const float k = static_cast<float>(max(draws - 1, 0));   // lam = 0: 0
    const long long o = static_cast<long long>(c) * n + i;
    counts[o] = k;
    cur[o] = k * j_ext;
  }
}

}  // namespace

extern "C" int repro_keyed_drive(const int* col_ids, float* counts,
                                 float* cur, int c, int n,
                                 unsigned seed_word, unsigned t, float lam,
                                 float j_ext, cudaStream_t stream) {
  if (c <= 0 || n <= 0) return 0;
  const int blocks_per_col = (n + THREADS - 1) / THREADS;
  const long long blocks = static_cast<long long>(c) * blocks_per_col;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  keyed_drive_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      col_ids, counts, cur, n, blocks_per_col, seed_word, t, -lam, j_ext);
  return static_cast<int>(cudaGetLastError());
}
