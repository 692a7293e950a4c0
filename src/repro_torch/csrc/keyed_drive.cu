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
// 1.62), and it writes 8 bytes (count and current).
//
// The tenant instance (TENANTS) draws B tenants' drives in one launch:
// B * C columns, column b * C + c under tenant b's seed, step and rate,
// read from (B,) device arrays, so that the host builds no key and waits
// for nothing; every column draws exactly as the single-tenant
// instance draws it with those three as scalars.
//
// The design: one CTA per column (a column of more than SHARE_MAX
// neurons is split into equal shares, one CTA each, and each share's CTA
// grows the chain itself). The draws go in rounds: round r draws DRAWS =
// 2 times for every neuron still undone, with subkeys 2r and 2r + 1, the
// two threefry2x32 independent of each other; the sum still adds log u in
// order of j, so the counts are the plain version's to the bit. The
// undone neurons and their sums are a list in shared memory, packed
// densely: a warp draws for 32 undone neurons whatever their counts, and
// appends those still undone to the next round's list with a ballot and
// one shared atomic. A neuron that is done writes its count to shared
// memory; counts and currents go out coalesced at the end. The column's
// split chain is grown once, by lanes 0 and 1 of the last warp, a round
// ahead: in round r they make subkeys 2r + 2 and 2r + 3 (lane 0 the
// subkey, lane 1 the next rng, from the same rng) while the other warps
// draw, and the barrier that closes the round publishes them; the last
// warp has the fewest draws of a round. Only the prologue waits for the
// chain: the column key and subkeys 0 and 1, four threefry2x32 in a row.
//
// What holds it below the bound (PERF.md, section 6): issue first. Even at
// lam = 9.9, where nearly every round is wide, a useful draw costs about
// 1.7 times the bound's 80 integer operations: the funnel shifts and
// xors of threefry2x32, logf, the list's load, ballot, atomic, shuffle
// and store, and the second draw of a pair when the first ends a neuron
// (about 1.2 times the useful draws at lam = 1.62). Then latency: a
// column's later rounds are a warp or two each behind a CTA-wide
// barrier, and an SM holds only 4 or 5 columns (576 over 132) to hide
// them; and the prologue. logf, never __logf (no --use_fast_math): the
// kernel rounds as torch.log on the card does, so it equals its plain
// version to the bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the most neurons of a column one CTA draws for, and the shared memory
// each takes: two list entries and a count
constexpr int SHARE_MAX = 2048;
constexpr int SMEM_PER_NEURON = 20;
// CTAs an SM must hold at once (at most 51 registers a thread), so that
// one wave takes GRID_24's 576
constexpr int MIN_CTAS = 5;
// draws per undone neuron in a round, and the subkey ring (the round's
// and the next round's)
constexpr int DRAWS = 2;
constexpr int RING = 2 * DRAWS;

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

// One step of the split chain on lanes 0 and 1 (both holding rng): lane 0
// hashes (0, 1) into the subkey, lane 1 (0, 0) into the next rng.
__device__ __forceinline__ void chain_step(Key& rng, Key* sub, int lane) {
  const Key r = threefry(rng, 0u, 1u - lane);
  const Key s{__shfl_sync(0x3u, r.a, 0), __shfl_sync(0x3u, r.b, 0)};
  rng = Key{__shfl_sync(0x3u, r.a, 1), __shfl_sync(0x3u, r.b, 1)};
  if (lane == 0) *sub = s;
}

// log u of the uniform that the threefry2x32 output b gives
__device__ __forceinline__ float log_uniform(Key b) {
  return logf(__uint_as_float(((b.a ^ b.b) >> 9) | 0x3F800000u) - 1.0f);
}

// atomicAdd on shared memory, as one instruction (nvcc would otherwise
// aggregate the single lane's add across the warp)
__device__ __forceinline__ int shared_add(int* p, int v) {
  int old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(v)
               : "memory");
  return old;
}

// Per-tenant seeds, steps and rates of the TENANTS instance; a tenant's
// seed word is its seed + stream as uint32 (the key's second word).
struct Tenants {
  const int* seed;
  const int* t;
  const float* lam;
  unsigned stream;
  int cols;  // columns per tenant
};

template <bool TENANTS>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
keyed_drive_kernel(const int* __restrict__ col_ids, float* __restrict__ counts,
                   float* __restrict__ cur, int n, int share, int parts,
                   unsigned seed_word, unsigned t, float neg_lam,
                   float j_ext, Tenants tn) {
  // list r & 1 holds round r's undone neurons (neuron, sum bits), then
  // every neuron's count
  extern __shared__ int2 smem[];
  __shared__ Key sub[RING];        // subkey_j in sub[j % RING]
  __shared__ int len[3];           // round r's list length in len[r % 3]
  const int row = blockIdx.x / parts;  // column of the output
  int c = row;                          // its global id's index
  if constexpr (TENANTS) {
    const int b = row / tn.cols;
    c = row - b * tn.cols;
    seed_word = static_cast<unsigned>(tn.seed[b]) + tn.stream;
    t = static_cast<unsigned>(tn.t[b]);
    neg_lam = -tn.lam[b];
  }
  const int lo = (blockIdx.x % parts) * share;
  const int m = min(share, n - lo);   // this CTA's neurons lo .. lo + m - 1
  if (m <= 0) return;
  const long long out = static_cast<long long>(row) * n + lo;
  if (!(0.0f > neg_lam)) {            // lam = 0: no draw, every count 0
    for (int i = threadIdx.x; i < m; i += THREADS) {
      counts[out + i] = 0.0f;
      cur[out + i] = 0.0f * j_ext;
    }
    return;
  }
  int* const count = reinterpret_cast<int*>(smem + 2 * share);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u, all = 0xffffffffu;
  const bool chain = warp == WARPS - 1 && lane < 2;
  Key rng{0u, 0u};
  if (chain) {   // the column key, then subkeys 0 .. DRAWS - 1
    const Key step = threefry(Key{0u, seed_word}, 0u, t);
    rng = threefry(step, 0u, static_cast<unsigned>(col_ids[c]));
    for (int d = 0; d < DRAWS; ++d) chain_step(rng, &sub[d], lane);
  }
  if (threadIdx.x == 0) len[1] = 0;
  __syncthreads();
  // round r draws DRAWS times for each undone neuron, with subkeys
  // j = r * DRAWS ..., while the chain grows the next round's; the rounds
  // go on while any neuron is undone
  int u_len = m, j = 0;
  for (int r = 0; u_len > 0; ++r, j += DRAWS) {
    Key key[DRAWS];
    for (int d = 0; d < DRAWS; ++d) key[d] = sub[(j + d) % RING];
    // len[(r + 2) % 3] was last read before the previous barrier and is
    // next appended to after the coming one
    if (threadIdx.x == 0) len[(r + 2) % 3] = 0;
    if (chain) {
      for (int d = 0; d < DRAWS; ++d) {
        chain_step(rng, &sub[(j + DRAWS + d) % RING], lane);
      }
    }
    const int2* const now = smem + (r & 1) * share;
    int2* const next = smem + ((r + 1) & 1) * share;
    for (int k0 = warp * 32; k0 < u_len; k0 += THREADS) {
      const int k = k0 + lane;
      int i = k;                       // round 0: neuron k
      float lp = 0.0f;
      if (r > 0 && k < u_len) {
        const int2 e = now[k];
        i = e.x;
        lp = __int_as_float(e.y);
      }
      float lg[DRAWS];
      for (int d = 0; d < DRAWS; ++d) {
        lg[d] = log_uniform(
            threefry(key[d], 0u, static_cast<unsigned>(lo + i)));
      }
      bool more = k < u_len;
      for (int d = 0; d < DRAWS; ++d) {
        if (more) {
          lp += lg[d];
          if (!(lp > neg_lam)) {
            count[i] = j + d;          // j + d + 1 draws
            more = false;
          }
        }
      }
      const unsigned ball = __ballot_sync(all, more);
      int base = 0;
      if (lane == 0 && ball != 0u) {
        base = shared_add(&len[(r + 1) % 3], __popc(ball));
      }
      base = __shfl_sync(all, base, 0);
      if (more) {
        next[base + __popc(ball & below)] = make_int2(i, __float_as_int(lp));
      }
    }
    __syncthreads();   // the next list, its length and the next subkeys
    u_len = len[(r + 1) % 3];
  }
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const float k = static_cast<float>(count[i]);
    counts[out + i] = k;
    cur[out + i] = k * j_ext;
  }
}

}  // namespace

extern "C" int repro_keyed_drive(const int* col_ids, float* counts,
                                 float* cur, int c, int n, unsigned seed_word,
                                 unsigned t, float lam, float j_ext,
                                 cudaStream_t stream) {
  if (c <= 0 || n <= 0) return 0;
  // ceil(n / SHARE_MAX) CTAs a column, with equal shares of it
  const int parts = static_cast<int>((n + SHARE_MAX - 1LL) / SHARE_MAX);
  const int share = static_cast<int>((n + parts - 1LL) / parts);
  const long long blocks = static_cast<long long>(c) * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  keyed_drive_kernel<false><<<static_cast<unsigned>(blocks), THREADS,
                              SMEM_PER_NEURON * share, stream>>>(
      col_ids, counts, cur, n, share, parts, seed_word, t, -lam, j_ext,
      Tenants{nullptr, nullptr, nullptr, 0u, c});
  return static_cast<int>(cudaGetLastError());
}

// B tenants' drives of the columns col_ids (C of them) in one launch:
// (B * C, N) counts and currents, tenant b's seed word seeds[b] + stream
// (as uint32), step and rate from ts[b] and lams[b]; seeds, ts and lams
// are (B,) device arrays (every rate in [0, 10): the caller checks).
extern "C" int repro_keyed_drive_tenants(const int* col_ids, float* counts,
                                         float* cur, int tenants, int c,
                                         int n, const int* seeds,
                                         unsigned seed_stream, const int* ts,
                                         const float* lams, float j_ext,
                                         cudaStream_t stream) {
  if (tenants <= 0 || c <= 0 || n <= 0) return 0;
  const int parts = static_cast<int>((n + SHARE_MAX - 1LL) / SHARE_MAX);
  const int share = static_cast<int>((n + parts - 1LL) / parts);
  const long long blocks = static_cast<long long>(tenants) * c * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  keyed_drive_kernel<true><<<static_cast<unsigned>(blocks), THREADS,
                             SMEM_PER_NEURON * share, stream>>>(
      col_ids, counts, cur, n, share, parts, 0u, 0u, 0.0f, j_ext,
      Tenants{seeds, ts, lams, seed_stream, c});
  return static_cast<int>(cudaGetLastError());
}
