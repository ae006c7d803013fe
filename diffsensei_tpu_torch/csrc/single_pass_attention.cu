// Single-pass exact-softmax attention for Hopper (sm_90a): kernel B8.
//
// Replaces the Pallas TPU kernel `_single_kernel`
// (tools/bench_attention_single.py:28, pallas_call at :47, entry
// `single_pass_attention:43`), an experiment against B1's online softmax.
// For q [B, H, Sq, 64] and k, v [B, H, Sk, 64], bf16, it computes one exact
// softmax over a q block's whole score row, with no running max: s in fp32,
// m = rowmax s, p = exp(s - m), l = sum p (fp32), o = (bf16(p) V) / l.
//
// What bounds it on the H100: the same work as B1 (4 Sq Sk 64 operations),
// so the tensor cores and the exponentials. What the TPU kernel leans on is
// its large VMEM: the whole score row of a q block sits there at once. On
// this card 64 rows x 1024 keys of fp32 scores are 256 KB, more than one
// block's 227 KB. The Hopper counterpart is a thread-block cluster, whose
// blocks read each other's shared memory (distributed shared memory):
//   * a cluster of N blocks owns 64 q rows and splits the keys: each block
//     holds at most 8 tiles of 64 keys (512 keys, 128 KB of fp32 scores), so
//     N = ceil(Sk / 512): 2 at 1024 keys, 8 at 4096. Eight, the portable
//     cluster size, is the most: 4096 keys. (At 16384 keys a 64-row block's
//     row is 4 MB, beyond even a 16-block cluster's 16 x 227 KB, and wgmma
//     takes no fewer than 64 rows: that shape is refused.)
//   * each block is a consumer warpgroup and a producer warp (hopper.cuh):
//     the producer loads the Q tile, then streams the block's K tiles, then
//     its V tiles, through a four-slot ring;
//   * pass 1: S = Q K^T a tile at a time (wgmma), scaled into log2 units,
//     keys past Sk set to -inf, parked in the block's shared memory, and the
//     block's row max written beside it;
//   * a cluster barrier, then every block takes the row max over the
//     cluster's blocks (reads of their shared memory): the exact max m;
//   * pass 2: p = 2^(s - m) (ex2.approx) summed into l in fp32, rounded to
//     bf16 as the A operand of O += P V (wgmma, V through the transpose bit);
//   * a second barrier, and the blocks' partial row sums and 64 x 64 fp32
//     partial outputs meet: block r sums rows r, r + N, ... over the blocks
//     in rank order, divides and writes them. A third barrier keeps every
//     block's shared memory alive until the others have read it.
// No scratch in device memory and no atomics: two calls give the same bits.
// The producer warp arrives at the first barrier before it streams, since
// the V tiles it still has to load wait on pass 2. Rows past Sq read zeros
// and are not written; a ragged last key tile reads zeros, masked.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hop;

constexpr int STAGES = 4;  // slots of the K/V ring

constexpr int MAXT = 8;          // key tiles a block holds: 512 keys
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr uint32_t SCORE_TILE = T * 64 * 4;  // one tile's fp32 scores: 16 KB

// Q tile, the ring, the partial output (64 x 64 fp32), the row maxima and
// sums, the barriers, then `tiles` tiles of parked scores.
struct Smem {
  static constexpr uint32_t OPART = TILE + STAGES * TILE;
  static constexpr uint32_t ROWS = OPART + T * 64 * 4;
  static constexpr uint32_t BARS = ROWS + 2 * T * 4;
  static constexpr uint32_t SCORES = BARS + 8 * (2 * STAGES + 1) + 8;
  static constexpr size_t bytes(int tiles) { return SCORES + (size_t)tiles * SCORE_TILE + 1024; }
  uint32_t base;  // shared-window address, 1024-aligned: the Q tile
  unsigned char* ptr;
  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023u) & ~1023u;
    ptr = raw + (base - r);
  }
  __device__ float* at(uint32_t off) const { return reinterpret_cast<float*>(ptr + off); }
  __device__ float* opart() const { return at(OPART); }
  __device__ float* row_max() const { return at(ROWS); }
  __device__ float* row_sum() const { return at(ROWS + T * 4); }
  __device__ float* scores() const { return at(SCORES); }
  __device__ uint32_t bar0() const { return base + BARS; }
};

// The cluster barrier in two halves (every thread of every block of the
// cluster arrives once and waits once a phase); release / acquire order the
// shared-memory writes before it with the reads after it.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

__global__ void __launch_bounds__(THREADS)
single_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int Sq, int Sk,
              int per, long long sob, long long soh, long long sos, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int q_start = (blockIdx.x / ranks) * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int first = rank * per;  // this block's first key tile
  const int count = max(0, min(per, (Sk + T - 1) / T - first));
  init_ring(sm.bar0(), STAGES, CONSUMERS);
  Ring<STAGES> ring(sm.base + TILE, sm.bar0());

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {  // producer: arrives first, then streams, then keeps step
    cluster_arrive();
    if (lane == 0) {
      mbar_expect_tx(sm.bar0(), TILE);
      tma_4d(sm.base, &tm_q, sm.bar0(), 0, q_start, h, b);
      for (int j = 0; j < count; ++j) ring.load(&tm_k, (first + j) * T, h, b);
      for (int j = 0; j < count; ++j) ring.load(&tm_v, (first + j) * T, h, b);
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows of the block: r0, r0 + 8
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units
  const float neg_inf = __int_as_float(0xff800000);
  float s[32], o_acc[32];
  uint32_t pa[4][4];
  float* scratch = sm.scores();
  mbar_wait(sm.bar0(), 0);

  // pass 1: the block's scores, parked, and its row max
  float mx[2] = {neg_inf, neg_inf};
  for (int j = 0; j < count; ++j) {
    qk_tile(s, sm.base, ring);
    const int key0 = (first + j) * T + 2 * t;
    const bool ragged = (first + j + 1) * T > Sk;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      s[x] *= scale2;
      if (ragged && key0 + 8 * (x >> 2) + (x & 1) >= Sk) s[x] = neg_inf;
      mx[(x & 3) >> 1] = fmaxf(mx[(x & 3) >> 1], s[x]);
    }
    put_scores(scratch, j, s);
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    mx[rh] = quad_max(mx[rh]);
    if (t == 0) sm.row_max()[r0 + 8 * rh] = mx[rh];
  }
  cluster_arrive();
  cluster_wait();

  // the exact row max over the cluster's keys
  float m[2] = {neg_inf, neg_inf};
  for (int q = 0; q < ranks; ++q) {
    const float* other = cluster.map_shared_rank(sm.row_max(), q);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) m[rh] = fmaxf(m[rh], other[r0 + 8 * rh]);
  }

  // pass 2: P and O += P V over the block's keys
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 32; ++x) o_acc[x] = 0.f;
  for (int j = 0; j < count; ++j) {
    get_scores(s, scratch, j);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      s[x] = ex2(s[x] - m[(x & 3) >> 1]);
      l[(x & 3) >> 1] += s[x];
    }
    to_a_frags(pa, s);
    pv_tile(o_acc, pa, ring);
  }
  float* opart = sm.opart();
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float sum = quad_sum(l[rh]);
    if (t == 0) sm.row_sum()[r0 + 8 * rh] = sum;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(opart + (r0 + 8 * rh) * 64 + 8 * n + 2 * t) =
          make_float2(o_acc[4 * n + 2 * rh], o_acc[4 * n + 2 * rh + 1]);
    }
  }
  cluster_arrive();
  cluster_wait();

  // rows rank, rank + ranks, ...: the blocks' partials summed in rank order
  const int rows = (T - rank + ranks - 1) / ranks;
  for (int e = threadIdx.x; e < rows * 32; e += CONSUMERS) {
    const int row = rank + ranks * (e / 32), col = 2 * (e % 32);
    if (q_start + row >= Sq) continue;
    float2 acc = make_float2(0.f, 0.f);
    float sum = 0.f;
    for (int q = 0; q < ranks; ++q) {
      const float2 part = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(opart, q) + row * 64 + col);
      acc.x += part.x;
      acc.y += part.y;
      sum += cluster.map_shared_rank(sm.row_sum(), q)[row];
    }
    *reinterpret_cast<uint32_t*>(o + b * sob + h * soh + (long long)(q_start + row) * sos + col) =
        pack_bf16(acc.x / sum, acc.y / sum);
  }
  cluster_arrive();  // no block leaves while another may still read its shared memory
  cluster_wait();
}

}  // namespace

// C entry point bound with ctypes. q [B, H, Sq, 64], k and v [B, H, Sk, 64],
// o [B, H, Sq, 64], all bf16; `strides` holds 12 element strides, (b, h, s)
// of q, k, v and o (the last dim has stride 1; q, k and v are read by TMA, so
// 16-byte aligned with strides divisible by 8). 1 <= Sk <= 4096. One launch
// of clusters of ceil(Sk / 512) blocks. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for more keys or where a map cannot be encoded).
extern "C" int diffsensei_single_pass_attention(const void* q, const void* k, const void* v,
                                                void* o, int B, int H, int Sq, int Sk,
                                                const long long* st, float sm_scale,
                                                void* stream) {
  const int tiles = (Sk + T - 1) / T;
  const int ranks = (tiles + MAXT - 1) / MAXT;
  if (Sk < 1 || Sq < 1 || ranks > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int per = (tiles + ranks - 1) / ranks;
  CUtensorMap mq, mk, mv;
  if (!(map_rows(&mq, q, B, H, Sq, st) && map_rows(&mk, k, B, H, Sk, st + 3) &&
        map_rows(&mv, v, B, H, Sk, st + 6))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(single_kernel), Smem::bytes(MAXT));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * ((Sq + T - 1) / T), H, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Smem::bytes(per);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, single_kernel, mq, mk, mv,
                           static_cast<bf16*>(o), Sq, Sk, per, st[9], st[10], st[11], sm_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
