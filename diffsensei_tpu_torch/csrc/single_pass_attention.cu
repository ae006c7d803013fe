// Single-pass exact-softmax attention for Hopper (sm_90a): kernel B8.
//
// Replaces the Pallas TPU kernel `_single_kernel`
// (tools/bench_attention_single.py:28, pallas_call at :47, entry
// `single_pass_attention:43`), an experiment against B1's online softmax.
// For q [B, H, Sq, 64] and k, v [B, H, Sk, 64], bf16, it computes one exact
// softmax over a q tile's whole score row, with no running max: s in fp32,
// m = rowmax s, p = exp(s - m), l = sum p (fp32), o = (bf16(p) V) / l.
//
// What bounds it on the H100: the same work as B1 (4 Sq Sk 64 operations),
// so the tensor cores and the exponentials. What the TPU kernel leans on is
// its large VMEM: the whole score row of a q block sits there at once. On
// this card 64 rows x 4096 keys of fp32 scores are 1 MB, beyond one block.
// The Hopper counterpart is a thread-block cluster whose blocks split the
// keys and hold their scores in registers:
//   * a cluster of N = ceil(Sk / 512) blocks (at most 8, the portable size:
//     4096 keys) stays on one (batch, head) and walks a group of its q tiles
//     (every G-th 64-row tile; the host picks G from the clusters the card
//     holds at once, so that they fill whole waves). Block r holds keys
//     512 r .. 512 r + 511: their K and V (128 KB) are loaded once and stay
//     in shared memory for every q tile of the group; Q tiles come through
//     two slots, the next one loaded as soon as this one's max is known;
//   * a block is two warpgroups on the same 64 q rows, 256 keys each, and
//     no producer warp: thread 0 issues the few TMA loads. (In this
//     kernel's build a ninth warp, a producer warp or a producer warpgroup
//     with setmaxnreg 40/232, left ptxas at 168 registers a thread, and the
//     wgmmas ran one after another, 0.5427 against 0.4787 ms with eight
//     warps (PERF.md §6); with eight warps it uses 243.) S = Q K^T of a
//     warpgroup's 256 keys is one m64n256 wgmma a k-step, one commit and
//     one wait: a thread holds its rows' 128 fp32 scores in registers.
//     Keys past Sk are set to -inf;
//   * the exact row max: each warpgroup stores its rows' maxima into every
//     block of the cluster with st.async, whose bytes complete on that
//     block's mbarrier (the receiver expects 512 N bytes a tile and waits);
//     each block then takes the max of the 2 N values a row;
//   * p = 2^(s log2e / 8 - m log2e / 8) (ex2.approx), summed into l in fp32,
//     rounded to bf16 as the A operand of O += P V (V through the transpose
//     bit); each 64-key tile's P V is issued as soon as its exponentials are
//     done, at most two in flight, so the products run under the next
//     tile's exponentials;
//   * the partial outputs: the first warpgroup stages its 64 x 64 fp32
//     partial O and row sums row-major in shared memory, the second adds
//     its own and copies each owner's rows (runs of ceil(64 / N)) into that
//     block with one bulk copy (cp.async.bulk shared::cta to
//     shared::cluster, completing on the owner's mbarrier); the owner's
//     first warpgroup sums the N partials in rank order, divides and writes
//     bf16 while the next tile's row max is in flight.
// Buffers that cross blocks are double-buffered by tile parity; a block
// cannot reach tile i + 2's stores before every block has read tile i's,
// since tile i + 1's max needs every block's store. No scratch in device
// memory and no atomics: two calls give the same bits. Two products a tile
// do not fit the registers (128 scores a thread, 256 for two), so the next
// tile's S waits for this tile's P V. Rows past Sq read zeros and are not
// written; a ragged last key tile reads zeros, masked.
// What still bounds it (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): each
// tile waits once for the cluster's maxima, and the 16 KB of partial O a
// block sends and receives a tile go through distributed shared memory at
// a few bytes a clock.

#include "hopper.cuh"

#include <map>
#include <utility>

namespace {

using namespace hop;

constexpr int KEYS = 512;                   // keys a block holds
constexpr int KT = KEYS / T;                // their 64-key tiles: 8
constexpr int HALF = KT / 2;                // tiles a consumer warpgroup takes: 4
constexpr int MAX_CLUSTER = 8;              // the portable cluster size
constexpr int RECV_ROWS = 72;               // >= N * ceil(64 / N) for N <= 8
constexpr int BLOCK = 2 * CONSUMERS;        // two warpgroups: 2 warps an SMSP, up to 255 registers

// Shared memory from the 1024-aligned base: two Q slots, the block's K and V
// tiles, then, two slots each (tile parity): the row maxima received
// [src][warpgroup][32 row pairs], the block's partial O staged row-major
// (64 rows of 64 values and the row sum, ROW floats a row), the partial rows
// received [src * rows + row], and the barriers.
constexpr int ROW = 68;  // floats a staged row: 64 values, the row sum, padding to 16 bytes
struct Smem {
  static constexpr uint32_t K0 = 2 * TILE;
  static constexpr uint32_t V0 = K0 + KT * TILE;
  static constexpr uint32_t MAXB = V0 + KT * TILE;
  static constexpr uint32_t MAXB_SLOT = MAX_CLUSTER * 2 * 32 * 8;
  static constexpr uint32_t STAGE = MAXB + 2 * MAXB_SLOT;
  static constexpr uint32_t STAGE_SLOT = T * ROW * 4;
  static constexpr uint32_t RECV = STAGE + 2 * STAGE_SLOT;
  static constexpr uint32_t RECV_SLOT = RECV_ROWS * ROW * 4;
  static constexpr uint32_t BARS = RECV + 2 * RECV_SLOT;
  // K, V, then Q full[2], max[2], o[2]
  static constexpr size_t BYTES = BARS + 8 * 8 + 1024;
  uint32_t base;
  unsigned char* ptr;
  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023u) & ~1023u;
    ptr = raw + (base - r);
  }
  __device__ float* at(uint32_t off) const { return reinterpret_cast<float*>(ptr + off); }
  __device__ uint32_t q(int slot) const { return base + slot * TILE; }
  __device__ uint32_t k_bar() const { return base + BARS; }
  __device__ uint32_t v_bar() const { return base + BARS + 8; }
  __device__ uint32_t q_full(int slot) const { return base + BARS + 16 + 8 * slot; }
  __device__ uint32_t max_bar(int slot) const { return base + BARS + 32 + 8 * slot; }
  __device__ uint32_t o_bar(int slot) const { return base + BARS + 48 + 8 * slot; }
};

__global__ void __launch_bounds__(BLOCK, 1)
single_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int Sq, int Sk,
              int groups, long long sob, long long soh, long long sos, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int rank = (int)cluster_rank();
  const int ranks = (int)cluster_blocks();
  const int group = blockIdx.x / ranks;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_tiles = (Sq + T - 1) / T;
  const int mine = group < q_tiles ? (q_tiles - group + groups - 1) / groups : 0;
  const int rows_per = (T + ranks - 1) / ranks;  // output rows a block owns
  if (threadIdx.x == 0) {
    mbar_init(sm.k_bar(), 1);
    mbar_init(sm.v_bar(), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(sm.q_full(s), 1);
      mbar_init(sm.max_bar(s), 1);  // the receiver's expect_tx; the bytes come by st_async
      mbar_init(sm.o_bar(s), 1);    // and here by bulk copies
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // no block stores into another before its barriers exist
  cluster_wait();

  // thread 0 loads the block's K and V tiles and the first Q tile; the
  // next Q tile once both warpgroups of the block have read this one
  auto load_q = [&](int i) {
    const int slot = i & 1;
    mbar_expect_tx(sm.q_full(slot), TILE);
    tma_4d(sm.q(slot), &tm_q, sm.q_full(slot), 0, (group + i * groups) * T, h, b);
  };
  if (threadIdx.x == 0 && mine > 0) {
    const int last = ((Sk - 1) / T) * T;  // tiles wholly past Sk load the last one, masked
    load_q(0);
    mbar_expect_tx(sm.k_bar(), KT * TILE);
    for (int j = 0; j < KT; ++j) {
      tma_4d(sm.base + Smem::K0 + j * TILE, &tm_k, sm.k_bar(), 0, min(rank * KEYS + j * T, last), h, b);
    }
    mbar_expect_tx(sm.v_bar(), KT * TILE);
    for (int j = 0; j < KT; ++j) {
      tma_4d(sm.base + Smem::V0 + j * TILE, &tm_v, sm.v_bar(), 0, min(rank * KEYS + j * T, last), h, b);
    }
  }

  const int wg = threadIdx.x / CONSUMERS;
  const int tid = threadIdx.x % CONSUMERS;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp * 8 + g;        // this thread's rows: 16 warp + g and + 8
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units
  const float neg_inf = __int_as_float(0xff800000);
  const int key0 = rank * KEYS + wg * HALF * T;  // this warpgroup's first key
  const bool ragged = key0 + HALF * T > Sk;
  const uint32_t k0 = sm.base + Smem::K0 + wg * HALF * TILE;
  const uint32_t v0 = sm.base + Smem::V0 + wg * HALF * TILE;

  // The owner's sum of tile i's partial outputs over the cluster, in rank
  // order, written as bf16 (first warpgroup).
  auto finish = [&](int i) {
    const int slot = i & 1;
    const int q0 = (group + i * groups) * T;
    if (tid == 0) mbar_expect_tx(sm.o_bar(slot), ranks * (min(T, rank * rows_per + rows_per) - rank * rows_per) * ROW * 4);
    mbar_wait<true>(sm.o_bar(slot), (i >> 1) & 1);
    const float* recv = sm.at(Smem::RECV + slot * Smem::RECV_SLOT);
    for (int e = tid; e < rows_per * 32; e += CONSUMERS) {
      const int lr = e >> 5, col = 2 * (e & 31);
      const int row = rank * rows_per + lr;
      if (row >= T || q0 + row >= Sq) continue;
      float2 acc = make_float2(0.f, 0.f);
      float sum = 0.f;
      for (int src = 0; src < ranks; ++src) {
        const float* part = recv + (src * rows_per + lr) * ROW;
        const float2 two = *reinterpret_cast<const float2*>(part + col);
        acc.x += two.x;
        acc.y += two.y;
        sum += part[64];
      }
      *reinterpret_cast<uint32_t*>(o + b * sob + h * soh + (long long)(q0 + row) * sos + col) =
          pack_bf16(acc.x / sum, acc.y / sum);
    }
  };

  float s[HALF][32], o_acc[32];
  float(&wide)[HALF * 32] = *reinterpret_cast<float(*)[HALF * 32]>(&s[0][0]);  // one m64n256 product
  uint32_t pa[HALF][4][4];
  if (mine > 0) mbar_wait(sm.k_bar(), 0);
  for (int i = 0; i < mine; ++i) {
    const int slot = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    // S = Q K^T over this warpgroup's four key tiles, one commit
    mbar_wait(sm.q_full(slot), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(wide, desc(sm.q(slot) + 32 * kk), desc(k0 + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HALF; ++j) fence_acc(s[j]);

    // this warpgroup's row max, stored into every block of the cluster
    if (ragged) {
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int key = key0 + j * T + 8 * (x >> 2) + 2 * t + (x & 1);
          s[j][x] = key < Sk ? s[j][x] : neg_inf;
        }
      }
    }
    float mj[HALF][2];  // a max per tile and row half: short dependency chains
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      mj[j][0] = mj[j][1] = neg_inf;
#pragma unroll
      for (int x = 0; x < 32; ++x) mj[j][(x & 3) >> 1] = fmaxf(mj[j][(x & 3) >> 1], s[j][x]);
    }
    float mx[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) mx[rh] = fmaxf(fmaxf(mj[0][rh], mj[1][rh]), fmaxf(mj[2][rh], mj[3][rh]));
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const uint32_t maxb = sm.base + Smem::MAXB + slot * Smem::MAXB_SLOT;
    for (int p = t; p < ranks; p += 4) {
      st_async(peer_addr(maxb + ((rank * 2 + wg) * 32 + pair) * 8, p), mx[0], mx[1],
               peer_addr(sm.max_bar(slot), p));
    }
    if (threadIdx.x == 0) mbar_expect_tx(sm.max_bar(slot), ranks * 2 * 32 * 8);
    if (wg == 0 && i > 0) finish(i - 1);  // under the exchange's latency
    mbar_wait<true>(sm.max_bar(slot), parity);
    // both warpgroups of this block have read Q tiles i - 1 and i: load i + 1
    if (threadIdx.x == 0 && i + 1 < mine) load_q(i + 1);
    float m[2] = {neg_inf, neg_inf};
    const float2* maxes = reinterpret_cast<const float2*>(sm.at(Smem::MAXB + slot * Smem::MAXB_SLOT));
    for (int src = 0; src < 2 * ranks; ++src) {
      const float2 other = maxes[src * 32 + pair];
      m[0] = fmaxf(m[0], other.x);
      m[1] = fmaxf(m[1], other.y);
    }
    const float neg_m[2] = {-m[0] * scale2, -m[1] * scale2};
    if (i == 0) mbar_wait(sm.v_bar(), 0);

    // P = 2^(s scale2 - m scale2) a key tile at a time, each tile's P V
    // issued at once
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 32; ++x) o_acc[x] = 0.f;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int rh = (x & 3) >> 1;
        s[j][x] = ex2(fmaf(s[j][x], scale2, neg_m[rh]));
        l[rh] += s[j][x];
      }
      to_a_frags(pa[j], s[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o_acc, pa[j][kk], desc(v0 + j * TILE + 2048 * kk));
      wgmma_commit();
      wgmma_wait<1>();  // at most two tiles' P in flight: the registers hold no more
    }
    wgmma_wait<0>();
    fence_acc(o_acc);
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    // the block's partial O, staged row-major: the first warpgroup's, then
    // the second adds its own, and each owner's rows go to it in one bulk copy
    float* stage = sm.at(Smem::STAGE + slot * Smem::STAGE_SLOT);
    const int r0 = warp * 16 + g;
    if (wg == 0) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<float2*>(stage + (r0 + 8 * rh) * ROW + 8 * n + 2 * t) =
              make_float2(o_acc[4 * n + 2 * rh], o_acc[4 * n + 2 * rh + 1]);
        }
        if (t == 0) stage[(r0 + 8 * rh) * ROW + 64] = l[rh];
      }
      named_arrive(1, 2 * CONSUMERS);
      continue;
    }
    named_sync(1, 2 * CONSUMERS);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float2* at = reinterpret_cast<float2*>(stage + (r0 + 8 * rh) * ROW + 8 * n + 2 * t);
        const float2 w = *at;
        *at = make_float2(w.x + o_acc[4 * n + 2 * rh], w.y + o_acc[4 * n + 2 * rh + 1]);
      }
      if (t == 0) stage[(r0 + 8 * rh) * ROW + 64] += l[rh];
    }
    fence_proxy_async();  // the bulk copies read what these threads wrote
    named_sync(2, CONSUMERS);
    if (tid < ranks) {
      const int first = tid * rows_per, rows = min(T, first + rows_per) - first;
      const uint32_t recv = sm.base + Smem::RECV + slot * Smem::RECV_SLOT + rank * rows_per * ROW * 4;
      bulk_to_peer(peer_addr(recv, tid), sm.base + Smem::STAGE + slot * Smem::STAGE_SLOT + first * ROW * 4,
                   rows * ROW * 4, peer_addr(sm.o_bar(slot), tid));
    }
  }
  if (wg == 0 && mine > 0) finish(mine - 1);
  cluster_arrive();  // no block leaves while another may still store into it
  cluster_wait();
}

// Clusters of `ranks` blocks that can be resident at once on this device,
// asked once for each (device, ranks).
int active_clusters(int ranks, cudaStream_t stream) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto found = known.find({dev, ranks});
  if (found != known.end()) return found->second;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1, 1);
  cfg.blockDim = dim3(BLOCK, 1, 1);
  cfg.dynamicSmemBytes = Smem::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, single_kernel, &cfg) != cudaSuccess) return 0;
  known[{dev, ranks}] = n;
  return n;
}

// Groups of q tiles a (batch, head): the fewest waves of clusters times the
// tiles a cluster walks plus one for its K/V load, the smallest such count.
int pick_groups(int q_tiles, int heads, int clusters) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= q_tiles; ++g) {
    const long long waves = ((long long)g * heads + clusters - 1) / clusters;
    const long long cost = waves * ((q_tiles + g - 1) / g + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
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
  const int ranks = (Sk + KEYS - 1) / KEYS;
  if (Sk < 1 || Sq < 1 || ranks > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!(map_rows(&mq, q, B, H, Sq, st) && map_rows(&mk, k, B, H, Sk, st + 3) &&
        map_rows(&mv, v, B, H, Sk, st + 6))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(single_kernel), Smem::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int clusters = active_clusters(ranks, s);
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const int q_tiles = (Sq + T - 1) / T;
  const int groups = pick_groups(q_tiles, B * H, clusters);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * groups, H, B);
  cfg.blockDim = dim3(BLOCK, 1, 1);
  cfg.dynamicSmemBytes = Smem::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, single_kernel, mq, mk, mv, static_cast<bf16*>(o), Sq, Sk,
                           groups, st[9], st[10], st[11], sm_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
