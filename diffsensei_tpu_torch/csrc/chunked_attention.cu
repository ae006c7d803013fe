// k-chunked online-softmax attention for Hopper (sm_90a): kernel B7.
//
// Replaces the Pallas TPU kernel `_chunked_kernel`
// (tools/bench_attention_chunked.py:40, pallas_call at :94, entry
// `chunked_attention:83`), an experiment on B1's design. For q [B, H, Sq, 64]
// and k, v [B, H, Sk, 64], bf16, it computes o = softmax(q k^T / 8) v with
// the running max and sum updated once per chunk of C keys, in the TPU
// kernel's order: s in fp32, m_new = max(m, rowmax s) (m from -1e30),
// p = exp(s - m_new), l = l corr + sum p (fp32 p), acc = acc corr + bf16(p) V
// (fp32), o = acc / l. No bias, no mask, no lse.
//
// What bounds it on the H100: the same work as B1 (4 Sq Sk 64 operations),
// so at the experiment's shapes (1024..16384 keys) the tensor cores and, at
// head_dim 64, the exponentials; and, as for B1, the K and V that every
// q tile streams from L2 (1 MB a tile at 4096 keys). C is the knob the
// experiment turns, and what the TPU experiment asks is whether one chunk's
// exponentials can run under the tensor cores' products. The design:
//   * a 64-row q tile's scores sit in the registers of one consumer
//     warpgroup: the whole chunk up to C = 256 (32, 64 or 128 fp32 a
//     thread); at C = 512 half of it at a time, so a chunk is three score
//     sets: its first half's S for the max alone, then its second half's,
//     which completes the max, then the first half's again (the same bits)
//     for its exponentials, 1.5 times B1's Q K^T. A chunk's max and sum are
//     updated once, over the whole chunk, before any of its exponentials;
//     p = 2^(s log2e / 8 - m) (ex2.approx) is summed into l in fp32 and
//     rounded to bf16 as the A operand of O += P V (V through the
//     transpose bit);
//   * each set's S = Q K^T is issued with the P V of the set before and
//     committed apart from it, and its max, update and exponentials run
//     while both products are on the tensor cores, as B1 does for its
//     tiles: a thread holds one set's scores and the previous set's P (at
//     most 128 + 64 registers);
//   * C = 64 and 128: a block is that one warpgroup and a producer warp
//     that streams K and V through a ring of TMA slots, one box of C keys
//     each, as B1 (3 and 2 blocks an SM);
//   * C = 256 and 512: a block is two warpgroups on two q tiles that
//     ping-pong, as FlashAttention-3 schedules them: a warpgroup issues its
//     products in its turn (named barrier 1 + its index), passes the turn
//     to the other and runs its max and exponentials while the other's
//     products run. Both read one ring of 256-key boxes, half the L2
//     traffic of a tile a block. No producer warp: eight warps leave up to
//     255 registers a thread for the scores, P and O (in B8's builds a
//     ninth warp held ptxas to 168, PERF.md §6). The second warpgroup's
//     first thread refills the ring in its turns, only slots that both
//     have released by then. 1 block an SM.
// Ring slots: as many as fit beside Q at the blocks an SM above. Each block
// owns its rows, no atomics: two calls give the same bits. Rows past Sq read
// zeros and are not written; Sk is a multiple of C (the caller's asserts),
// so no key tile is ragged. A chunk of 1024 keys is refused: it would take
// four passes over its keys, Q K^T 1.75 times.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): 1.02-1.30x B1's
// time by chunk and shape, chunk 512 the slowest; 0 spills.

#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace hop;

template <int C>
struct Plan {
  static constexpr bool PINGPONG = C >= 256;
  static constexpr int WG = PINGPONG ? 2 : 1;            // consumer warpgroups, one q tile each
  static constexpr int NT = PINGPONG ? 4 : C / T;        // 64-key tiles of scores a warpgroup holds
  static constexpr int HALVES = C / (NT * T);            // passes over a chunk's keys: 2 at C = 512
  static constexpr uint32_t ITEM = NT * TILE;            // a ring slot: NT * 64 keys of K or V
  static constexpr int THREADS = WG * CONSUMERS + (PINGPONG ? 0 : 32);
  // the blocks an SM that the registers allow: 108 and 156 a thread at C =
  // 64 and 128 (160 threads), 250 and 255 in the ping-pong (256 threads)
  static constexpr int MIN_BLOCKS = C == 64 ? 3 : C == 128 ? 2 : 1;
  // shared memory from the 1024-aligned base: the Q tiles, the ring, the
  // barriers; as many slots as fit in an SM's 228 KB at MIN_BLOCKS blocks
  // (1 KB of it reserved a block, 1 KB for the alignment)
  static constexpr uint32_t RING = WG * TILE;
  static constexpr int STAGES = (233472 / MIN_BLOCKS - 2048 - RING - 8) / (ITEM + 16);
  static constexpr uint32_t BARS = RING + STAGES * ITEM;
  static constexpr size_t BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(STAGES >= 4, "the ring must run ahead of the products");
};

// Write a 64 x 64 accumulator times each row's `inv` as bf16 rows row0, row0 + 8 (< Sq).
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row0, int Sq,
                                           const float (&acc)[32], const float (&inv)[2], int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = row0 + 8 * rh;
    if (r >= Sq) continue;
    bf16* out = base + (long long)r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(acc[4 * n + 2 * rh] * inv[rh], acc[4 * n + 2 * rh + 1] * inv[rh]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(Plan<C>::THREADS, Plan<C>::MIN_BLOCKS)
chunked_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int Sq, int Sk,
               long long sob, long long soh, long long sos, float sm_scale) {
  using P = Plan<C>;
  constexpr int NT = P::NT, STAGES = P::STAGES, HALVES = P::HALVES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the Q tiles
  const uint32_t bar0 = base + P::BARS;
  const int q_start = blockIdx.x * P::WG * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int chunks = Sk / C;
  // the ring's sequence, a chunk at a time: its K boxes in key order, then
  // its V boxes in the opposite order (the order the score sets read them)
  const int items = chunks * 2 * HALVES;
  init_ring(bar0, STAGES, P::WG * CONSUMERS);  // each box is read by every warpgroup

  Ring<STAGES, P::ITEM> ring(base + P::RING, bar0);
  auto load_to = [&](int limit) {
    for (limit = min(limit, items); ring.i < limit;) {
      const int within = ring.i % (2 * HALVES);
      const int half = within < HALVES ? within : 2 * HALVES - 1 - within;
      ring.load(within < HALVES ? &tm_k : &tm_v, ring.i / (2 * HALVES) * C + half * NT * T, h, b);
    }
  };
  if (threadIdx.x == CONSUMERS) {  // the q tiles that start inside Sq
    const int tiles = min(P::WG, (Sq - q_start + T - 1) / T);
    mbar_expect_tx(bar0, tiles * TILE);
    for (int w = 0; w < tiles; ++w) tma_4d(base + w * TILE, &tm_q, bar0, 0, q_start + w * T, h, b);
    // the producer warp: every box, each as its slot frees; in the
    // ping-pong the first STAGES, the others at the second warpgroup's turns
    load_to(P::PINGPONG ? STAGES : items);
  }
  if (threadIdx.x >= P::WG * CONSUMERS) return;

  const int wg = threadIdx.x / CONSUMERS;
  const int tid = threadIdx.x % CONSUMERS;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_tile = base + wg * TILE;
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units
  // the boxes of chunk c's keys half * NT * 64.., in the ring's sequence
  auto k_item = [&](int c, int half) { return c * 2 * HALVES + half; };
  auto v_item = [&](int c, int half) { return c * 2 * HALVES + 2 * HALVES - 1 - half; };
  auto slot = [&](int i) { return base + P::RING + (i % STAGES) * P::ITEM; };
  auto wait_item = [&](int i) { mbar_wait(bar0 + 8 * (1 + i % STAGES), (i / STAGES) & 1); };
  auto release = [&](int i) { mbar_arrive(bar0 + 8 * (1 + STAGES + i % STAGES)); };

  float s[NT][32], o_acc[32];
  uint32_t pa[NT][4][4];
  float m[2] = {-1e30f * LOG2E, -1e30f * LOG2E};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float corr[2], neg_m[2];
#pragma unroll
  for (int x = 0; x < 32; ++x) o_acc[x] = 0.f;
  mbar_wait(bar0, 0);

  // S = Q K^T of the box's NT tiles: one commit. In the ping-pong Q's
  // descriptors are made anew each time from an opaque copy of its address:
  // hoisted, the four took 8 registers for the whole loop, and at C = 512
  // ptxas spilled them (at C = 64 making them anew cost time).
  auto qk = [&](int i) {
    wait_item(i);
    uint32_t qa = q_tile;
    if constexpr (P::PINGPONG) asm volatile("mov.u32 %0, %1;" : "=r"(qa) : "r"(q_tile));
#pragma unroll
    for (int j = 0; j < NT; ++j) drop_acc(s[j]);
    wgmma_fence();
    if constexpr (NT == 4) {  // one m64n256 product a k-step
      float(&wide)[128] = *reinterpret_cast<float(*)[128]>(&s[0][0]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(wide, desc(qa + 32 * kk), desc(slot(i) + 32 * kk), kk);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(s[j], desc(qa + 32 * kk), desc(slot(i) + j * TILE + 32 * kk), kk);
      }
    }
    wgmma_commit();
  };
  auto fence_scores = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_acc(s[j]);
  };
  // the max of this thread's rows over the scores in s, folded into mx
  auto fold_max = [&](float (&mx)[2]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int x = 0; x < 32; ++x) mx[(x & 3) >> 1] = fmaxf(mx[(x & 3) >> 1], s[j][x]);
    }
  };
  // the chunk's row max: the running max and sum updated once (corr), and
  // the exponent's offset
  auto update = [&](float (&mx)[2]) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float m_new = fmaxf(m[rh], quad_max(mx[rh]) * scale2);
      corr[rh] = ex2(m[rh] - m_new);
      m[rh] = m_new;
      l[rh] *= corr[rh];
      neg_m[rh] = -m_new;
    }
  };
  auto exps = [&](int j) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int rh = (x & 3) >> 1;
      s[j][x] = ex2(fmaf(s[j][x], scale2, neg_m[rh]));
      l[rh] += s[j][x];
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int x = 0; x < 32; ++x) o_acc[x] *= corr[(x & 3) >> 1];
  };
  // O += P V of the box's NT tiles (not committed)
  auto pv = [&](int i) {
    wait_item(i);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o_acc, pa[j][kk], desc(slot(i) + j * TILE + 2048 * kk));
    }
  };

  // A chunk's score sets, one Q K^T each: the chunk at C <= 256; at 512 its
  // first half for the max alone, then its second half and its first again.
  // The set at SETS / 2 completes the chunk's max; it and those after it
  // take their exponentials.
  constexpr int SETS = HALVES == 1 ? 1 : 3;
  // The ping-pong's turns: a warpgroup issues its products in its turn
  // (named barrier 1 + its index), passes the turn to the other and waits
  // for them while the other's products run; the first warpgroup's turn
  // comes first, and the second does not pass its last turn on. Without the
  // ping-pong a turn is the products alone.
  const int sections = chunks * SETS + 1;
  int section = 0;  // this warpgroup's turns so far
  if (P::PINGPONG && wg == 1) named_arrive(1, 2 * CONSUMERS);
  // the prefix of the ring's sequence each warpgroup has released after n
  // turns: a turn releases its set's K box (not the first set's at C = 512)
  // and the V box of the P V it issued
  auto freed = [](int n) {
    return HALVES == 1 ? max(2 * n - 1, 0) : n % 3 == 0 ? max(4 * (n / 3) - 1, 0) : 4 * (n / 3);
  };
  auto turn = [&](auto&& products) {
    if constexpr (P::PINGPONG) named_sync(1 + wg, 2 * CONSUMERS);
    products();
    if constexpr (P::PINGPONG) {
      if (++section < sections || wg == 0) named_arrive(2 - wg, 2 * CONSUMERS);
      // the second warpgroup's turn begins once the first has passed on
      // the same turn, after it has ended the ones before: both have
      // released freed(section - 1), and its first thread refills those slots
      if (threadIdx.x == CONSUMERS) load_to(freed(section - 1) + STAGES);
    }
  };

  // Each set's S is issued with the P V of the set before (chunk c + 1's S
  // with chunk c's P V at C <= 256), committed apart, and its max, update and
  // exponentials run while both products are on the tensor cores, as B1
  // does for its tiles: a thread holds one set's scores and the previous
  // set's P. Which products a turn issues is fixed at compile time (SET,
  // WITH_PV): ptxas serializes wgmmas under a branch it cannot resolve.
  float mx[2];  // the chunk's row maxima so far
  auto step = [&](int c, auto set_, auto with_pv_) {
    constexpr int SET = decltype(set_)::value;
    constexpr bool WITH_PV = decltype(with_pv_)::value;
    constexpr int HALF = SET == 1 ? 1 : 0;
    // the V box of the set before: the previous chunk's last, or at C = 512
    // this chunk's second half
    const int prev_v = SET == 0 ? v_item(c - 1, 0) : v_item(c, 1);
    turn([&] {
      qk(k_item(c, HALF));
      if constexpr (WITH_PV) {
        pv(prev_v);
        wgmma_commit();
      }
    });
    if constexpr (WITH_PV) {
      wgmma_wait<1>();  // the S of this set
    } else {
      wgmma_wait<0>();
    }
    fence_scores();
    if constexpr (SET >= SETS / 2) release(k_item(c, HALF));
    if constexpr (SET == 0) mx[0] = mx[1] = -1e30f;
    if constexpr (SET <= SETS / 2) fold_max(mx);
    if constexpr (SET == SETS / 2) update(mx);
    if constexpr (SET >= SETS / 2) {
#pragma unroll
      for (int j = 0; j < NT; ++j) exps(j);
    }
    if constexpr (WITH_PV) {  // the P V before: its slot is free, and pa may change
      wgmma_wait<0>();
      fence_acc(o_acc);
      release(prev_v);
    }
    if constexpr (SET == SETS / 2) rescale();
    if constexpr (SET >= SETS / 2) {
#pragma unroll
      for (int j = 0; j < NT; ++j) to_a_frags(pa[j], s[j]);
    }
  };
  const std::integral_constant<int, 0> first;
  const std::integral_constant<int, 1> second;
  const std::integral_constant<int, 2> third;
  const std::true_type with_pv;
  const std::false_type alone;
  if constexpr (SETS == 1) {
    step(0, first, alone);
    for (int c = 1; c < chunks; ++c) step(c, first, with_pv);
  } else {
    step(0, first, alone);
    step(0, second, alone);
    step(0, third, with_pv);
    for (int c = 1; c < chunks; ++c) {
      step(c, first, with_pv);
      step(c, second, alone);
      step(c, third, with_pv);
    }
  }
  turn([&] {  // the last P V
    pv(v_item(chunks - 1, 0));
    wgmma_commit();
  });
  wgmma_wait<0>();
  fence_acc(o_acc);
  release(v_item(chunks - 1, 0));

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) l[rh] = quad_sum(l[rh]);
  float inv[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) inv[rh] = 1.f / (l[rh] == 0.f ? 1.f : l[rh]);
  store_rows(o + b * sob + h * soh, sos, q_start + wg * T + warp * 16 + g, Sq, o_acc, inv, t);
}

template <int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, const long long* st, float sm_scale, cudaStream_t stream) {
  if (Sk % C != 0 || Sk < C) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  constexpr int box = Plan<C>::NT * T;  // a ring slot's keys
  if (!(map_rows(&mq, q, B, H, Sq, st) && map_rows(&mk, k, B, H, Sk, st + 3, box) &&
        map_rows(&mv, v, B, H, Sk, st + 6, box))) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = Plan<C>::BYTES;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(chunked_kernel<C>), smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + Plan<C>::WG * T - 1) / (Plan<C>::WG * T), H, B);
  chunked_kernel<C><<<grid, Plan<C>::THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), Sq, Sk, st[9], st[10], st[11], sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. q [B, H, Sq, 64], k and v [B, H, Sk, 64],
// o [B, H, Sq, 64], all bf16; `strides` holds 12 element strides, (b, h, s)
// of q, k, v and o (the last dim has stride 1; q, k and v are read by TMA, so
// 16-byte aligned with strides divisible by 8). `chunk` is 64, 128, 256 or 512
// keys and divides Sk. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for another chunk or where a map cannot be encoded).
extern "C" int diffsensei_chunked_attention(const void* q, const void* k, const void* v, void* o,
                                            int B, int H, int Sq, int Sk,
                                            const long long* strides, int chunk, float sm_scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 64: return (int)launch<64>(q, k, v, o, B, H, Sq, Sk, strides, sm_scale, s);
    case 128: return (int)launch<128>(q, k, v, o, B, H, Sq, Sk, strides, sm_scale, s);
    case 256: return (int)launch<256>(q, k, v, o, B, H, Sq, Sk, strides, sm_scale, s);
    case 512: return (int)launch<512>(q, k, v, o, B, H, Sq, Sk, strides, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
