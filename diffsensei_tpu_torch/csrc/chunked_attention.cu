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
// What bounds it on the H100: the same work as B1 (4 Sq Sk 64 operations,
// each operand read once), so at the experiment's shapes (1024..16384 keys)
// the tensor cores and, at head_dim 64, the exponentials. C is the knob the
// experiment turns; the TPU's 1024 x 2048 blocks do not fit a block's 227 KB
// of shared memory (K and V of one block are 512 KB), so the kernel picks its
// own tiles and honours C alone:
//   * a block is one consumer warpgroup of 64 q rows and a producer warp
//     (hopper.cuh); for each chunk the producer streams its C / 64 K tiles,
//     then its C / 64 V tiles, through a four-slot ring;
//   * pass 1 of a chunk: S = Q K^T a 64-key tile at a time (wgmma, both
//     operands in shared memory), scaled into log2 units, its row max taken
//     and the tile parked in shared memory: the chunk's 64 x C fp32 scores
//     are 256 C bytes (64 KB at C = 256, 128 KB at 512), which no register
//     file holds past C = 128; at C = 1024 they are 256 KB, beyond a block's
//     227 KB, so that chunk is refused;
//   * then the chunk's update: m_new, corr = 2^(m - m_new), l and O rescaled;
//   * pass 2: each parked tile is read back, p = 2^(s - m_new) (ex2.approx)
//     summed into l in fp32, rounded to bf16 as the A operand of O += P V
//     (wgmma, A in registers, V through the transpose bit).
// Each product waits for its own result: no overlap of the exponentials with
// the tensor cores (B1 has it). Each block owns its rows: two calls give the
// same bits. Rows past Sq read zeros and are not written; Sk is a multiple of
// C (the caller's asserts), so no key tile is ragged.

#include "hopper.cuh"

namespace {

using namespace hop;

constexpr int STAGES = 4;  // slots of the K/V ring

// Q tile, the ring, the chunk's parked scores, then the barriers.
template <int C>
struct Smem {
  static constexpr uint32_t SCORES = T * C * 4;
  static constexpr uint32_t BARS = TILE + STAGES * TILE + SCORES;
  static constexpr size_t BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;
  uint32_t base;  // shared-window address, 1024-aligned: the Q tile
  unsigned char* ptr;
  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023u) & ~1023u;
    ptr = raw + (base - r);
  }
  __device__ uint32_t ring() const { return base + TILE; }
  __device__ float* scores() const { return reinterpret_cast<float*>(ptr + TILE + STAGES * TILE); }
  __device__ uint32_t bar0() const { return base + BARS; }
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
__global__ void __launch_bounds__(THREADS)
chunked_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int Sq, int Sk,
               long long sob, long long soh, long long sos, float sm_scale) {
  constexpr int SUB = C / T;  // 64-key tiles a chunk
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int q_start = blockIdx.x * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int chunks = Sk / C;
  init_ring(sm.bar0(), STAGES, CONSUMERS);
  Ring<STAGES> ring(sm.ring(), sm.bar0());

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(sm.bar0(), TILE);
      tma_4d(sm.base, &tm_q, sm.bar0(), 0, q_start, h, b);
      for (int c = 0; c < chunks; ++c) {
        for (int j = 0; j < SUB; ++j) ring.load(&tm_k, c * C + j * T, h, b);
        for (int j = 0; j < SUB; ++j) ring.load(&tm_v, c * C + j * T, h, b);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units
  float m[2] = {-1e30f * LOG2E, -1e30f * LOG2E};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o_acc[32], s[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int x = 0; x < 32; ++x) o_acc[x] = 0.f;
  float* scratch = sm.scores();
  mbar_wait(sm.bar0(), 0);

  for (int c = 0; c < chunks; ++c) {
    float mx[2] = {-1e30f * LOG2E, -1e30f * LOG2E};
    for (int j = 0; j < SUB; ++j) {  // pass 1: the chunk's scores and row max
      qk_tile(s, sm.base, ring);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        s[x] *= scale2;
        mx[(x & 3) >> 1] = fmaxf(mx[(x & 3) >> 1], s[x]);
      }
      put_scores(scratch, j, s);
    }
    float corr[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float m_new = fmaxf(m[rh], quad_max(mx[rh]));
      corr[rh] = ex2(m[rh] - m_new);
      m[rh] = m_new;
      l[rh] *= corr[rh];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) o_acc[x] *= corr[(x & 3) >> 1];
    for (int j = 0; j < SUB; ++j) {  // pass 2: P and O += P V
      get_scores(s, scratch, j);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        s[x] = ex2(s[x] - m[(x & 3) >> 1]);
        l[(x & 3) >> 1] += s[x];
      }
      to_a_frags(pa, s);
      pv_tile(o_acc, pa, ring);
    }
  }

  float inv[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float row = quad_sum(l[rh]);
    inv[rh] = 1.f / (row == 0.f ? 1.f : row);
  }
  store_rows(o + b * sob + h * soh, sos, q_start + warp * 16 + g, Sq, o_acc, inv, t);
}

template <int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, const long long* st, float sm_scale, cudaStream_t stream) {
  if (Sk % C != 0 || Sk < C) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!(map_rows(&mq, q, B, H, Sq, st) && map_rows(&mk, k, B, H, Sk, st + 3) &&
        map_rows(&mv, v, B, H, Sk, st + 6))) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = Smem<C>::BYTES;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(chunked_kernel<C>), smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + T - 1) / T, H, B);
  chunked_kernel<C><<<grid, THREADS, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), Sq, Sk,
                                                       st[9], st[10], st[11], sm_scale);
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
