// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd_kernel_bias`
// (diffsensei_tpu/ops/flash_attention.py:59,124, pallas_call at :162).
// Computes O = softmax(scale * Q K^T + bias) V over [B, H, S, D] and the row
// log-sum-exp lse[B, H, Sq] (fp32, without the TPU kernel's 8-lane padding).
//
// What bounds it on the H100: at the UNet's shapes (S = 1024..4096, D = 64)
// attention is compute bound (4*S*D flops per score, 2 bytes per element
// read once per q tile), so the limit is the tensor cores and keeping them
// fed. The design:
//   * one block of 4 warps per (64-row q tile, head, batch); each warp owns 16
//     q rows, so the online-softmax state of a row never leaves its warp;
//   * products run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulate). Q's fragments, the scores, the probabilities and the O
//     accumulator stay in registers: a score tile's accumulator layout is the
//     next product's A-operand layout, so P never touches shared memory;
//   * K/V tiles of 64 keys stream through two shared-memory stages with
//     cp.async, so the next tile's load overlaps this tile's math;
//   * the running max and sum are fp32 per row (exp2 with log2(e) folded into
//     the scale); the row sum is reduced across its four lanes once, at the end.
// Ragged tails: out-of-range K and V rows are zero-filled by cp.async and
// their scores masked, out-of-range Q rows are zeros and never written, so no
// tile size has to divide Sq or Sk. An optional additive fp32 bias
// [B|1, H|1, Sq, Sk] is read through its strides (a broadcast dim has stride
// 0, nothing is expanded), and `causal` masks cols > rows and skips the K/V
// tiles above the diagonal. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;         // q rows per block
constexpr int BN = 64;         // keys per K/V tile
constexpr int NWARPS = 4;      // 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;  // row pitch (elements): 16-byte rows, no bank conflicts
  static constexpr int TILE = BN * LDH;
  static constexpr size_t bytes = sizeof(bf16) * (BM * LDH + 4 * TILE);  // Q, 2 x (K, V)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid == false` zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of ROWS rows of D bf16 from row0 on; rows >= limit are zeros.
template <int D, int ROWS = BN>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride, int row0, int limit) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const bool valid = row0 + r < limit;
    const bf16* g = src + (valid ? (long long)(row0 + r) * row_stride + c : 0);
    cp_async16(dst + r * Layout<D>::LDH + c, g, valid);
  }
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// Fragment coordinates of mma m16n8k16 for lane = 4*g + t:
//   A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk,
                 long long sqb, long long sqh, long long sqs,
                 long long skb, long long skh, long long sks,
                 long long svb, long long svh, long long svs,
                 long long sob, long long soh, long long sos,
                 long long sbb, long long sbh, long long sbq,
                 int causal, float sm_scale) {
  using L = Layout<D>;
  constexpr int LDH = L::LDH;
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NT = BN / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;    // 8-wide column tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BM * LDH;   // stage s: K at sKV + 2s*TILE, V at sKV + (2s+1)*TILE

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_start = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qp = q + b * sqb + h * sqh;
  const bf16* kp = k + b * skb + h * skh;
  const bf16* vp = v + b * svb + h * svh;
  const float* bp = bias == nullptr ? nullptr : bias + b * sbb + h * sbh;

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) {
    // tiles whose first key lies above the block's last row are all masked
    const int last = (q_start + BM - 1) / BN + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  // Q and the first K/V tile in flight together
  load_tile_async<D>(sQ, qp, sqs, q_start, Sq);
  load_tile_async<D>(sKV, kp, sks, 0, Sk);
  load_tile_async<D>(sKV + L::TILE, vp, svs, 0, Sk);
  cp_async_commit();

  const float scale2 = sm_scale * LOG2E;   // scores in log2 units
  const int row0 = q_start + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                   // this lane's partial row sums
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qa[KD][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      bf16* next = sKV + 2 * (stage ^ 1) * L::TILE;
      load_tile_async<D>(next, kp, sks, (tile + 1) * BN, Sk);
      load_tile_async<D>(next + L::TILE, vp, svs, (tile + 1) * BN, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + 2 * stage * L::TILE;
    const bf16* sV = sK + L::TILE;
    const int k_start = tile * BN;

    if (tile == 0) {
      const bf16* qw = sQ + (warp * 16 + g) * LDH + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        qa[kk][0] = ld_u32(qw + kk * 16);
        qa[kk][1] = ld_u32(qw + 8 * LDH + kk * 16);
        qa[kk][2] = ld_u32(qw + kk * 16 + 8);
        qa[kk][3] = ld_u32(qw + 8 * LDH + kk * 16 + 8);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = sK + (n * 8 + g) * LDH + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma16816(s[n], qa[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
      }
    }

    // scale, bias, masks; running max per row
    float mx[2] = {NEG_INF, NEG_INF};
    const bool full = k_start + BN <= Sk && !causal && bp == nullptr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        float val = s[n][e] * scale2;
        if (!full) {
          const int qi = row0 + 8 * rh;
          const int kj = k_start + n * 8 + 2 * t + (e & 1);
          const bool ok = kj < Sk && (!causal || kj <= qi);
          if (ok && bp != nullptr && qi < Sq) val += bp[(long long)qi * sbq + kj] * LOG2E;
          val = ok ? val : NEG_INF;
        }
        s[n][e] = val;
        mx[rh] = fmaxf(mx[rh], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
      const float m_new = fmaxf(m[rh], mx[rh]);
      corr[rh] = exp2f(m[rh] - m_new);
      m[rh] = m_new;
      l[rh] *= corr[rh];
    }
    // probabilities (0 where masked or where the row has no valid key yet)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        const float p = m[rh] == NEG_INF ? 0.f : exp2f(s[n][e] - m[rh]);
        s[n][e] = p;
        l[rh] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = sV + (kk * 16 + 2 * t) * LDH + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* vc = vr + j * 8;
        mma16816(acc[j], pa, ld_pair(vc, vc + LDH), ld_pair(vc + 8 * LDH, vc + 9 * LDH));
      }
    }
    __syncthreads();  // this stage is refilled by the copy started two tiles on
  }

  // Epilogue: sum each row over its four lanes, write O / l in bf16 and
  // lse = m ln2 + log(l). A row with no valid key gets O = 0 and lse = -1e30,
  // as the TPU kernel's l == 0 guard gives.
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int qi = row0 + 8 * rh;
    if (qi >= Sq) continue;
    const float inv = l[rh] == 0.f ? 0.f : 1.f / l[rh];
    bf16* out = o + b * sob + h * soh + (long long)qi * sos + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[j][2 * rh] * inv, acc[j][2 * rh + 1] * inv);
    }
    if (t == 0) {
      lse[((long long)b * H + h) * Sq + qi] =
          l[rh] == 0.f ? NEG_INF : m[rh] * LN2 + logf(l[rh]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* o, void* lse, int B, int H, int Sq, int Sk,
                   const long long* st, int causal, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], causal, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: kernels B2 (dQ) and B4 (dK, dV)
//
// Replace the Pallas TPU kernels `_dq_kernel` / `_dq_kernel_bias` and
// `_dkv_kernel` / `_dkv_kernel_bias` (diffsensei_tpu/ops/flash_attention.py:196,
// 252, 258, 322; pallas_calls at :379 and :417, called from `_backward:328`).
// With P = exp(scale Q K^T + bias - lse) recomputed from the forward's lse and
// delta = rowsum(dO o O):
//   dS = P o (dO V^T - delta),  dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO.
// B2 does three products per score and B4 four, so at the UNet's shapes both
// are compute bound, like B1. The design keeps B1's: 4 warps of 16 rows,
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators, scores and
// probabilities in registers (an accumulator tile is the next product's A
// operand), cp.async double buffering of the streamed tiles. Each block owns
// its output rows and sums over the other axis in a loop, so there are no
// float atomics: two calls give the same bits.
//   * B2: one block per (64-row q tile, head, batch) streams K/V tiles. It
//     also computes delta for its rows (the TPU code does it in XLA first)
//     and writes it out for B4, which runs after it on the same stream.
//   * B4: one block per (64-key tile, head, batch) streams Q/dO tiles with
//     their lse and delta; each warp owns 16 keys, so S^T = K Q^T puts the
//     keys on the accumulator rows and P^T, dS^T feed dV and dK directly.
// P and dS are rounded to bf16 for the tensor cores (the TPU dQ kernel also
// takes dS in bf16; its dK/dV products are fp32). Ragged tails and causal
// blocks are masked as in B1, the bias read through its strides; the bias
// gets no gradient. head_dim 128 halves the streamed tile to keep registers.
// ---------------------------------------------------------------------------
template <int D>
struct BwdCfg {
  static constexpr int LDH = D + 8;
  static constexpr int TILE = D == 128 ? 32 : 64;  // streamed rows per step
};

// Element strides (batch, head, row) of every operand; bias strides of a
// broadcast dim are 0.
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3], bias[3];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// A fragments (16 rows x D) of a row-major tile in shared memory, rows r0..r0+15.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* tile,
                                             int r0, int g, int t) {
  constexpr int LDH = BwdCfg<D>::LDH;
  const bf16* p = tile + (r0 + g) * LDH + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld_u32(p + kk * 16);
    a[kk][1] = ld_u32(p + 8 * LDH + kk * 16);
    a[kk][2] = ld_u32(p + kk * 16 + 8);
    a[kk][3] = ld_u32(p + 8 * LDH + kk * 16 + 8);
  }
}

// acc[n] (16 x 8 per n) += A (16 x D) B^T, B's rows n*8.. in a row-major tile.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int g, int t) {
  constexpr int LDH = BwdCfg<D>::LDH;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bf16* r = tile + (n * 8 + g) * LDH + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma16816(acc[n], a[kk], ld_u32(r + kk * 16), ld_u32(r + kk * 16 + 8));
    }
  }
}

// out (16 x D) += X (16 x K, fp32 accumulator tiles, rounded to bf16) B, with B
// the row-major tile [K, D]: the accumulator layout is the A operand layout.
template <int D, int NT>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4], const float (&x)[NT][4],
                                       const bf16* tile, int g, int t) {
  constexpr int LDH = BwdCfg<D>::LDH;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const bf16* r = tile + (kk * 16 + 2 * t) * LDH + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const bf16* c = r + j * 8;
      mma16816(out[j], xa, ld_pair(c, c + LDH), ld_pair(c + 8 * LDH, c + 9 * LDH));
    }
  }
}

// Store 16 x D fp32 accumulators (times `mul`) as bf16 rows row0, row0 + 8.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row0,
                                           int limit, const float (&acc)[D / 8][4],
                                           float mul, int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = row0 + 8 * rh;
    if (r >= limit) continue;
    bf16* out = base + (long long)r * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[j][2 * rh] * mul, acc[j][2 * rh + 1] * mul);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * BM + 4 * BwdCfg<D>::TILE) * BwdCfg<D>::LDH + sizeof(float) * BM;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ bias, bf16* __restrict__ dq,
                    float* __restrict__ delta, int H, int Sq, int Sk, BwdStrides st,
                    int causal, float sm_scale) {
  constexpr int LDH = BwdCfg<D>::LDH;
  constexpr int BK = BwdCfg<D>::TILE;  // keys per K/V tile
  constexpr int TILE = BK * LDH;
  constexpr int NT = BK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LDH;
  bf16* sKV = sdO + BM * LDH;  // stage s: K at sKV + 2s*TILE, V at sKV + (2s+1)*TILE
  float* sDelta = reinterpret_cast<float*>(sKV + 4 * TILE);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_start = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qp = q + b * st.q[0] + h * st.q[1];
  const bf16* kp = k + b * st.k[0] + h * st.k[1];
  const bf16* vp = v + b * st.v[0] + h * st.v[1];
  const bf16* op = o + b * st.o[0] + h * st.o[1];
  const bf16* dop = dout + b * st.dout[0] + h * st.dout[1];
  const float* bp = bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  const long long stat = ((long long)b * H + h) * Sq;  // lse / delta row offset

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = (q_start + BM - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  load_tile_async<D, BM>(sQ, qp, st.q[2], q_start, Sq);
  load_tile_async<D, BM>(sdO, dop, st.dout[2], q_start, Sq);
  load_tile_async<D, BK>(sKV, kp, st.k[2], 0, Sk);
  load_tile_async<D, BK>(sKV + TILE, vp, st.v[2], 0, Sk);
  cp_async_commit();

  // delta = rowsum(dO o O) in fp32 for the block's rows, one warp a row
  for (int r = warp; r < BM; r += NWARPS) {
    const int qi = q_start + r;
    float acc = 0.f;
    if (qi < Sq) {
      const bf16* orow = op + (long long)qi * st.o[2];
      const bf16* drow = dop + (long long)qi * st.dout[2];
      for (int c = lane; c < D; c += 32) {
        acc += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sDelta[r] = acc;
      if (qi < Sq) delta[stat + qi] = acc;
    }
  }

  const float scale2 = sm_scale * LOG2E;
  const int row0 = q_start + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float lse2[2], dl[2];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qa[D / 16][4], da[D / 16][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      bf16* next = sKV + 2 * (stage ^ 1) * TILE;
      load_tile_async<D, BK>(next, kp, st.k[2], (tile + 1) * BK, Sk);
      load_tile_async<D, BK>(next + TILE, vp, st.v[2], (tile + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + 2 * stage * TILE;
    const bf16* sV = sK + TILE;
    const int k_start = tile * BK;

    if (tile == 0) {
      load_a_frags<D>(qa, sQ, warp * 16, g, t);
      load_a_frags<D>(da, sdO, warp * 16, g, t);
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int qi = row0 + 8 * rh;
        lse2[rh] = qi < Sq ? lse[stat + qi] * LOG2E : 0.f;
        dl[rh] = sDelta[warp * 16 + g + 8 * rh];
      }
    }

    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, qa, sK, g, t);   // S = Q K^T
    mma_abt<D, NT>(dp, da, sV, g, t);  // dP = dO V^T

    // dS = P o (dP - delta), P = exp(scale S + bias - lse), 0 where masked
    const bool full = k_start + BK <= Sk && q_start + BM <= Sq && !causal && bp == nullptr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        float val = s[n][e] * scale2;
        bool ok = true;
        if (!full) {
          const int qi = row0 + 8 * rh;
          const int kj = k_start + n * 8 + 2 * t + (e & 1);
          ok = qi < Sq && kj < Sk && (!causal || kj <= qi);
          if (ok && bp != nullptr) val += bp[(long long)qi * st.bias[2] + kj] * LOG2E;
        }
        const float p = ok ? exp2f(val - lse2[rh]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[rh]);
      }
    }
    mma_xb<D, NT>(acc, s, sK, g, t);  // dQ += dS K
    __syncthreads();  // this stage is refilled by the copy started two tiles on
  }

  store_rows<D>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], row0, Sq, acc, sm_scale, t);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * BN + 4 * BwdCfg<D>::TILE) * BwdCfg<D>::LDH +
         sizeof(float) * 4 * BwdCfg<D>::TILE;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, BwdStrides st,
                     int causal, float sm_scale) {
  constexpr int LDH = BwdCfg<D>::LDH;
  constexpr int BQ = BwdCfg<D>::TILE;  // q rows per Q/dO tile
  constexpr int TILE = BQ * LDH;
  constexpr int NT = BQ / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LDH;
  bf16* sQD = sV + BN * LDH;  // stage s: Q at sQD + 2s*TILE, dO at sQD + (2s+1)*TILE
  float* sStat = reinterpret_cast<float*>(sQD + 4 * TILE);  // stage s: lse2, delta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_start = blockIdx.x * BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qp = q + b * st.q[0] + h * st.q[1];
  const bf16* kp = k + b * st.k[0] + h * st.k[1];
  const bf16* vp = v + b * st.v[0] + h * st.v[1];
  const bf16* dop = dout + b * st.dout[0] + h * st.dout[1];
  const float* bp = bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  const long long stat = ((long long)b * H + h) * Sq;

  // causal: q tiles whose last row lies above the block's first key are all masked
  const int n_q = (Sq + BQ - 1) / BQ;
  const int first = causal ? k_start / BQ : 0;

  auto load_stage = [&](int stage, int it) {
    bf16* dst = sQD + 2 * stage * TILE;
    load_tile_async<D, BQ>(dst, qp, st.q[2], it * BQ, Sq);
    load_tile_async<D, BQ>(dst + TILE, dop, st.dout[2], it * BQ, Sq);
    float* ss = sStat + 2 * stage * BQ;
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const int qi = it * BQ + i;
      ss[i] = qi < Sq ? lse[stat + qi] * LOG2E : 0.f;
      ss[BQ + i] = qi < Sq ? delta[stat + qi] : 0.f;
    }
  };

  load_tile_async<D, BN>(sK, kp, st.k[2], k_start, Sk);
  load_tile_async<D, BN>(sV, vp, st.v[2], k_start, Sk);
  if (first < n_q) load_stage(0, first);
  cp_async_commit();

  const float scale2 = sm_scale * LOG2E;
  const int key0 = k_start + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  uint32_t ka[D / 16][4], va[D / 16][4];

  for (int it = first; it < n_q; ++it) {
    const int stage = (it - first) & 1;
    if (it + 1 < n_q) {
      load_stage(stage ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQ = sQD + 2 * stage * TILE;
    const bf16* sdO = sQ + TILE;
    const float* sL = sStat + 2 * stage * BQ;
    const float* sD = sL + BQ;
    const int q_start = it * BQ;

    if (it == first) {
      load_a_frags<D>(ka, sK, warp * 16, g, t);
      load_a_frags<D>(va, sV, warp * 16, g, t);
    }

    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, ka, sQ, g, t);    // S^T = K Q^T (keys on rows)
    mma_abt<D, NT>(dp, va, sdO, g, t);  // dP^T = V dO^T

    const bool full = k_start + BN <= Sk && q_start + BQ <= Sq && !causal && bp == nullptr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = key0 + 8 * (e >> 1);
        const int ci = n * 8 + 2 * t + (e & 1);  // q row within the tile
        float val = s[n][e] * scale2;
        bool ok = true;
        if (!full) {
          const int qi = q_start + ci;
          ok = qi < Sq && kj < Sk && (!causal || kj <= qi);
          if (ok && bp != nullptr) val += bp[(long long)qi * st.bias[2] + kj] * LOG2E;
        }
        const float p = ok ? exp2f(val - sL[ci]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sD[ci]);
      }
    }
    mma_xb<D, NT>(dv_acc, s, sdO, g, t);  // dV += P^T dO
    mma_xb<D, NT>(dk_acc, dp, sQ, g, t);  // dK += dS^T Q
    __syncthreads();  // this stage is refilled by the copy started two tiles on
  }
  cp_async_wait<0>();  // a block with no q tile still has its K/V copy in flight

  store_rows<D>(dk + b * st.dk[0] + h * st.dk[1], st.dk[2], key0, Sk, dk_acc, sm_scale, t);
  store_rows<D>(dv + b * st.dv[0] + h * st.dv[1], st.dv[2], key0, Sk, dv_acc, 1.f, t);
}

BwdStrides bwd_strides(const long long* s) {
  BwdStrides st;
  long long* dst[9] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv, st.bias};
  for (int i = 0; i < 9; ++i) {
    for (int j = 0; j < 3; ++j) dst[i][j] = s[3 * i + j];
  }
  return st;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, const void* bias, void* dq,
                      void* delta, int B, int H, int Sq, int Sk, const BwdStrides& st,
                      int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(bias),
      static_cast<bf16*>(dq), static_cast<float*>(delta), H, Sq, Sk, st, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* bias, void* dk,
                       void* dv, int B, int H, int Sq, int Sk, const BwdStrides& st,
                       int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BN - 1) / BN, H, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, st, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. `strides` holds 15 element strides:
// q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s), bias (b, h, q); the last
// dim of every tensor has stride 1. Returns the cudaError_t of the launch.
extern "C" int diffsensei_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int H, int Sq, int Sk, int D, const long long* strides,
    int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(q, k, v, bias, o, lse, B, H, Sq, Sk, strides, causal, sm_scale, s);
  if (D == 128) return (int)launch<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, strides, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// C entry points of the backward. `strides` holds 27 element strides, (b, h, s)
// of q, k, v, o, dout, dq, dk, dv and bias, in that order. The dQ kernel also
// writes delta [B, H, Sq] (fp32), which the dK/dV kernel reads: launch them in
// that order on one stream. Each returns the cudaError_t of its launch.
extern "C" int diffsensei_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* bias, void* dq, void* delta, int B, int H, int Sq,
    int Sk, int D, const long long* strides, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdStrides st = bwd_strides(strides);
  if (D == 64) return (int)launch_dq<64>(q, k, v, o, dout, lse, bias, dq, delta, B, H, Sq, Sk, st, causal, sm_scale, s);
  if (D == 128) return (int)launch_dq<128>(q, k, v, o, dout, lse, bias, dq, delta, B, H, Sq, Sk, st, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int diffsensei_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dk, void* dv, int B, int H, int Sq, int Sk,
    int D, const long long* strides, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdStrides st = bwd_strides(strides);
  if (D == 64) return (int)launch_dkv<64>(q, k, v, dout, lse, delta, bias, dk, dv, B, H, Sq, Sk, st, causal, sm_scale, s);
  if (D == 128) return (int)launch_dkv<128>(q, k, v, dout, lse, delta, bias, dk, dv, B, H, Sq, Sk, st, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
