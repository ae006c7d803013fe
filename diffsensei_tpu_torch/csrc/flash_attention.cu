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

// Issue the copy of BN rows of D bf16 starting at row0; rows >= limit are zeros.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride, int row0, int limit) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < BN * PER_ROW; i += NTHREADS) {
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
    __syncthreads();  // this stage is refilled by the copy issued two tiles on
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
