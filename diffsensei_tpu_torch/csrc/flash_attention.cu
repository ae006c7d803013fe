// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd_kernel_bias`
// (diffsensei_tpu/ops/flash_attention.py:59,124, pallas_call at :162).
// Computes O = softmax(scale * Q K^T + bias) V over [B, H, S, D] and the row
// log-sum-exp lse[B, H, Sq] (fp32, without the TPU kernel's 8-lane padding).
//
// What bounds it on the H100: at the UNet's shapes (S = 1024..4096, D = 64)
// attention is compute bound (4*S*D flops per score, 2 bytes per element
// read once per q tile), and at D = 64 the exponentials weigh about as much
// as the products (the special-function unit does one exp per 256 tensor-core
// flops). So the limit is the tensor cores and the exponentials, and the
// design keeps both busy at once.
//
// head_dim 64, the UNet's, is built for Hopper (namespace `hop` below, the
// parts shared with the backward kernels B2 and B4, on the TMA, mbarrier and
// wgmma primitives of hopper.cuh):
//   * a block is one consumer warpgroup of 64 q rows and a producer warp
//     whose lane 0 loads the Q tile once and streams K/V tiles through a ring
//     with TMA (4-d maps (D, S, H, B) from the caller's strides, 128-byte
//     swizzle, zero fill past S), handed over by full and empty mbarriers. A
//     tile holds 64 keys (3 blocks an SM, a four-stage ring) or, where the
//     caller has many keys, 128 (2 blocks an SM, three stages: fewer steps,
//     wider products). Two consumer warpgroups a block sharing each K/V tile
//     measured slower than either;
//   * S = Q K^T is wgmma m64n64k16 or m64n128k16 with both operands in
//     shared memory. Each step issues the next tile's S and this tile's P V,
//     then computes the next tile's softmax while P V runs, so the
//     exponentials overlap the tensor cores. No condition guards a product's
//     issue and no accumulator is copied while its group runs: either makes
//     ptxas serialize the wgmma groups. The softmax is fp32 in registers with the
//     scale folded into log2 units and ex2.approx.ftz; only tiles that need
//     it (the ragged last tile, causal diagonal tiles, every tile with a
//     bias) take the branch-free mask pass, which adds the bias and writes
//     -inf; a row with no valid key yet exponentiates against 0, so it gives
//     p = 0 and never NaN;
//   * P is repacked from the accumulators to bf16 as the A operand of
//     O += P V (wgmma with A in registers), V read N-contiguous from the same
//     swizzled tile through the transpose bit: nothing is staged by hand.
// head_dim 128 (not on the UNet's path) keeps the earlier design: one block
// of 4 warps per (64-row q tile, head, batch), each warp 16 rows; mma.sync
// m16n8k16 with Q, S, P and O in registers; K/V tiles double-buffered with
// cp.async; exp2 with log2(e) folded into the scale.
// Ragged tails: out-of-range K and V rows are zero-filled and their scores
// masked, out-of-range Q rows are zeros and never written, so no tile size
// has to divide Sq or Sk. An optional additive fp32 bias [B|1, H|1, Sq, Sk]
// is read through its strides (a broadcast dim has stride 0, nothing is
// expanded), and `causal` masks cols > rows and skips the K/V tiles above the
// diagonal. A row with no valid key gets O = 0 and lse = -1e30.

#include "hopper.cuh"

namespace {

constexpr int BM = 64;         // q rows per block
constexpr int BN = 64;         // keys per K/V tile
constexpr int NWARPS = 4;      // 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;  // row pitch (elements): 16-byte rows, no bank conflicts
  static constexpr int TILE = BN * LDH;
  static constexpr size_t bytes = sizeof(bf16) * (BM * LDH + 4 * TILE);  // Q, 2 x (K, V)
};

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
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(flash_fwd_kernel<D>), smem);
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
// B2 does three products per score and B4 four (7 a pair, against 5 for a
// fused pass), so at the UNet's shapes (S = 1024..4096, D = 64) both are bound
// by tensor-core operations. Each block owns its output rows and sums over the
// other axis in a loop, so there are no float atomics: two calls give the
// same bits, which keeps training reproducible. That is why the pass stays
// split in two.
//   * B2: one block per (64-row q tile, head, batch) streams K/V tiles. It
//     also computes delta for its rows (the TPU code does it in XLA first)
//     and writes it out for B4, which runs after it on the same stream.
//   * B4: one block per (64-key tile, head, batch) streams Q/dO tiles with
//     their lse and delta, so S^T = K Q^T puts the keys on the accumulator
//     rows and P^T, dS^T feed dV and dK directly.
// P and dS are rounded to bf16 for the tensor cores (the TPU dQ kernel also
// takes dS in bf16; its dK/dV products are fp32). Ragged tails and causal
// blocks are masked in registers, the bias read through its strides (a row
// of Sk fp32 values is not always a 16-byte multiple, and the bias is not on
// the UNet's path); the bias gets no gradient.
//
// head_dim 64, the UNet's (namespace `hop` below), is built for Hopper:
//   * a block is one consumer warpgroup (the 64 rows it owns) and one
//     producer warp. The producer's lane 0 loads the block's own tiles once
//     and streams the other axis's 64-row tiles through a two-stage ring with
//     TMA (cp.async.bulk.tensor over 4-d maps (D, S, H, B) with the caller's
//     strides, 128-byte swizzle); full and empty mbarriers hand the stages
//     over. TMA's zero fill past S replaces masked copies, and each map
//     dimension is bounded on its own, so no tile reads into the next head;
//   * B4's lse and delta rows arrive in the same stage, by 1-d TMA over the
//     flat [B * H * Sq] arrays (rows past a head's end are masked);
//   * the score products S = Q K^T, dP = dO V^T (or their transposes in B4)
//     are wgmma m64n64k16 with both operands in shared memory (K-major). P
//     and dS are built in registers from the accumulators and repacked to
//     bf16 as the A operand of dQ += dS K, dV += P^T dO and dK += dS^T Q,
//     whose B operand is read from the same swizzled tile through the
//     transpose bit: nothing is staged through shared memory by hand;
//   * S and dP are committed as two wgmma groups, so P = exp2(...) runs on
//     the special-function unit while dP is still in the tensor cores. The
//     exponential is ex2.approx.ftz, and an edge tile's masks are a separate,
//     branch-free pass: with exp2f and the masks inline, every element sat in
//     its own divergent branch, and that step took three quarters of B2;
//   * a block holds about 50 KB of shared memory and a lone producer warp,
//     so `setmaxnreg` would free few registers and is not used; two blocks
//     share an SM, one's exponentials overlapping the other's wgmma. A third
//     stage in the ring measured no faster: the loads are not the limit.
// head_dim 128 (not on the UNet's path) keeps the earlier design: 4 warps of
// 16 rows, mma.sync m16n8k16, cp.async double buffering of 32-row tiles.
// Later work: a deterministic fused pass (dQ summed in a fixed order under a
// semaphore) for 5 products instead of 7, and fp8 operands.
// ---------------------------------------------------------------------------
template <int D>
struct BwdCfg {
  static constexpr int LDH = D + 8;
  static constexpr int TILE = 32;  // streamed rows per step (built for head_dim 128 only)
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
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>), smem);
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
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(flash_bwd_dkv_kernel<D>), smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BN - 1) / BN, H, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, st, causal, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head_dim 64 on Hopper: wgmma, TMA and mbarriers (see the note above)
// ---------------------------------------------------------------------------
namespace hop {

constexpr int STAGES = 2;                    // ring of streamed tiles (3 measured no faster)
constexpr uint32_t STAT = 2 * T * 4;         // lse and delta of a stage's 64 rows
// tiles (2 resident + 2 a stage), B4's stats, 2 * STAGES + 1 barriers, and
// slack to align the base to the 1024 bytes of the swizzle pattern
constexpr size_t SMEM = (2 + 2 * STAGES) * TILE + STAGES * STAT + 8 * (2 * STAGES + 1) + 1024;

// The masks of an edge tile on scores s (log2 units; the layout of
// `to_a_frags`, rows from row0, columns from col0 = tile start + 2t): add the
// bias (log2 units) and set -inf where the (q, key) pair is out of range or
// above the causal diagonal. KEYS_ON_ROWS: rows are keys (B4), else q rows
// (B2). Branch-free: the bias is read at a clamped in-range address and the
// mask applied by a select, so no element sits behind a divergent branch.
template <bool KEYS_ON_ROWS, int N>
__device__ __forceinline__ void mask_tile(float (&s)[N], int row0, int col0, int Sq, int Sk,
                                          int causal, const float* bp, long long bias_row) {
  if (bp != nullptr) {
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int r = row0 + 8 * ((x & 3) >> 1), c = col0 + 8 * (x >> 2) + (x & 1);
      const int qi = min(KEYS_ON_ROWS ? c : r, Sq - 1), kj = min(KEYS_ON_ROWS ? r : c, Sk - 1);
      s[x] += __ldg(bp + (long long)qi * bias_row + kj) * LOG2E;
    }
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = row0 + 8 * ((x & 3) >> 1), c = col0 + 8 * (x >> 2) + (x & 1);
    const int qi = KEYS_ON_ROWS ? c : r, kj = KEYS_ON_ROWS ? r : c;
    const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi);
    s[x] = ok ? s[x] : __int_as_float(0xff800000);  // -inf
  }
}

// Store a 64 x 64 accumulator (times `mul`) as bf16 rows row0, row0 + 8 (< limit).
__device__ __forceinline__ void store_acc(bf16* base, long long row_stride, int row0, int limit,
                                          const float (&acc)[32], float mul, int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = row0 + 8 * rh;
    if (r >= limit) continue;
    bf16* out = base + (long long)r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(acc[4 * n + 2 * rh] * mul, acc[4 * n + 2 * rh + 1] * mul);
    }
  }
}

// Barriers after the tiles and stats: [0] the block's own tiles, [1 + s] stage
// s full, [1 + STAGES + s] stage s empty.
struct Smem {
  uint32_t base;       // shared-window address, 1024-aligned
  unsigned char* ptr;  // the same byte, generic
  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023u) & ~1023u;
    ptr = raw + (base - r);
  }
  __device__ uint32_t tile(int i) const { return base + i * TILE; }
  __device__ uint32_t stat(int s) const { return base + (2 + 2 * STAGES) * TILE + s * STAT; }
  __device__ uint32_t bar(int i) const { return stat(STAGES) + 8 * i; }
  __device__ const float* stat_ptr(int s) const {
    return reinterpret_cast<const float*>(ptr + (stat(s) - base));
  }
};

__device__ __forceinline__ void init_barriers(const Smem& sm) { init_ring(sm.bar(0), STAGES, CONSUMERS); }

// B2: dQ for 64 q rows, K/V tiles streamed. Tiles: 0 Q, 1 dO, 2 + 2s K, 3 + 2s V.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const bf16* __restrict__ o, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ bias,
              bf16* __restrict__ dq, float* __restrict__ delta, int H, int Sq, int Sk,
              BwdStrides st, int causal, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int q_start = blockIdx.x * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int n_tiles = (Sk + T - 1) / T;
  if (causal) {
    const int last = (q_start + T - 1) / T + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  init_barriers(sm);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(sm.bar(0), 2 * TILE);
      tma_4d(sm.tile(0), &tm_q, sm.bar(0), 0, q_start, h, b);
      tma_4d(sm.tile(1), &tm_do, sm.bar(0), 0, q_start, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(sm.bar(1 + STAGES + s), (i / STAGES - 1) & 1);
        mbar_expect_tx(sm.bar(1 + s), 2 * TILE);
        tma_4d(sm.tile(2 + 2 * s), &tm_k, sm.bar(1 + s), 0, i * T, h, b);
        tma_4d(sm.tile(3 + 2 * s), &tm_v, sm.bar(1 + s), 0, i * T, h, b);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const long long stat = ((long long)b * H + h) * Sq;
  const float* bp = bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];

  // delta = rowsum(dO o O) for this thread's rows, columns 16t..16t+15, summed
  // over the row's four threads; lse in log2 units
  float dl[2], lse2[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int qi = row0 + 8 * rh;
    float acc = 0.f;
    lse2[rh] = 0.f;
    if (qi < Sq) {
      const uint4* op = reinterpret_cast<const uint4*>(
          o + b * st.o[0] + h * st.o[1] + (long long)qi * st.o[2] + 16 * t);
      const uint4* dp = reinterpret_cast<const uint4*>(
          dout + b * st.dout[0] + h * st.dout[1] + (long long)qi * st.dout[2] + 16 * t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint4 ov = op[j], dv = dp[j];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          acc += of.x * df.x + of.y * df.y;
        }
      }
      lse2[rh] = lse[stat + qi] * LOG2E;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[rh] = acc;
    if (t == 0 && qi < Sq) delta[stat + qi] = acc;
  }

  const float scale2 = sm_scale * LOG2E;
  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  mbar_wait(sm.bar(0), 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t sK = sm.tile(2 + 2 * s), sV = sm.tile(3 + 2 * s);
    mbar_wait(sm.bar(1 + s), (i / STAGES) & 1);

    // S = Q K^T and dP = dO V^T as two groups: P is computed while dP runs
    float sacc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sacc, desc(sm.tile(0) + 32 * kk), desc(sK + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, desc(sm.tile(1) + 32 * kk), desc(sV + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sacc);

    // P = exp(scale S + bias - lse), 0 where masked; then dS = P o (dP - delta)
    const int k_start = i * T;
#pragma unroll
    for (int x = 0; x < 32; ++x) sacc[x] *= scale2;
    if (k_start + T > Sk || q_start + T > Sq || causal || bp != nullptr) {
      mask_tile<false>(sacc, row0, k_start + 2 * t, Sq, Sk, causal, bp, st.bias[2]);
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) sacc[x] = ex2(sacc[x] - lse2[(x & 3) >> 1]);
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) sacc[x] *= dp[x] - dl[(x & 3) >> 1];
    uint32_t dsa[4][4];
    to_a_frags(dsa, sacc);

    // dQ += dS K: K read through the transpose bit, 16 keys (2048 bytes) a k-step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq_acc, dsa[kk], desc(sK + 2048 * kk));
    wgmma_commit();
    wgmma_wait();
    fence_acc(dq_acc);
    mbar_arrive(sm.bar(1 + STAGES + s));
  }

  store_acc(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], row0, Sq, dq_acc, sm_scale, t);
}

// B4: dK and dV for 64 keys, Q/dO tiles (with their lse and delta) streamed.
// Tiles: 0 K, 1 V, 2 + 2s Q, 3 + 2s dO.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_lse,
               const __grid_constant__ CUtensorMap tm_delta, const float* __restrict__ bias,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
               BwdStrides st, int causal, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int k_start = blockIdx.x * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // causal: q tiles whose last row lies above the block's first key are all masked
  const int n_q = (Sq + T - 1) / T;
  const int first = causal ? k_start / T : 0;
  init_barriers(sm);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(sm.bar(0), 2 * TILE);
      tma_4d(sm.tile(0), &tm_k, sm.bar(0), 0, k_start, h, b);
      tma_4d(sm.tile(1), &tm_v, sm.bar(0), 0, k_start, h, b);
      for (int it = first; it < n_q; ++it) {
        const int i = it - first;
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(sm.bar(1 + STAGES + s), (i / STAGES - 1) & 1);
        mbar_expect_tx(sm.bar(1 + s), 2 * TILE + STAT);
        tma_4d(sm.tile(2 + 2 * s), &tm_q, sm.bar(1 + s), 0, it * T, h, b);
        tma_4d(sm.tile(3 + 2 * s), &tm_do, sm.bar(1 + s), 0, it * T, h, b);
        tma_2d(sm.stat(s), &tm_lse, sm.bar(1 + s), it * T, b * H + h);
        tma_2d(sm.stat(s) + STAT / 2, &tm_delta, sm.bar(1 + s), it * T, b * H + h);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = k_start + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float* bp = bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  const float scale2 = sm_scale * LOG2E;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(sm.bar(0), 0);

  for (int it = first; it < n_q; ++it) {
    const int i = it - first;
    const int s = i % STAGES;
    const uint32_t sQ = sm.tile(2 + 2 * s), sdO = sm.tile(3 + 2 * s);
    mbar_wait(sm.bar(1 + s), (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T as two groups: P^T is computed while dP^T runs
    float sacc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sacc, desc(sm.tile(0) + 32 * kk), desc(sQ + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, desc(sm.tile(1) + 32 * kk), desc(sdO + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sacc);

    // P^T and dS^T: keys on the rows, this tile's q rows on the columns
    const float* sL = sm.stat_ptr(s);
    const float* sD = sL + T;
    const int q_start = it * T;
#pragma unroll
    for (int x = 0; x < 32; ++x) sacc[x] *= scale2;
    if (k_start + T > Sk || q_start + T > Sq || causal || bp != nullptr) {
      mask_tile<true>(sacc, key0, q_start + 2 * t, Sq, Sk, causal, bp, st.bias[2]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[4 * n + e] = ex2(sacc[4 * n + e] - (e & 1 ? l2.y : l2.x) * LOG2E);
    }
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * n + e] = sacc[4 * n + e] * (dp[4 * n + e] - (e & 1 ? d2.y : d2.x));
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(pa, sacc);
    to_a_frags(dsa, dp);

    // dV += P^T dO, dK += dS^T Q: dO and Q through the transpose bit
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc, pa[kk], desc(sdO + 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc, dsa[kk], desc(sQ + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    mbar_arrive(sm.bar(1 + STAGES + s));
  }

  store_acc(dk + b * st.dk[0] + h * st.dk[1], st.dk[2], key0, Sk, dk_acc, sm_scale, t);
  store_acc(dv + b * st.dv[0] + h * st.dv[1], st.dv[2], key0, Sk, dv_acc, 1.f, t);
}

// B1: O and lse for 64 q rows, K/V tiles of BN keys streamed through a ring
// of fwd_stages(BN). Shared memory: the Q tile (8 KB), then per stage a K and
// a V tile of BN x 128 bytes, then the barriers. A tile's stage is released
// only once its P V has run, after the next tile's S = Q K^T was issued, so
// the ring needs 3 stages; at 64 keys 4 measured faster than 3 and 2 on an
// H100. 64-key tiles fit 3 blocks an SM (128 registers, no spill), 128-key
// tiles 2 (168 registers).
constexpr int fwd_stages(int BN) { return BN == 64 ? 4 : 3; }

template <int BN>
struct FwdSmem {
  static constexpr int STAGES = fwd_stages(BN);
  static constexpr uint32_t KV = BN * 128;  // one K or V tile
  static constexpr uint32_t BARS = TILE + STAGES * 2 * KV;
  static constexpr size_t BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;
  uint32_t base;  // shared-window address, 1024-aligned; the Q tile
  __device__ explicit FwdSmem(unsigned char* raw) { base = (smem_u32(raw) + 1023u) & ~1023u; }
  __device__ uint32_t k(int s) const { return base + TILE + s * 2 * KV; }
  __device__ uint32_t v(int s) const { return k(s) + KV; }
  __device__ uint32_t bar(int i) const { return base + BARS + 8 * i; }
};

template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 3 : 2)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
           bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
           long long sob, long long soh, long long sos, long long sbb, long long sbh,
           long long sbq, int causal, float sm_scale) {
  using Sm = FwdSmem<BN>;
  constexpr int STAGES = Sm::STAGES;
  constexpr int NS = BN / 2;  // score accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const Sm sm(smem_raw);
  const int q_start = blockIdx.x * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) {
    // tiles whose first key lies above the block's last row are all masked
    const int last = (q_start + T - 1) / BN + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  init_ring(sm.bar(0), STAGES, CONSUMERS);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(sm.bar(0), TILE);
      tma_4d(sm.base, &tm_q, sm.bar(0), 0, q_start, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(sm.bar(1 + STAGES + s), (i / STAGES - 1) & 1);
        mbar_expect_tx(sm.bar(1 + s), 2 * Sm::KV);
        tma_4d(sm.k(s), &tm_k, sm.bar(1 + s), 0, i * BN, h, b);
        tma_4d(sm.v(s), &tm_v, sm.bar(1 + s), 0, i * BN, h, b);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t sQ = sm.base;
  const float* bp = bias == nullptr ? nullptr : bias + b * sbb + h * sbh;
  const float scale2 = sm_scale * LOG2E;
  const float inf = __int_as_float(0x7f800000);
  float m[2] = {-inf, -inf};  // running row max, log2 units
  float l[2] = {0.f, 0.f};    // this thread's share of the row sums
  float o_acc[32], sacc[NS];
#pragma unroll
  for (int x = 0; x < 32; ++x) o_acc[x] = 0.f;

  // P = exp2(scale2 S + bias - m) of tile i in place, with the online max
  // and sum, and corr, the factor that rescales O. A tile that needs no mask
  // folds the scale into the exponent's fma.
  float corr[2];
  auto softmax = [&](int i) {
    const int k_start = i * BN;
    float sc = scale2;
    if (k_start + BN > Sk || (causal && k_start + BN - 1 > q_start) || bp != nullptr) {
#pragma unroll
      for (int x = 0; x < NS; ++x) sacc[x] *= scale2;
      mask_tile<false>(sacc, row0, k_start + 2 * t, Sq, Sk, causal, bp, sbq);
      sc = 1.f;
    }
    float mx[2] = {-inf, -inf}, neg_m[2];
#pragma unroll
    for (int x = 0; x < NS; ++x) mx[(x & 3) >> 1] = fmaxf(mx[(x & 3) >> 1], sacc[x]);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
      const float m_new = fmaxf(m[rh], mx[rh] * sc);
      // a row with no valid key so far keeps m = -inf: exponentiate against
      // 0 there, so its p and its correction are 0 and never NaN
      const float m_use = m_new == -inf ? 0.f : m_new;
      corr[rh] = ex2(m[rh] - m_use);
      neg_m[rh] = -m_use;
      m[rh] = m_new;
      l[rh] *= corr[rh];
    }
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      const int rh = (x & 3) >> 1;
      sacc[x] = ex2(fmaf(sacc[x], sc, neg_m[rh]));
      l[rh] += sacc[x];
    }
  };
  // O = O corr + P V of tile i: V read through the transpose bit, 16 keys
  // (2048 bytes) a k-step; P's fragments `pa` stay read until the group ends
  uint32_t pa[BN / 16][4];
  auto pv = [&](int i) {
#pragma unroll
    for (int x = 0; x < 32; ++x) o_acc[x] *= corr[(x & 3) >> 1];
    const uint32_t sV = sm.v(i % STAGES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o_acc, pa[kk], desc(sV + 2048 * kk));
    wgmma_commit();
  };
  auto qk = [&](int i) {  // S = Q K^T of tile i into sacc
    const int s = i % STAGES;
    mbar_wait(sm.bar(1 + s), (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sacc, desc(sQ + 32 * kk), desc(sm.k(s) + 32 * kk), kk);
    wgmma_commit();
  };

  mbar_wait(sm.bar(0), 0);
  qk(0);
  wgmma_wait<0>();
  fence_acc(sacc);
  softmax(0);
  to_a_frags(pa, sacc);
  // Each step issues the next tile's S, then this tile's P V, and computes
  // the next softmax while P V runs on the tensor cores.
  for (int i = 0; i + 1 < n_tiles; ++i) {
    qk(i + 1);
    pv(i);
    wgmma_wait<1>();  // S of tile i + 1
    fence_acc(sacc);
    softmax(i + 1);
    wgmma_wait<0>();  // P V of tile i: its stage is free, and pa may change
    fence_acc(o_acc);
    mbar_arrive(sm.bar(1 + STAGES + i % STAGES));
    to_a_frags(pa, sacc);
  }
  pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_acc(o_acc);

  // O / l in bf16 and lse = m ln2 + log(l); a row with no valid key gets
  // O = 0 and lse = -1e30, as the TPU kernel's l == 0 guard gives
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
    const int qi = row0 + 8 * rh;
    if (qi >= Sq) continue;
    const float inv = l[rh] == 0.f ? 0.f : 1.f / l[rh];
    bf16* out = o + b * sob + h * soh + (long long)qi * sos + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(o_acc[4 * n + 2 * rh] * inv, o_acc[4 * n + 2 * rh + 1] * inv);
    }
    if (t == 0) {
      lse[((long long)b * H + h) * Sq + qi] = l[rh] == 0.f ? NEG_INF : m[rh] * LN2 + logf(l[rh]);
    }
  }
}

// fp32 rows [B * H, Sq] with a row pitch of `pitch` values (a multiple of 4)
// as a 2-d map of 64-value boxes; values past Sq read as zeros.
bool map_stat(CUtensorMap* map, const void* ptr, int rows, int Sq, long long pitch) {
  const cuuint64_t dims[2] = {(cuuint64_t)Sq, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {T, 1}, unit[2] = {1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `st`: the 15 element strides of the C entry point (q, k, v, o, bias).
template <int BN>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                       void* lse, int B, int H, int Sq, int Sk, const long long* st, int causal,
                       float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!(map_rows(&mq, q, B, H, Sq, st) && map_rows(&mk, k, B, H, Sk, st + 3, BN) &&
        map_rows(&mv, v, B, H, Sk, st + 6, BN))) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = FwdSmem<BN>::BYTES;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(fwd_kernel<BN>), smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + T - 1) / T, H, B);
  fwd_kernel<BN><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<const float*>(bias), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, st[9], st[10], st[11], st[12], st[13], st[14], causal,
      sm_scale);
  return cudaGetLastError();
}

cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, const void* bias, void* dq,
                      void* delta, int B, int H, int Sq, int Sk, const BwdStrides& st,
                      int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!(map_rows(&mq, q, B, H, Sq, st.q) && map_rows(&mk, k, B, H, Sk, st.k) &&
        map_rows(&mv, v, B, H, Sk, st.v) && map_rows(&mdo, dout, B, H, Sq, st.dout))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(bwd_dq_kernel), SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + T - 1) / T, H, B);
  bwd_dq_kernel<<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(bias), static_cast<bf16*>(dq),
      static_cast<float*>(delta), H, Sq, Sk, st, causal, sm_scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* bias, void* dk,
                       void* dv, int B, int H, int Sq, int Sk, const BwdStrides& st,
                       long long stat_pitch, int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, ml, md;
  if (!(map_rows(&mq, q, B, H, Sq, st.q) && map_rows(&mk, k, B, H, Sk, st.k) &&
        map_rows(&mv, v, B, H, Sk, st.v) && map_rows(&mdo, dout, B, H, Sq, st.dout) &&
        map_stat(&ml, lse, B * H, Sq, stat_pitch) && map_stat(&md, delta, B * H, Sq, stat_pitch))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(bwd_dkv_kernel), SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + T - 1) / T, H, B);
  bwd_dkv_kernel<<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, mdo, ml, md, static_cast<const float*>(bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, st, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace hop

}  // namespace

// C entry point bound with ctypes. `strides` holds 15 element strides:
// q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s), bias (b, h, q); the last
// dim of every tensor has stride 1. head_dim 64 builds TMA maps of q, k and v
// here, so they must be 16-byte aligned with strides divisible by 8, and
// streams K/V tiles of `key_tile` (64 or 128) keys. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue where a map cannot be encoded).
extern "C" int diffsensei_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int H, int Sq, int Sk, int D, const long long* strides,
    int causal, float sm_scale, int key_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && key_tile == 64) return (int)hop::launch_fwd<64>(q, k, v, bias, o, lse, B, H, Sq, Sk, strides, causal, sm_scale, s);
  if (D == 64 && key_tile == 128) return (int)hop::launch_fwd<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, strides, causal, sm_scale, s);
  if (D == 128) return (int)launch<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, strides, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// C entry points of the backward. `strides` holds 28 element strides, (b, h, s)
// of q, k, v, o, dout, dq, dk, dv and bias, in that order, then the pitch of
// the (b, h) rows of lse and delta as the dK/dV kernel gets them. The dQ
// kernel also writes delta [B, H, Sq] (fp32), which the dK/dV kernel reads:
// launch them in that order on one stream. head_dim 64 builds its TMA maps
// here, so q, k, v, dout, lse and delta must be 16-byte aligned and the pitch
// a multiple of 4. Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue where a map cannot be encoded).
extern "C" int diffsensei_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* bias, void* dq, void* delta, int B, int H, int Sq,
    int Sk, int D, const long long* strides, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdStrides st = bwd_strides(strides);
  if (D == 64) return (int)hop::launch_dq(q, k, v, o, dout, lse, bias, dq, delta, B, H, Sq, Sk, st, causal, sm_scale, s);
  if (D == 128) return (int)launch_dq<128>(q, k, v, o, dout, lse, bias, dq, delta, B, H, Sq, Sk, st, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int diffsensei_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dk, void* dv, int B, int H, int Sq, int Sk,
    int D, const long long* strides, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdStrides st = bwd_strides(strides);
  if (D == 64) return (int)hop::launch_dkv(q, k, v, dout, lse, delta, bias, dk, dv, B, H, Sq, Sk, st, strides[27], causal, sm_scale, s);
  if (D == 128) return (int)launch_dkv<128>(q, k, v, dout, lse, delta, bias, dk, dv, B, H, Sq, Sk, st, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// How the head_dim-64 kernels fill the card: `out` receives, for B1 over
// 64-key and over 128-key tiles, then B2 and B4, the blocks that fit on one
// SM, the threads and the dynamic shared memory of a block, and the q or key
// rows a block owns (16 ints).
extern "C" int diffsensei_flash_attention_occupancy(int* out) {
  const void* kernels[4] = {reinterpret_cast<const void*>(hop::fwd_kernel<64>),
                            reinterpret_cast<const void*>(hop::fwd_kernel<128>),
                            reinterpret_cast<const void*>(hop::bwd_dq_kernel),
                            reinterpret_cast<const void*>(hop::bwd_dkv_kernel)};
  const size_t smem[4] = {hop::FwdSmem<64>::BYTES, hop::FwdSmem<128>::BYTES, hop::SMEM, hop::SMEM};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err = allow_smem(kernels[i], smem[i]);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4 * i], kernels[i], hop::THREADS,
                                                          smem[i]);
    }
    if (err != cudaSuccess) return (int)err;
    out[4 * i + 1] = hop::THREADS;
    out[4 * i + 2] = (int)smem[i];
    out[4 * i + 3] = hop::T;
  }
  return 0;
}
