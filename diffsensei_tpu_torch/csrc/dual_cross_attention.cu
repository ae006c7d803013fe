// Dual cross-attention for Hopper (sm_90a): the text attention and the
// masked-IP attention of one query set in one pass, bf16 in, fp32 softmax.
//
// Replaces the Pallas TPU kernel `_kernel`
// (diffsensei_tpu/ops/dual_cross_attention.py:35, pallas_call at :86, entry
// `dual_cross_attention:128`). For q [B, H, S, D] it computes
//   o_text = softmax(scale q kt^T) vt            over <= 128 text keys,
//   o_ip   = softmax(scale q ki^T + bias) vi     over <= 128 IP keys,
// with an additive fp32 bias [B|1, H|1, S, K_ip] (the bbox mask); the caller
// combines them as o_text + ip_scale * o_ip. Both outputs are bf16.
//
// What bounds it on the H100: the key sets are tiny (77 text and 80 IP keys
// in every UNet cross-attention), so per query row the kernel reads D bf16 of
// q and K_ip fp32 of bias and writes 2 D bf16, against 8 D K flops. At
// (2, 10, 4096, 64) that is about 34 MB (10 us at 3.35 TB/s) against 3.3
// GFLOP (3.3 us at 989 TFLOP/s): bytes bound. The design reads and writes
// each of those bytes once:
//   * one block of 4 warps per (64-row q tile, head, batch); each warp owns
//     16 q rows;
//   * both key/value sets of the (batch, head), zero-padded to a multiple of
//     16 keys (at most 4 x 128 x D bf16), and the Q tile sit in shared memory,
//     brought in together with cp.async;
//   * S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32 accumulate) and a
//     row's scores over all its keys stay in registers, so each softmax is
//     exact in one pass (no online rescaling, no score tensor in memory);
//     padded key columns are masked by index to -1e30, never -inf, and the
//     bias is read in fp32 through its strides (a broadcast dim has stride 0);
//   * P, rounded to bf16, is the A operand of P V straight from the score
//     accumulators; O is divided by the row sum in fp32 when it is stored;
//   * q rows past S (the 4032- and 1008-token levels of the 768x1344 bucket)
//     are zero-filled on load and never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;         // q rows per block
constexpr int KMAX = 128;      // most keys of either set
constexpr int NWARPS = 4;      // 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;  // row pitch (elements): 16-byte rows, no bank conflicts
  static constexpr int KV = KMAX * LDH;
  static constexpr size_t bytes = sizeof(bf16) * (BM * LDH + 4 * KV);  // Q, Kt, Vt, Ki, Vi
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid == false` zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Start the copy of `rows` rows of D bf16 from row0 on; rows >= limit are zeros.
template <int D>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, long long row_stride,
                                                int row0, int rows, int limit) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NTHREADS) {
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

// One softmax attention of this warp's 16 q rows (A fragments `qa`) over the
// `klen` keys of sK / sV, stored as bf16 rows row0 and row0 + 8 of `out`.
// `bias` (or nullptr) points at the (batch, head) plane, `sbq` its row stride.
// Fragment coordinates of mma m16n8k16 for lane = 4*g + t:
//   A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <int D>
__device__ __forceinline__ void attend(const uint32_t (&qa)[D / 16][4], const bf16* sK,
                                       const bf16* sV, int klen, const float* bias,
                                       long long sbq, float scale2, bf16* out,
                                       long long out_stride, int row0, int Sq, int g, int t) {
  constexpr int LDH = Layout<D>::LDH;
  constexpr int NT = KMAX / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;      // 8-wide column tiles of O
  const int nt = (klen + 15) / 16 * 2;  // tiles in use: the keys padded to 16

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (n < nt) {
      const bf16* kr = sK + (n * 8 + g) * LDH + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma16816(s[n], qa[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
      }
    }
  }

  // scale, bias, padded columns; the row max over the row's four lanes
  const float* brow[2] = {nullptr, nullptr};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int qi = row0 + 8 * rh;
    if (bias != nullptr && qi < Sq) brow[rh] = bias + (long long)qi * sbq;
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rh = e >> 1;
      const int kj = n * 8 + 2 * t + (e & 1);
      float val = NEG_INF;
      if (kj < klen) {
        val = s[n][e] * scale2;
        if (brow[rh] != nullptr) val += brow[rh][kj] * LOG2E;
      }
      s[n][e] = val;
      mx[rh] = fmaxf(mx[rh], val);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
    mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rh = e >> 1;
      const float p = exp2f(s[n][e] - mx[rh]);   // 0 for a padded column
      s[n][e] = p;
      l[rh] += p;
    }
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
  }

  // O = P V: the score accumulators of key tiles 2kk, 2kk+1 are the A fragment
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk < nt) {
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
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int qi = row0 + 8 * rh;
    if (qi >= Sq) continue;
    const float inv = 1.f / l[rh];   // l >= 1: the row max contributes exp2(0)
    bf16* o = out + (long long)qi * out_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(o + j * 8) =
          pack_bf16(acc[j][2 * rh] * inv, acc[j][2 * rh + 1] * inv);
    }
  }
}

// Element strides (batch, head, row) of every operand; the last dim of each
// has stride 1, and a broadcast bias dim has stride 0.
struct Strides {
  long long q[3], kt[3], vt[3], ki[3], vi[3], ot[3], oi[3], bias[3];
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dual_cross_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                            const bf16* __restrict__ vt, const bf16* __restrict__ ki,
                            const bf16* __restrict__ vi, const float* __restrict__ bias,
                            bf16* __restrict__ ot, bf16* __restrict__ oi, int Sq, int Kt,
                            int Ki, Strides st, float sm_scale) {
  using L = Layout<D>;
  constexpr int LDH = L::LDH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKt = sQ + BM * LDH;
  bf16* sVt = sKt + L::KV;
  bf16* sKi = sVt + L::KV;
  bf16* sVi = sKi + L::KV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_start = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kt_pad = (Kt + 15) / 16 * 16;
  const int ki_pad = (Ki + 15) / 16 * 16;

  load_rows_async<D>(sQ, q + b * st.q[0] + h * st.q[1], st.q[2], q_start, BM, Sq);
  load_rows_async<D>(sKt, kt + b * st.kt[0] + h * st.kt[1], st.kt[2], 0, kt_pad, Kt);
  load_rows_async<D>(sVt, vt + b * st.vt[0] + h * st.vt[1], st.vt[2], 0, kt_pad, Kt);
  load_rows_async<D>(sKi, ki + b * st.ki[0] + h * st.ki[1], st.ki[2], 0, ki_pad, Ki);
  load_rows_async<D>(sVi, vi + b * st.vi[0] + h * st.vi[1], st.vi[2], 0, ki_pad, Ki);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  uint32_t qa[D / 16][4];
  const bf16* qw = sQ + (warp * 16 + g) * LDH + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld_u32(qw + kk * 16);
    qa[kk][1] = ld_u32(qw + 8 * LDH + kk * 16);
    qa[kk][2] = ld_u32(qw + kk * 16 + 8);
    qa[kk][3] = ld_u32(qw + 8 * LDH + kk * 16 + 8);
  }

  const float scale2 = sm_scale * LOG2E;     // scores in log2 units
  const int row0 = q_start + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const float* bp = bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  attend<D>(qa, sKt, sVt, Kt, nullptr, 0, scale2, ot + b * st.ot[0] + h * st.ot[1],
            st.ot[2], row0, Sq, g, t);
  attend<D>(qa, sKi, sVi, Ki, bp, st.bias[2], scale2, oi + b * st.oi[0] + h * st.oi[1],
            st.oi[2], row0, Sq, g, t);
}

template <int D>
cudaError_t launch(const void* q, const void* kt, const void* vt, const void* ki,
                   const void* vi, const void* bias, void* ot, void* oi, int B, int H, int Sq,
                   int Kt, int Ki, const Strides& st, float sm_scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(dual_cross_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  dual_cross_attention_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kt), static_cast<const bf16*>(vt),
      static_cast<const bf16*>(ki), static_cast<const bf16*>(vi),
      static_cast<const float*>(bias), static_cast<bf16*>(ot), static_cast<bf16*>(oi), Sq, Kt,
      Ki, st, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. `strides` holds 24 element strides, (b, h, s)
// of q, kt, vt, ki, vi, o_text, o_ip and bias, in that order; `bias` may be
// null. 1 <= Kt, Ki <= 128 and D is 64 or 128. Returns the cudaError_t of the
// launch.
extern "C" int diffsensei_dual_cross_attention(
    const void* q, const void* kt, const void* vt, const void* ki, const void* vi,
    const void* bias, void* ot, void* oi, int B, int H, int Sq, int Kt, int Ki, int D,
    const long long* strides, float sm_scale, void* stream) {
  if (Kt < 1 || Kt > KMAX || Ki < 1 || Ki > KMAX) return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[8] = {st.q, st.kt, st.vt, st.ki, st.vi, st.ot, st.oi, st.bias};
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(q, kt, vt, ki, vi, bias, ot, oi, B, H, Sq, Kt, Ki, st, sm_scale, s);
  if (D == 128) return (int)launch<128>(q, kt, vt, ki, vi, bias, ot, oi, B, H, Sq, Kt, Ki, st, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
