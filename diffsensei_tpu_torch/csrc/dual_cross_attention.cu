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
// (2, 10, 4096, 64) that is about 35 MB (10 us at 3.35 TB/s) against 3.3
// GFLOP (3.3 us at 989 TFLOP/s): bytes bound. The design moves each of those
// bytes once and keeps the copies in flight while the math runs:
//   * a block of 4 warps owns a run of 64-row q tiles of one (batch, head)
//     (each warp 16 rows of a tile); the grid is sized so that all blocks are
//     resident at once, 3 an SM at head_dim 64, so the last block may hold
//     fewer tiles;
//   * both key/value sets of the (batch, head), zero-padded to a multiple of
//     16 keys, are copied into shared memory once a block, and the dynamic
//     shared memory is sized to the call's padded key counts, not to 128;
//   * each warp streams its own 16 Q rows of every tile, double-buffered
//     with cp.async, so the next tile's copy overlaps this tile's math, and
//     the warps never wait for each other once the key/value sets have
//     landed. The fp32 bias rows go straight to registers: each thread issues
//     the loads of its own bias values before the text attention and uses
//     them after it, so the copy overlaps that math and the bias takes no
//     shared memory (staged there, it held the kernel to 2 blocks an SM). A
//     bias whose rows are not 8-byte aligned is read element by element;
//   * S = Q K^T and O = P V run on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate) with B fragments from ldmatrix (.trans for V); a row's
//     scores over all its keys stay in registers (10 key tiles where both
//     sets fit in 80 keys, else 16), so each softmax is exact in one pass (no
//     online rescaling, no score tensor in memory); padded key columns are
//     masked by index to -1e30, never -inf, and the exponential is
//     ex2.approx.ftz in log2 units;
//   * P, rounded to bf16, is the A operand of P V straight from the score
//     accumulators; O is divided by the row sum in fp32, staged in the warp's
//     own Q rows (free once its fragments are in registers) and written with
//     16-byte stores of whole rows;
//   * q rows past S (the 4032- and 1008-token levels of the 768x1344 bucket)
//     are zero-filled on load and never written.
// Each block owns its output rows, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;         // q rows per tile
constexpr int KMAX = 128;      // most keys of either set
constexpr int NWARPS = 4;      // 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device. The attribute lasts for the process, so it is set once for each
// (kernel, device, size) and not at every launch: the paths that launch these
// kernels most are host bound.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  struct Done {
    const void* kernel;
    int dev;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Done> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Done& d : done) {
    if (d.kernel == kernel && d.dev == dev && d.smem >= smem) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done.push_back({kernel, dev, smem});
  return err;
}

// Shared memory of one call, in bf16 elements from the base: Kt, Vt, Ki, Vi
// (padded keys x LDH each), then two Q tiles (64 x LDH). LDH = D + 8 keeps
// ldmatrix free of bank conflicts, and every offset is a multiple of 16 bytes.
template <int D>
struct Plan {
  static constexpr int LDH = D + 8;
  int kt_pad, ki_pad;
  __host__ __device__ Plan(int Kt, int Ki)
      : kt_pad((Kt + 15) / 16 * 16), ki_pad((Ki + 15) / 16 * 16) {}
  __host__ __device__ size_t bytes() const {
    return (2 * (kt_pad + ki_pad) + 2 * BM) * LDH * sizeof(bf16);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid == false` zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Start the copy of `rows` rows of D bf16 from row0 on, by the `threads`
// threads from `me` = 0 on; rows >= limit are zeros.
template <int D>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, long long row_stride,
                                                int row0, int rows, int limit, int me,
                                                int threads) {
  constexpr int PER_ROW = D / 8;
  for (int i = me; i < rows * PER_ROW; i += threads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const bool valid = row0 + r < limit;
    const bf16* g = src + (valid ? (long long)(row0 + r) * row_stride + c : 0);
    cp_async16(dst + r * Plan<D>::LDH + c, g, valid);
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

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit, subnormal results flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This thread's bias values of rows row0 and row0 + 8 at columns 8n + 2t and
// 8n + 2t + 1 (0 past Sq or Ki), loaded into registers: `vec` where every row
// starts on 8 bytes and Ki is even (one 8-byte load a pair), else one value
// at a time.
template <int NT>
__device__ __forceinline__ void load_bias(float2 (&bv)[NT][2], const float* bp, long long sbq,
                                          int row0, int Sq, int Ki, int kpad, int t, bool vec) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int qi = row0 + 8 * rh, kj = n * 8 + 2 * t;
      const float* p = bp + (long long)qi * sbq + kj;
      bv[n][rh] = make_float2(0.f, 0.f);
      if (n * 8 < kpad && qi < Sq) {
        if (vec) {
          if (kj < Ki) bv[n][rh] = __ldg(reinterpret_cast<const float2*>(p));
        } else {
          if (kj < Ki) bv[n][rh].x = __ldg(p);
          if (kj + 1 < Ki) bv[n][rh].y = __ldg(p + 1);
        }
      }
    }
  }
}

// One softmax attention of this warp's 16 q rows (A fragments `qa`) over the
// `klen` keys of sK / sV (padded to `kpad` <= 8 NT), plus this thread's bias
// values `bv` where BIAS. The output rows pass through `stage` (the warp's
// 16 rows of its Q tile, LDH apart) on their way to rows row_base.. of `out`
// (those below Sq).
// Fragment coordinates of mma m16n8k16 for lane = 4*g + t:
//   A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <int D, int NT, bool BIAS>
__device__ __forceinline__ void attend(const uint32_t (&qa)[D / 16][4], const bf16* sK,
                                       const bf16* sV, int klen, int kpad,
                                       const float2 (&bv)[NT][2], float scale2, bf16* stage,
                                       bf16* out, long long out_stride, int row_base, int Sq,
                                       int lane) {
  constexpr int LDH = Plan<D>::LDH;
  constexpr int DT = D / 8;      // 8-wide column tiles of O
  const int g = lane >> 2, t = lane & 3;
  const int nt = kpad / 8;       // key tiles in use

  // S = Q K^T: ldmatrix.x4 on 8 key rows gives b0, b1 of two k-steps
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (n < nt) {
      const bf16* kr = sK + (n * 8 + (lane & 7)) * LDH + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kr + kk * 16);
        mma16816(s[n], qa[kk], b[0], b[1]);
        mma16816(s[n], qa[kk + 1], b[2], b[3]);
      }
    }
  }

  // scale, bias, padded columns (log2 units); the row max over the row's four lanes
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int kj = n * 8 + 2 * t;
        float v0 = s[n][2 * rh] * scale2, v1 = s[n][2 * rh + 1] * scale2;
        if (BIAS) {
          v0 = fmaf(bv[n][rh].x, LOG2E, v0);
          v1 = fmaf(bv[n][rh].y, LOG2E, v1);
        }
        s[n][2 * rh] = kj < klen ? v0 : NEG_INF;
        s[n][2 * rh + 1] = kj + 1 < klen ? v1 : NEG_INF;
        mx[rh] = fmaxf(mx[rh], fmaxf(s[n][2 * rh], s[n][2 * rh + 1]));
      }
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
    if (n < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - mx[e >> 1]);   // 0 for a padded column
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
  }

  // O = P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
  // fragment; ldmatrix.x4.trans on 16 V rows gives b0, b1 of two 8-wide columns
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
      const bf16* vr = sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDH + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + j * 8);
        mma16816(acc[j], pa, b[0], b[1]);
        mma16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
  }

  // O / l in bf16 into the staging rows, then 16-byte stores of whole rows
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float inv = 1.f / l[rh];   // l >= 1: the row max contributes exp2(0)
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * rh) * LDH + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * rh] * inv, acc[j][2 * rh + 1] * inv);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * DT; i += 32) {
    const int r = i / DT, c = (i % DT) * 8;
    if (row_base + r < Sq) {
      *reinterpret_cast<uint4*>(out + (long long)(row_base + r) * out_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * LDH + c);
    }
  }
  __syncwarp();  // the staging rows are written again by the next attention
}

// Element strides (batch, head, row) of every operand; the last dim of each
// has stride 1, and a broadcast bias dim has stride 0.
struct Strides {
  long long q[3], kt[3], vt[3], ki[3], vi[3], ot[3], oi[3], bias[3];
};

template <int D, int NT>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 1)
dual_cross_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                            const bf16* __restrict__ vt, const bf16* __restrict__ ki,
                            const bf16* __restrict__ vi, const float* __restrict__ bias,
                            bf16* __restrict__ ot, bf16* __restrict__ oi, int Sq, int Kt,
                            int Ki, Strides st, float sm_scale, int tiles_per_block,
                            int bias_vec) {
  constexpr int LDH = Plan<D>::LDH;
  const Plan<D> plan(Kt, Ki);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sKt = reinterpret_cast<bf16*>(smem);
  bf16* sVt = sKt + plan.kt_pad * LDH;
  bf16* sKi = sVt + plan.kt_pad * LDH;
  bf16* sVi = sKi + plan.ki_pad * LDH;
  bf16* sQ = sVi + plan.ki_pad * LDH;  // two tiles

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int first = blockIdx.x * tiles_per_block;
  const int n_q = (Sq + BM - 1) / BM;
  const int end = min(first + tiles_per_block, n_q);

  const float* bp = bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  // each warp streams its own 16 rows of every tile, double-buffered, and
  // runs without waiting for the other warps
  const bf16* qp = q + b * st.q[0] + h * st.q[1];
  auto load_q = [&](int tile, int buf) {
    load_rows_async<D>(sQ + (buf * BM + warp * 16) * LDH, qp, st.q[2], tile * BM + warp * 16, 16,
                       Sq, lane, 32);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // both key/value sets once, then the first tile's Q rows
  load_rows_async<D>(sKt, kt + b * st.kt[0] + h * st.kt[1], st.kt[2], 0, plan.kt_pad, Kt,
                     threadIdx.x, NTHREADS);
  load_rows_async<D>(sVt, vt + b * st.vt[0] + h * st.vt[1], st.vt[2], 0, plan.kt_pad, Kt,
                     threadIdx.x, NTHREADS);
  load_rows_async<D>(sKi, ki + b * st.ki[0] + h * st.ki[1], st.ki[2], 0, plan.ki_pad, Ki,
                     threadIdx.x, NTHREADS);
  load_rows_async<D>(sVi, vi + b * st.vi[0] + h * st.vi[1], st.vi[2], 0, plan.ki_pad, Ki,
                     threadIdx.x, NTHREADS);
  asm volatile("cp.async.commit_group;\n" ::);
  load_q(first, 0);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();  // every thread's key/value copies have landed

  const float scale2 = sm_scale * LOG2E;  // scores in log2 units
  const int lrow = warp * 16 + (lane >> 2);  // this lane's rows in the tile: lrow, lrow + 8
  bf16* otp = ot + b * st.ot[0] + h * st.ot[1];
  bf16* oip = oi + b * st.oi[0] + h * st.oi[1];
  for (int tile = first; tile < end; ++tile) {
    const int buf = (tile - first) & 1;
    if (tile + 1 < end) {
      load_q(tile + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();

    // the bias loads are in flight during the text attention
    float2 bv[NT][2];
    if (bp != nullptr) {
      load_bias<NT>(bv, bp, st.bias[2], tile * BM + lrow, Sq, Ki, plan.ki_pad, lane & 3,
                    bias_vec != 0);
    }

    // Q fragments of this warp's 16 rows (ldmatrix.x4 gives a0..a3 of a
    // k-step); after them these 16 Q rows stage the warp's outputs
    bf16* stage = sQ + (buf * BM + warp * 16) * LDH;
    uint32_t qa[D / 16][4];
    const bf16* qw = stage + (lane & 15) * LDH + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], qw + kk * 16);
    __syncwarp();

    const int row_base = tile * BM + warp * 16;
    attend<D, NT, false>(qa, sKt, sVt, Kt, plan.kt_pad, bv, scale2, stage, otp, st.ot[2],
                         row_base, Sq, lane);
    if (bp != nullptr) {
      attend<D, NT, true>(qa, sKi, sVi, Ki, plan.ki_pad, bv, scale2, stage, oip, st.oi[2],
                          row_base, Sq, lane);
    } else {
      attend<D, NT, false>(qa, sKi, sVi, Ki, plan.ki_pad, bv, scale2, stage, oip, st.oi[2],
                           row_base, Sq, lane);
    }
    // the staging reads above end before the next load into this buffer
  }
}

// The kernel of a call: 10 key tiles of scores in registers where both sets
// fit in 80 keys (the UNet's 77 and 80), else 16.
template <int D>
int key_tiles(const Plan<D>& plan) {
  return plan.kt_pad <= 80 && plan.ki_pad <= 80 ? 10 : 16;
}

template <int D>
const void* kernel_for(const Plan<D>& plan) {
  return key_tiles(plan) == 10 ? reinterpret_cast<const void*>(dual_cross_attention_kernel<D, 10>)
                               : reinterpret_cast<const void*>(dual_cross_attention_kernel<D, 16>);
}

// The SM count and the blocks an SM holds of one (kernel, shared memory).
struct Occupancy {
  int sms = 0, blocks = 0;
  const void* kernel = nullptr;
  size_t smem = 0;
};

Occupancy occ_cache;  // of the last launch

cudaError_t occupancy(Occupancy& occ, const void* kernel, size_t smem) {
  if (occ.sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (occ.kernel != kernel || occ.smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.blocks, kernel, NTHREADS, smem);
    if (err != cudaSuccess) return err;
    if (occ.blocks < 1) return cudaErrorInvalidConfiguration;
    occ.kernel = kernel;
    occ.smem = smem;
  }
  return cudaSuccess;
}

// q tiles a block: as few as keep every block resident in one wave.
int tiles_per_block(const Occupancy& occ, int B, int H, int Sq) {
  const long long tiles = (long long)B * H * ((Sq + BM - 1) / BM);
  const long long slots = (long long)occ.sms * occ.blocks;
  return (int)((tiles + slots - 1) / slots);
}

template <int D>
cudaError_t launch(const void* q, const void* kt, const void* vt, const void* ki,
                   const void* vi, const void* bias, void* ot, void* oi, int B, int H, int Sq,
                   int Kt, int Ki, const Strides& st, float sm_scale, cudaStream_t stream) {
  const Plan<D> plan(Kt, Ki);
  const size_t smem = plan.bytes();
  cudaError_t err = occupancy(occ_cache, kernel_for<D>(plan), smem);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(occ_cache, B, H, Sq);
  // 8-byte bias loads where every row starts on 8 bytes and Ki is even
  const int bias_vec = bias != nullptr && reinterpret_cast<uintptr_t>(bias) % 8 == 0 &&
                       st.bias[0] % 2 == 0 && st.bias[1] % 2 == 0 && st.bias[2] % 2 == 0 &&
                       Ki % 2 == 0;
  const dim3 grid(((Sq + BM - 1) / BM + tpb - 1) / tpb, H, B);
  const bf16 *q_ = static_cast<const bf16*>(q), *kt_ = static_cast<const bf16*>(kt),
             *vt_ = static_cast<const bf16*>(vt), *ki_ = static_cast<const bf16*>(ki),
             *vi_ = static_cast<const bf16*>(vi);
  const float* bias_ = static_cast<const float*>(bias);
  bf16 *ot_ = static_cast<bf16*>(ot), *oi_ = static_cast<bf16*>(oi);
  if (key_tiles(plan) == 10) {
    dual_cross_attention_kernel<D, 10><<<grid, NTHREADS, smem, stream>>>(
        q_, kt_, vt_, ki_, vi_, bias_, ot_, oi_, Sq, Kt, Ki, st, sm_scale, tpb, bias_vec);
  } else {
    dual_cross_attention_kernel<D, 16><<<grid, NTHREADS, smem, stream>>>(
        q_, kt_, vt_, ki_, vi_, bias_, ot_, oi_, Sq, Kt, Ki, st, sm_scale, tpb, bias_vec);
  }
  return cudaGetLastError();
}

template <int D>
int query(int B, int H, int Sq, int Kt, int Ki, int* out) {
  const Plan<D> plan(Kt, Ki);
  Occupancy occ;
  cudaError_t err = occupancy(occ, kernel_for<D>(plan), plan.bytes());
  if (err != cudaSuccess) return (int)err;
  const int tpb = tiles_per_block(occ, B, H, Sq);
  out[0] = occ.blocks;
  out[1] = NTHREADS;
  out[2] = (int)plan.bytes();
  out[3] = key_tiles(plan);
  out[4] = tpb;
  out[5] = (((Sq + BM - 1) / BM + tpb - 1) / tpb) * H * B;
  out[6] = occ.sms;
  return 0;
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

// How a call of these sizes fills the card: `out` receives the blocks that
// fit on one SM, a block's threads and dynamic shared memory bytes, the key
// tiles of scores it keeps in registers, the q tiles a block, the blocks of
// the grid and the SMs (7 ints).
extern "C" int diffsensei_dual_cross_attention_occupancy(int B, int H, int Sq, int Kt, int Ki,
                                                         int D, int* out) {
  if (Kt < 1 || Kt > KMAX || Ki < 1 || Ki > KMAX) return (int)cudaErrorInvalidValue;
  if (D == 64) return query<64>(B, H, Sq, Kt, Ki, out);
  if (D == 128) return query<128>(B, H, Sq, Kt, Ki, out);
  return (int)cudaErrorInvalidValue;
}
