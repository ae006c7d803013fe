// The VAE's fp32 3x3 convolutions for Hopper (sm_90a): kernel B9.
//
// Replaces no TPU kernel: the JAX package leaves the VAE's convolutions to
// XLA (diffsensei_tpu/models/layers.py, `Conv3x3` by shifted matmuls). It was
// added because cuDNN runs the fp32 VAE on an FFMA kernel written for Ampere
// at about 44 TFLOP/s, two thirds of the H100's 67 TFLOP/s FFMA peak, behind
// a layout conversion of the NHWC activations, with GroupNorm+SiLU (B3) and
// the residual add as passes of their own.
//
// It computes, for x NHWC fp32 [B, H, W, Cin] and weights [Cout, Cin, 3, 3],
//   y = conv3x3(pre(x)) + bias [+ residual],   NHWC fp32 [B, Ho, Wo, Cout],
// with padding 1 applied to pre(x), in one of three modes: stride 1; stride 2
// (the encoder's downsamplers); or a nearest 2x upsample of x first (the
// decoder's upsamplers, read in place: the upsampled tensor never exists).
// pre is the identity, or GroupNorm+SiLU, silu((x - mean) * rstd * gamma +
// beta), with the statistics of a separate launch (`gn_partial`, then
// `gn_finalize`): the resnets' conv1 and conv2 read the block's input or
// hidden state once and never write a normalised copy.
//
// Accuracy: fp32, with TF32 tensor cores. Each fp32 operand is split into
// hi = rna_tf32(v) and lo = rna_tf32(v - hi), and a product is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo term is below fp32's
// rounding): three TF32 products for one fp32 one. The weights come split
// from the wrapper (once per weight tensor); the activations are split here,
// as they are loaded, after pre. The tensor cores' own fp32 accumulation is
// coarser than an FFMA's: kept over the whole of K (up to 4608) its error
// grew in proportion to K, to 20-30x cuDNN's; so the products of one (chunk, tap), 12 wgmma a
// warpgroup, go to a fresh accumulator that is then added into a second one
// in registers with round-to-nearest FADDs. Against an fp64 convolution B9's
// RMS error is then 2-4x below cuDNN's fp32 one at every VAE shape (PERF.md).
//
// What bounds it on the H100: the tensor cores. Three TF32 products a
// multiply-add give a ceiling of 495 / 3 = 165 TFLOP/s of fp32 products,
// against 67 TFLOP/s for FFMA; the bytes (x once, y once, the residual once,
// the weights from L2) are far below the memory's rate at every VAE shape.
//
// Design: an implicit GEMM over NHWC. A block owns 32 x 4 output pixels (128
// GEMM rows) of one sample and 128 output channels. Its input channels go in
// chunks of 32, one 128-byte swizzled row a pixel. A producer warpgroup
// (registers given to the consumers with setmaxnreg; one thread issues) loads,
// for every chunk, one TMA box of the input tile's halo (34 x 6 pixels at
// stride 1, 18 x 4 of the source at upsample; at stride 2 one box a tap,
// through a 5-d view that splits each spatial axis by parity), and for every
// (chunk, tap) the 32 x 128 slices of W_hi and W_lo, into mbarrier rings.
// Two consumer warpgroups of 64 output pixels each read their A fragments
// from the halo, at the tap's offset, with 16-byte loads: apply pre, zero the
// taps that fall in the padding (after pre, since silu(beta - mean * rstd *
// gamma) is not 0), split, and issue wgmma.m64n128k8.tf32 with A in
// registers, one commit group of six a 16 channels, the second group's
// fragments made while the first runs. The 16-byte load gives each thread 4
// adjacent channels where a TF32 fragment wants channels t and t + 4: the
// wrapper permutes the weights' channels inside every 16
// (`ops/vae_conv.py::K_ORDER`) to match. The epilogue adds the bias and the
// residual and stores NHWC fp32.

#include "hopper.cuh"

namespace {
namespace vc {

constexpr int TW = 32, TH = 4;               // output tile: 128 pixels
constexpr int BN = 128;                      // output channels a block
constexpr int KC = 32;                       // input channels a chunk
constexpr int CONSUMERS = 256;               // two warpgroups, 64 pixels each
constexpr int THREADS = CONSUMERS + 128;     // + the producer warpgroup
constexpr int B_STAGES = 4, A_STAGES = 3;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 40 * 128 + 232 * 256 = 168 * 384
constexpr uint32_t ROW = KC * 4;             // a pixel's 32 channels: 128 bytes
constexpr uint32_t B_HALF = BN * ROW;        // W_hi or W_lo of one (chunk, tap)
constexpr uint32_t B_SLOT = 2 * B_HALF;
constexpr int HALO_W = TW + 2, HALO_H = TH + 2;         // stride 1
constexpr int UP_W = TW / 2 + 2, UP_H = TH / 2 + 2;     // nearest 2x, in the source
constexpr uint32_t A_SLOT = 26624;           // the stride-1 halo (26,112 B), 1024-aligned
constexpr int MAX_GN_C = 512;                // channels of a GroupNorm prologue
constexpr size_t SMEM = 1024 + B_STAGES * B_SLOT + A_STAGES * A_SLOT + 3 * MAX_GN_C * 4 +
                        8 * 2 * (B_STAGES + A_STAGES);

enum Mode { S1 = 0, S2 = 1, UP = 2 };

template <int MODE>
__host__ __device__ constexpr uint32_t a_bytes() {
  return MODE == S1 ? HALO_W * HALO_H * ROW : MODE == S2 ? TW * TH * ROW : UP_W * UP_H * ROW;
}
static_assert(a_bytes<S1>() <= A_SLOT && A_SLOT % 1024 == 0, "A ring slot");

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// Thread (warp w of consumer warpgroup wg, lane 4g + t) owns GEMM rows g
// and g + 8 of its warpgroup's m64 block: tile pixel m = 64 wg + 16 w + g
// (+ 8), at row m / 32 and column m % 32.
template <int MODE, bool GN, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_whi,
            const __grid_constant__ CUtensorMap tm_wlo, const float* __restrict__ bias,
            const float* __restrict__ res, const float* __restrict__ gn, float* __restrict__ y,
            int H, int W, int Ho, int Wo, int Cin, int Cout) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t b_ring = base, a_ring = base + B_STAGES * B_SLOT;
  float* gns = reinterpret_cast<float*>(smem + B_STAGES * B_SLOT + A_STAGES * A_SLOT);
  const uint32_t bar0 = a_ring + A_STAGES * A_SLOT + 3 * MAX_GN_C * 4;
  auto b_full = [&](int s) { return bar0 + 8 * s; };
  auto b_empty = [&](int s) { return bar0 + 8 * (B_STAGES + s); };
  auto a_full = [&](int s) { return bar0 + 8 * (2 * B_STAGES + s); };
  auto a_empty = [&](int s) { return bar0 + 8 * (2 * B_STAGES + A_STAGES + s); };

  const int n_tiles = Cout / BN, tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + TH - 1) / TH;
  int idx = blockIdx.x;
  const int n0 = (idx % n_tiles) * BN;
  idx /= n_tiles;
  const int x0 = (idx % tiles_x) * TW;
  idx /= tiles_x;
  const int y0 = (idx % tiles_y) * TH;
  const int b = idx / tiles_y;
  const int chunks = Cin / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      hop::mbar_init(b_full(s), 1);
      hop::mbar_init(b_empty(s), CONSUMERS);
    }
    for (int s = 0; s < A_STAGES; ++s) {
      hop::mbar_init(a_full(s), 1);
      hop::mbar_init(a_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    hop::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int ia = 0, ib = 0;
      for (int c = 0; c < chunks; ++c) {
        for (int tap = 0; tap < 9; ++tap) {
          if (tap == 0 || MODE == S2) {
            const int s = ia % A_STAGES;
            if (ia >= A_STAGES) hop::mbar_wait(a_empty(s), (ia / A_STAGES - 1) & 1);
            hop::mbar_expect_tx(a_full(s), a_bytes<MODE>());
            const uint32_t dst = a_ring + s * A_SLOT;
            if constexpr (MODE == S1) {
              hop::tma_4d(dst, &tm_x, a_full(s), c * KC, x0 - 1, y0 - 1, b);
            } else if constexpr (MODE == UP) {
              hop::tma_4d(dst, &tm_x, a_full(s), c * KC, x0 / 2 - 1, y0 / 2 - 1, b);
            } else {
              // input pixel 2o + d - 1 = 2 (o + (d == 0 ? -1 : 0)) + (d == 1 ? 0 : 1)
              const int dy = tap / 3, dx = tap % 3;
              hop::tma_5d(dst, &tm_x, a_full(s), c * KC, dx == 1 ? 0 : 1, x0 - (dx == 0),
                          dy == 1 ? 0 : 1, b * (H / 2) + y0 - (dy == 0));
            }
            ++ia;
          }
          const int s = ib % B_STAGES;
          if (ib >= B_STAGES) hop::mbar_wait(b_empty(s), (ib / B_STAGES - 1) & 1);
          hop::mbar_expect_tx(b_full(s), B_SLOT);
          const int k = tap * Cin + c * KC;
          hop::tma_2d(b_ring + s * B_SLOT, &tm_whi, b_full(s), k, n0);
          hop::tma_2d(b_ring + s * B_SLOT + B_HALF, &tm_wlo, b_full(s), k, n0);
          ++ib;
        }
      }
    }
    return;
  }
  hop::regs_inc<CONSUMER_REGS>();

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  if constexpr (GN) {  // mean, rstd * gamma and beta of every channel of sample b
    for (int i = tid; i < 3 * Cin; i += CONSUMERS) gns[i] = gn[(size_t)b * 3 * Cin + i];
    hop::named_sync(1, CONSUMERS);
  }
  const int ty = 2 * wg + warp / 2, tx0 = (16 * warp + g) % TW;  // row g + 8: column tx0 + 8
  // which taps of this thread's row and of its two columns read inside the
  // (stride-1, upsampled or strided) input: bit d for tap offset d
  const int lim_y = MODE == UP ? Ho : H, lim_x = MODE == UP ? Wo : W;
  const int sy = MODE == S2 ? 2 : 1;
  uint32_t row_ok = 0, col_ok[2] = {0, 0};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int iy = sy * (y0 + ty) + d - 1;
    row_ok |= (iy >= 0 && iy < lim_y) ? 1u << d : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ix = sy * (x0 + tx0 + 8 * h) + d - 1;
      col_ok[h] |= (ix >= 0 && ix < lim_x) ? 1u << d : 0u;
    }
  }

  // Each tap's products go to `acc` afresh (its first product does not
  // accumulate) and are added into `tot` in fp32 when the tap is done: the
  // tensor cores' own accumulation then spans 12 products of one tap, not
  // the whole of K, and the sum over taps rounds to nearest.
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  uint32_t hi[2][2][4], lo[2][2][4];  // [16 channels][k-step of the 16][fragment]

  int ia = 0, ib = 0, a_slot = 0;
  for (int c = 0; c < chunks; ++c) {
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      if (tap == 0 || MODE == S2) {
        a_slot = ia % A_STAGES;
        hop::mbar_wait(a_full(a_slot), (ia / A_STAGES) & 1);
        ++ia;
      }
      const int b_slot = ib % B_STAGES;
      hop::mbar_wait(b_full(b_slot), (ib / B_STAGES) & 1);
      ++ib;
      const uint32_t a_base = a_ring + a_slot * A_SLOT, b_base = b_ring + b_slot * B_SLOT;
      // the halo row of each of this thread's two pixels at this tap
      int p[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tx = tx0 + 8 * h;
        if constexpr (MODE == S1) p[h] = (ty + dy) * HALO_W + tx + dx;
        else if constexpr (MODE == S2) p[h] = ty * TW + tx;
        else p[h] = ((ty + dy + 1) >> 1) * UP_W + ((tx + dx + 1) >> 1);
        ok[h] = ((row_ok >> dy) & (col_ok[h] >> dx) & 1u) != 0;
      }
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {  // 16 channels: two k-steps
        const int ch = 16 * blk + 4 * t;   // this thread's 4 channels of the chunk
        float v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t chunk16 = (uint32_t)(4 * blk + t) ^ (uint32_t)(p[h] & 7);
          const float4 r = lds4(a_base + p[h] * ROW + (chunk16 << 4));
          v[h][0] = r.x; v[h][1] = r.y; v[h][2] = r.z; v[h][3] = r.w;
        }
        if constexpr (GN) {
          const uint32_t gaddr = smem_u32(gns) + 4 * (c * KC + ch);
          const float4 mu = lds4(gaddr), sc = lds4(gaddr + 4 * Cin), be = lds4(gaddr + 8 * Cin);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h][0] = silu(fmaf(v[h][0] - mu.x, sc.x, be.x));
            v[h][1] = silu(fmaf(v[h][1] - mu.y, sc.y, be.y));
            v[h][2] = silu(fmaf(v[h][2] - mu.z, sc.z, be.z));
            v[h][3] = silu(fmaf(v[h][3] - mu.w, sc.w, be.w));
          }
        }
        // k-step kk2 of the 16: fragment column t holds channel 4t + 2 kk2,
        // column t + 4 channel 4t + 2 kk2 + 1 (K_ORDER); padding reads 0
#pragma unroll
        for (int kk2 = 0; kk2 < 2; ++kk2) {
          const float f[4] = {v[0][2 * kk2], v[1][2 * kk2], v[0][2 * kk2 + 1], v[1][2 * kk2 + 1]};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float fr = ok[r & 1] ? f[r] : 0.f;
            hi[blk][kk2][r] = tf32_rna(fr);
            lo[blk][kk2][r] = tf32_rna(fr - __uint_as_float(hi[blk][kk2][r]));
          }
        }
        hop::wgmma_fence();
#pragma unroll
        for (int kk2 = 0; kk2 < 2; ++kk2) {
          const uint32_t koff = (2 * blk + kk2) * 32;
          const uint64_t d_hi = hop::desc(b_base + koff), d_lo = hop::desc(b_base + B_HALF + koff);
          hop::wgmma_rs_tf32(acc, lo[blk][kk2], d_hi, blk + kk2);
          hop::wgmma_rs_tf32(acc, hi[blk][kk2], d_lo, 1);
          hop::wgmma_rs_tf32(acc, hi[blk][kk2], d_hi, 1);
        }
        hop::wgmma_commit();
      }
      hop::wgmma_wait<0>();
      hop::fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      hop::mbar_arrive(b_empty(b_slot));
      if (tap == 8 || MODE == S2) hop::mbar_arrive(a_empty(a_slot));
    }
  }

  // element 4n + e of the block: pixel row g + 8 (e >> 1), channel 8n + 2t + (e & 1)
  const int oy = y0 + ty;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ox = x0 + tx0 + 8 * h;
    if (oy >= Ho || ox >= Wo) continue;
    const size_t at = (((size_t)b * Ho + oy) * Wo + ox) * Cout + n0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + 8 * n + 2 * t);
      float2 o = make_float2(tot[4 * n + 2 * h] + bb.x, tot[4 * n + 2 * h + 1] + bb.y);
      if constexpr (RES) {
        const float2 r = *reinterpret_cast<const float2*>(res + at + 8 * n);
        o.x += r.x;
        o.y += r.y;
      }
      *reinterpret_cast<float2*>(y + at + 8 * n) = o;
    }
  }
}

// GroupNorm statistics, launch 1: partial sums over a slab of `rows` pixels
// of one sample (grid: slabs, B), of (x - k) and (x - k)^2 in fp64 a group,
// k the group's first value in the sample (a shift, so that a large mean
// does not cancel). A thread owns 4 channels (one group) and every
// (256 / (C / 4))-th pixel; the block adds its threads' sums in a fixed order.
__global__ void __launch_bounds__(256)
gn_partial(const float* __restrict__ x, int HW, int C, int G, int rows, double* __restrict__ ws) {
  __shared__ double red[256][2];
  const int b = blockIdx.y, s = blockIdx.x, slabs = gridDim.x, tid = threadIdx.x;
  const int nc = C / 4, rp = 256 / nc, cg = C / G;
  const int col = tid % nc, r = tid / nc;
  const float* xs = x + (size_t)b * HW * C;
  double sum = 0.0, sq = 0.0;
  if (r < rp) {
    const double k = xs[(4 * col / cg) * cg];
    const int p1 = min(HW, (s + 1) * rows);
    for (int p = s * rows + r; p < p1; p += rp) {
      const float4 v = *reinterpret_cast<const float4*>(xs + (size_t)p * C + 4 * col);
      const double d0 = v.x - k, d1 = v.y - k, d2 = v.z - k, d3 = v.w - k;
      sum += (d0 + d1) + (d2 + d3);
      sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  }
  red[tid][0] = sum;
  red[tid][1] = sq;
  __syncthreads();
  if (tid < G) {
    double gs = 0.0, gq = 0.0;
    for (int rr = 0; rr < rp; ++rr) {
      for (int cc = tid * cg / 4; cc < (tid + 1) * cg / 4; ++cc) {
        gs += red[rr * nc + cc][0];
        gq += red[rr * nc + cc][1];
      }
    }
    double* out = ws + (((size_t)b * slabs + s) * G + tid) * 2;
    out[0] = gs;
    out[1] = gq;
  }
}

// Launch 2 (grid: B, C threads): each channel's group statistics, merged
// over the slabs in order, as [mean, rstd * gamma, beta] a channel: the
// [B, 3, C] table the convolution's prologue copies.
__global__ void gn_finalize(const float* __restrict__ x, const double* __restrict__ ws,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ gn, int HW, int C, int G, int slabs, float eps) {
  const int b = blockIdx.x, c = threadIdx.x, cg = C / G, grp = c / cg;
  double s = 0.0, q = 0.0;
  for (int i = 0; i < slabs; ++i) {
    const double* w = ws + (((size_t)b * slabs + i) * G + grp) * 2;
    s += w[0];
    q += w[1];
  }
  const double n = (double)HW * cg, m = s / n;
  const double var = fmax(q / n - m * m, 0.0);
  const double rstd = 1.0 / sqrt(var + (double)eps);
  float* out = gn + (size_t)b * 3 * C;
  out[c] = (float)((double)x[(size_t)b * HW * C + grp * cg] + m);
  out[C + c] = (float)(rstd * gamma[c]);
  out[2 * C + c] = beta[c];
}

// NHWC fp32 [B, H, W, C] as a 4-d map (C, W, H, B) of boxes of 32 channels x
// bw x bh pixels, 128-byte swizzle; pixels outside read as zeros.
bool map_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4, (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {KC, (cuuint32_t)bw, (cuuint32_t)bh, 1}, unit[4] = {1, 1, 1, 1};
  hop::EncodeTiled fn = hop::encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same tensor (H and W even) as (C, W parity, W / 2, H parity, B * H / 2):
// a box at fixed parities is one tap's input pixels of a stride-2 tile.
bool map_nhwc_s2(CUtensorMap* map, const void* ptr, int B, int H, int W, int C) {
  const cuuint64_t dims[5] = {(cuuint64_t)C, 2, (cuuint64_t)W / 2, 2, (cuuint64_t)B * H / 2};
  const cuuint64_t strides[4] = {(cuuint64_t)C * 4, (cuuint64_t)C * 8, (cuuint64_t)W * C * 4,
                                 (cuuint64_t)W * C * 8};
  const cuuint32_t box[5] = {KC, 1, TW, 1, TH}, unit[5] = {1, 1, 1, 1, 1};
  hop::EncodeTiled fn = hop::encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Weights [Cout, 9 Cin] fp32 as a 2-d map of 32 x 128 boxes, 128-byte swizzle.
bool map_w(CUtensorMap* map, const void* ptr, int K, int Cout) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)Cout}, strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {KC, BN}, unit[2] = {1, 1};
  hop::EncodeTiled fn = hop::encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, bool GN, bool RES>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mhi, const CUtensorMap& mlo,
                   const float* bias, const float* res, const float* gn, float* y, int B, int H,
                   int W, int Ho, int Wo, int Cin, int Cout, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(conv_kernel<MODE, GN, RES>);
  cudaError_t err = allow_smem(fn, SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW) * (Cout / BN);
  conv_kernel<MODE, GN, RES><<<(unsigned)blocks, THREADS, SMEM, stream>>>(
      mx, mhi, mlo, bias, res, gn, y, H, W, Ho, Wo, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace vc
}  // namespace

// y [B, Ho, Wo, Cout] = conv3x3(pre(x)) + bias [+ res]; x [B, H, W, Cin], all
// NHWC fp32 contiguous and 16-byte aligned; w_hi, w_lo [Cout, 9 Cin] in the
// wrapper's order; gn [B, 3, Cin] (GroupNorm+SiLU as pre) or null; res or
// null. mode 0: stride 1 (Ho = H); 1: stride 2 (H, W even; Ho = H / 2); 2:
// nearest 2x upsample first (Ho = 2H). The wrapper's plan (ops/vae_conv.py)
// checks the shapes: Cin a multiple of 32 (at most 512 with gn), Cout of 128.
extern "C" int diffsensei_vae_conv(const void* x, const void* w_hi, const void* w_lo,
                                   const void* bias, const void* res, const void* gn, void* y,
                                   int B, int H, int W, int Cin, int Cout, int mode,
                                   cudaStream_t stream) {
  using namespace vc;
  if (mode < 0 || mode > 2 || Cin % KC || Cout % BN || (gn != nullptr && (mode != S1 || Cin > MAX_GN_C)) ||
      (mode != S1 && res != nullptr) || (mode == S2 && (H % 2 || W % 2))) {
    return (int)cudaErrorInvalidValue;
  }
  const int Ho = mode == S2 ? H / 2 : mode == UP ? 2 * H : H;
  const int Wo = mode == S2 ? W / 2 : mode == UP ? 2 * W : W;
  CUtensorMap mx, mhi, mlo;
  const bool ok = (mode == S2 ? map_nhwc_s2(&mx, x, B, H, W, Cin)
                   : mode == UP ? map_nhwc(&mx, x, B, H, W, Cin, UP_W, UP_H)
                                : map_nhwc(&mx, x, B, H, W, Cin, HALO_W, HALO_H)) &&
                  map_w(&mhi, w_hi, 9 * Cin, Cout) && map_w(&mlo, w_lo, 9 * Cin, Cout);
  if (!ok) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const float* r = static_cast<const float*>(res);
  const float* n = static_cast<const float*>(gn);
  float* o = static_cast<float*>(y);
  cudaError_t err;
  if (mode == S2) {
    err = launch<S2, false, false>(mx, mhi, mlo, b, r, n, o, B, H, W, Ho, Wo, Cin, Cout, stream);
  } else if (mode == UP) {
    err = launch<UP, false, false>(mx, mhi, mlo, b, r, n, o, B, H, W, Ho, Wo, Cin, Cout, stream);
  } else if (gn != nullptr) {
    err = res != nullptr
              ? launch<S1, true, true>(mx, mhi, mlo, b, r, n, o, B, H, W, Ho, Wo, Cin, Cout, stream)
              : launch<S1, true, false>(mx, mhi, mlo, b, r, n, o, B, H, W, Ho, Wo, Cin, Cout, stream);
  } else {
    err = res != nullptr
              ? launch<S1, false, true>(mx, mhi, mlo, b, r, n, o, B, H, W, Ho, Wo, Cin, Cout, stream)
              : launch<S1, false, false>(mx, mhi, mlo, b, r, n, o, B, H, W, Ho, Wo, Cin, Cout, stream);
  }
  return (int)err;
}

// The GroupNorm+SiLU table gn [B, 3, C] of x [B, HW, C] fp32 (C a multiple of
// 4 and at most 1024, C / G a multiple of 4): two launches over `slabs` slabs
// a sample, ws [B, slabs, G, 2] fp64 their scratch.
extern "C" int diffsensei_vae_gn_stats(const void* x, const void* gamma, const void* beta,
                                       void* ws, void* gn, int B, int HW, int C, int G,
                                       float eps, int slabs, cudaStream_t stream) {
  if (C % 4 || C > 1024 || G < 1 || C % G || (C / G) % 4 || slabs < 1 || HW < 1 || G > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = (HW + slabs - 1) / slabs;
  vc::gn_partial<<<dim3(slabs, B), 256, 0, stream>>>(static_cast<const float*>(x), HW, C, G, rows,
                                                      static_cast<double*>(ws));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vc::gn_finalize<<<B, C, 0, stream>>>(static_cast<const float*>(x), static_cast<const double*>(ws),
                                        static_cast<const float*>(gamma),
                                        static_cast<const float*>(beta), static_cast<float*>(gn), HW,
                                        C, G, slabs, eps);
  return (int)cudaGetLastError();
}
