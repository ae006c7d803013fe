// GroupNorm + SiLU over NHWC memory for Hopper (sm_90a): kernel B3.
//
// Replaces the Pallas TPU kernel `_gn_silu_kernel`
// (diffsensei_tpu/ops/groupnorm.py:44, pallas_call at :76), which held a whole
// sample in VMEM. Computes, for x [B, HW, C] in bf16 or fp32 with G groups of
// cg = C / G channels,
//   y = silu((x - mean) * rstd * scale + bias),  rstd = 1 / sqrt(var + eps),
// with the mean and variance per (sample, group) over HW x cg values, in fp32,
// and y in x's type. The statistics are taken of x less a shift a group (its
// first value) as a mean, then the squared deviations from it, and partial
// statistics (count, mean, M2) are merged with Chan's formula; the TPU's
// one-pass E[x^2] - E[x]^2 loses precision over a VAE group's 4M values and
// is not used.
//
// What bounds it on the H100: a few operations a byte, so one read and one
// write of x at 3.35 TB/s, in pieces long enough for the memory. (Strips of
// a few whole groups held by thread-block clusters, the design kept in
// tools/groupnorm_cluster_probe.cu, measured 1.1-1.65x this kernel's time on
// the H100: the clusters the card holds at once do not hold x, and wider
// strips leave SMs idle; PERF.md.) So a slab is a run of whole rows of one
// sample, contiguous in memory. A thread owns one vector of VEC bytes (16, 8
// or 4) of a row (resident) or of a strip of whole groups (streaming) and
// every P-th row, so it keeps one set of channels, hence one shift, scale and
// bias, for the whole call. The wrapper's plan (ops/groupnorm.py) picks one
// of two routes from the shape:
//   * resident, one launch, where x fits in the shared memory of a grid of
//     one block an SM (about 25 MB: every UNet shape of 21 MB and less): a
//     cooperative grid, every block resident at once, each block copies its
//     slab into shared memory once (cp.async), takes each channel's mean of
//     a thread's rows, then their M2 about it, from shared memory, and writes
//     a partial (count, mean, M2) a group; after one grid barrier every block
//     merges its sample's partials in a fixed order and normalizes its slab
//     from shared memory: one read and one write of x;
//   * streaming, two launches, where x is larger: launch 1 streams each slab
//     through registers, 8 rows a thread at a time (a mean, then the squared
//     deviations, merged into the thread's running statistics), and writes
//     the partials; launch 2 merges them the same way, then normalizes its
//     slab, walking its rows in the reverse of launch 1's order so that its
//     first reads find the tail launch 1 left in the 50 MB L2. Two reads and
//     one write.
// The slabs depend on the shape alone, every sum is taken in a fixed order,
// and there are no atomics in the arithmetic: two calls, on any streams, give
// the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace coop = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int KR = 8;                   // rows a thread loads at once when streaming
constexpr int MAX_NG = 32;              // groups a streaming strip
constexpr int MAX_GROUPS = 256;         // groups a resident call
constexpr int SCRATCH = THREADS * 8;    // floats: one a value of a thread's vector
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block may use
// a resident block's shared memory after its slab: a thread's mean and M2 a
// value of its vector, its count, and the merged (mean, rstd) and the shift
// a group
constexpr int EXTRA_BYTES = (2 * SCRATCH + THREADS + 3 * MAX_GROUPS) * 4;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(VEC) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// VEC bytes as 32-bit words, from device memory (read-only path) or shared memory
template <int VEC>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[VEC / 4], bool global) {
  if constexpr (VEC == 16) {
    const uint4 v = global ? __ldg(reinterpret_cast<const uint4*>(p))
                           : *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (VEC == 8) {
    const uint2 v = global ? __ldg(reinterpret_cast<const uint2*>(p))
                           : *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = global ? __ldg(reinterpret_cast<const unsigned int*>(p))
                  : *reinterpret_cast<const unsigned int*>(p);
  }
}

// VEC bytes of T held as 32-bit words -> VEC / sizeof(T) floats (a bf16
// pair: element 2i low)
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint32_t (&w)[VEC / 4], float (&f)[VEC / sizeof(T)]) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC / sizeof(T)], bool global) {
  uint32_t w[VEC / 4];
  load_words<VEC>(p, w, global);
  unpack<T, VEC>(w, f);
}

// VEC / sizeof(T) floats -> VEC bytes of T in device memory (bf16: round to nearest even)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC / sizeof(T)]) {
  uint32_t w[VEC / 4];
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned int*>(p) = w[0];
  }
}

__device__ __forceinline__ float param(const void* p, int f32, int i) {
  return f32 ? reinterpret_cast<const float*>(p)[i]
             : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

// A group's shift: its first value in the sample (row 0, its first channel).
// The statistics are taken of x - shift: at a mean of 1e3 fp32 resolves 6e-5,
// too coarse for the differences of slab means that Chan's formula adds into
// the variance.
template <typename T>
__device__ __forceinline__ float group_shift(const T* x, size_t offset) {
  if constexpr (sizeof(T) == 4) {
    return x[offset];
  } else {
    return __bfloat162float(x[offset]);
  }
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// Sums v over aligned runs of `width` lanes (a power of two up to 32) in a
// balanced tree: every lane of a run ends with the same bits. Every lane of
// the warp must call it.
__device__ __forceinline__ float lane_sum(float v, int width) {
  for (int o = 1; o < width; o <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// part [slabs][ng] (count, mean, M2, -) of one strip's slabs -> coef[2j] the
// mean and coef[2j + 1] 1 / sqrt(var + eps) of each group j: tg lanes a
// group, lane l taking slabs l, l + tg, ... (its first sixteen loaded at once
// and kept for the second pass); the mean from the sums of the counts and of
// the count-weighted means, then the variance from the sum of the M2s and of
// the slabs' squared deviations from that mean (Chan's formula over all
// slabs at once). The resident kernel reads partials other blocks wrote in
// the same launch, so they are not read through the read-only path. Every
// thread of the block must call it.
__device__ __forceinline__ void merge_partials(const float4* part, int slabs, int ng, float eps,
                                               float* coef) {
  int tg = 32;
  while (tg > 1 && tg * ng > THREADS) tg >>= 1;
  const int j = threadIdx.x / tg, l = threadIdx.x % tg;
  const bool live = j < ng;
  auto load = [&](float4(&e)[16], int s0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = s0 + i * tg;
      e[i] = live && q < slabs ? part[(size_t)q * ng + j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  float4 first[16];
  load(first, l);
  float n = 0.0f, nm = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    n += first[i].x;
    nm = fmaf(first[i].x, first[i].y, nm);
  }
  for (int s0 = l + 16 * tg; s0 < slabs; s0 += 16 * tg) {
    float4 e[16];
    load(e, s0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      n += e[i].x;
      nm = fmaf(e[i].x, e[i].y, nm);
    }
  }
  n = lane_sum(n, tg);
  const float mean = lane_sum(nm, tg) / n;
  float m2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = first[i].y - mean;
    m2 += first[i].z + first[i].x * d * d;
  }
  for (int s0 = l + 16 * tg; s0 < slabs; s0 += 16 * tg) {
    float4 e[16];
    load(e, s0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float d = e[i].y - mean;
      m2 += e[i].z + e[i].x * d * d;
    }
  }
  m2 = lane_sum(m2, tg);
  if (live && l == 0) {
    coef[2 * j] = mean;
    coef[2 * j + 1] = rsqrtf(m2 / n + eps);
  }
}

// A block's entries (n[p], mean[p][w], m2[p][w], p < P, w < W: the count of
// a phase's values in a channel, their mean and their M2 about it) -> out[j]
// = (count, mean, M2) of each of its ng groups of cg channels: a warp a
// group, the mean from the sums of counts and count-weighted means, then the
// M2s and the squared deviations from it. A fixed order.
__device__ __forceinline__ void merge_entries(const float* ent_n, const float* ent_mean,
                                              const float* ent_m2, int P, int W, int cg, int ng,
                                              float4* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_cg = 1.0f / (float)cg;
  // entry i of a group: phase i / cg, channel i % cg (i < P * cg <= 4096: the
  // float quotient is exact after one correction)
  auto split = [&](int i, int& pp, int& cc) {
    pp = (int)((float)i * inv_cg);
    pp -= pp * cg > i;
    pp += (pp + 1) * cg <= i;
    cc = i - pp * cg;
  };
  for (int j = warp; j < ng; j += WARPS) {
    float gn = 0.0f, gnm = 0.0f;
    for (int i = lane; i < P * cg; i += 32) {
      int pp, cc;
      split(i, pp, cc);
      gn += ent_n[pp];
      gnm = fmaf(ent_n[pp], ent_mean[pp * W + j * cg + cc], gnm);
    }
    gn = lane_sum(gn, 32);
    const float gm = lane_sum(gnm, 32) / gn;
    float gm2 = 0.0f;
    for (int i = lane; i < P * cg; i += 32) {
      int pp, cc;
      split(i, pp, cc);
      const float d = ent_mean[pp * W + j * cg + cc] - gm;
      gm2 += ent_m2[pp * W + j * cg + cc] + ent_n[pp] * d * d;
    }
    gm2 = lane_sum(gm2, 32);
    if (lane == 0) out[j] = make_float4(gn, gm, gm2, 0.0f);
  }
}

// Resident route. A cooperative grid (slabs, 1, batch), every block resident
// at once: block (s, b) owns rows [hw * s / slabs, hw * (s + 1) / slabs) of
// sample b, every channel (a row is at most one vector a thread), held in
// shared memory from load to store.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) resident_kernel(
    const T* __restrict__ x, T* __restrict__ y, float4* __restrict__ part,
    const void* __restrict__ scale, const void* __restrict__ bias, int scale_f32, int bias_f32,
    int hw, int c, int cg, int groups, int slabs, float eps) {
  constexpr int EPV = VEC / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, b = blockIdx.z;
  const int r0 = (int)((long long)hw * s / slabs);
  const int rows = (int)((long long)hw * (s + 1) / slabs) - r0;
  const int rows_max = (hw + slabs - 1) / slabs;
  T* const slab = reinterpret_cast<T*>(smem);
  float* const ent_mean = reinterpret_cast<float*>(smem + align16((size_t)rows_max * c * sizeof(T)));
  float* const ent_m2 = ent_mean + SCRATCH;         // [phase][channel]
  float* const ent_n = ent_m2 + SCRATCH;            // [phase]
  float* const coef = ent_n + THREADS;              // [group][2]: merged mean, rstd
  float* const shift = coef + 2 * MAX_GROUPS;       // [group]
  const size_t x0 = ((size_t)b * hw + r0) * c;      // the slab's first element

  // the groups' shifts and this thread's channels' scales and biases first,
  // then the slab, contiguous, into shared memory
  const int U = c / EPV, P = THREADS / U;
  const int u = threadIdx.x % U, p = threadIdx.x / U, col0 = u * EPV;
  const bool active = p < P;
  if (threadIdx.x < groups) shift[threadIdx.x] = group_shift(x, (size_t)b * hw * c + threadIdx.x * cg);
  float a[EPV], sh[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    a[e] = param(scale, scale_f32, col0 + e);
    sh[e] = param(bias, bias_f32, col0 + e);
  }
  const int nvec = rows * (c / EPV);
  for (int i = threadIdx.x; i < nvec; i += THREADS) cp_async<VEC>(slab + i * EPV, x + x0 + i * EPV);
  cp_async_wait_all();
  __syncthreads();
  float ks[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) ks[e] = shift[(col0 + e) / cg];

  // statistics: a thread's values of each channel (rows p, p + P, ...),
  // their mean, then their M2 about it, from shared memory; then the
  // block's partial a group
  const int mine = active && rows > p ? (rows - p + P - 1) / P : 0;   // this thread's rows
  const T* const sp = slab + p * c + col0;
  float acc[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < mine; ++i) {
    float v[EPV];
    load_vec<T, VEC>(sp + i * P * c, v, false);
#pragma unroll
    for (int e = 0; e < EPV; ++e) acc[e] += v[e] - ks[e];
  }
  float mu[EPV];
  const float inv = mine > 0 ? 1.0f / (float)mine : 0.0f;
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    mu[e] = acc[e] * inv;
    acc[e] = 0.0f;
  }
#pragma unroll 4
  for (int i = 0; i < mine; ++i) {
    float v[EPV];
    load_vec<T, VEC>(sp + i * P * c, v, false);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const float d = (v[e] - ks[e]) - mu[e];
      acc[e] = fmaf(d, d, acc[e]);
    }
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      if constexpr (EPV % 4 == 0) {                 // 16-byte stores: no bank conflicts
        if (e % 4 == 0) {
          *reinterpret_cast<float4*>(ent_mean + p * c + col0 + e) =
              make_float4(mu[e], mu[e + 1], mu[e + 2], mu[e + 3]);
          *reinterpret_cast<float4*>(ent_m2 + p * c + col0 + e) =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        }
      } else {
        ent_mean[p * c + col0 + e] = mu[e];
        ent_m2[p * c + col0 + e] = acc[e];
      }
    }
    if (u == 0) ent_n[p] = (float)mine;
  }
  __syncthreads();
  merge_entries(ent_n, ent_mean, ent_m2, P, c, cg, groups,
                part + ((size_t)b * slabs + s) * groups);

  // every block's partials written (the grid barrier orders them before the
  // reads); merge the sample's in a fixed order
  coop::this_grid().sync();
  merge_partials(part + (size_t)b * slabs * groups, slabs, groups, eps, coef);
  __syncthreads();
  if (!active) return;

  // normalize, affine and SiLU from shared memory
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    const int j = (col0 + e) / cg;
    mu[e] = coef[2 * j];
    a[e] *= coef[2 * j + 1];
  }
  T* const yp = y + x0 + (size_t)p * c + col0;
#pragma unroll 4
  for (int i = 0; i < mine; ++i) {
    float v[EPV];
    load_vec<T, VEC>(sp + i * P * c, v, false);
#pragma unroll
    for (int e = 0; e < EPV; ++e) v[e] = silu(fmaf((v[e] - ks[e]) - mu[e], a[e], sh[e]));
    store_vec<T, VEC>(yp + (size_t)i * P * c, v);
  }
}

// Streaming route, launch 1. Grid (slabs, strips, batch): block (s, strip, b)
// owns rows [hw * s / slabs, hw * (s + 1) / slabs) of the strip (ng whole
// groups) and writes part[b][strip][s][j] = (count, mean, M2) for each group
// j of the strip.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) stream_stats_kernel(
    const T* __restrict__ x, float4* __restrict__ part, int hw, int c, int cg, int ng, int slabs) {
  constexpr int EPV = VEC / (int)sizeof(T);
  __shared__ float ent_mean[SCRATCH], ent_m2[SCRATCH], ent_n[THREADS];
  const int s = blockIdx.x, strip = blockIdx.y, b = blockIdx.z, strips = gridDim.y;
  const int W = ng * cg, U = W / EPV, P = THREADS / U;
  const int u = threadIdx.x % U, p = threadIdx.x / U;
  const bool active = p < P;
  const int r0 = (int)((long long)hw * s / slabs);
  const int rows = (int)((long long)hw * (s + 1) / slabs) - r0;
  const size_t base = ((size_t)b * hw + r0) * c + (size_t)strip * W + (size_t)u * EPV;
  float ks[EPV];                    // loaded beside the first rows, not before them
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    ks[e] = group_shift(x, (size_t)b * hw * c + (size_t)strip * W + (u * EPV + e) / cg * cg);
  }

  // the thread's rows p, p + P, ... in chunks of KR: a chunk's mean, its
  // squared deviations, merged into the running (n, mean, M2) of each value;
  // the next chunk's loads are in flight while a chunk is summed
  float n = 0.0f, mean[EPV], m2[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) mean[e] = m2[e] = 0.0f;
  if (active) {
    const int nr = rows > p ? (rows - p + P - 1) / P : 0;
    auto fetch = [&](uint32_t(&w)[KR][VEC / 4], int i0) {
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        if (i0 + kk < nr) load_words<VEC>(x + base + (size_t)(p + (i0 + kk) * P) * c, w[kk], true);
      }
    };
    auto consume = [&](const uint32_t(&w)[KR][VEC / 4], int i0) {
      const int k = min(KR, nr - i0);
      const float kf = (float)k, nn = n + kf, f = kf / nn, inv_k = 1.0f / kf;
      float cm[EPV], cm2[EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e) cm[e] = cm2[e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        float v[EPV];
        unpack<T, VEC>(w[kk], v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) cm[e] += kk < k ? v[e] - ks[e] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) cm[e] *= inv_k;
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        float v[EPV];
        unpack<T, VEC>(w[kk], v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          const float d = (v[e] - ks[e]) - cm[e];
          cm2[e] = kk < k ? fmaf(d, d, cm2[e]) : cm2[e];
        }
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const float d = cm[e] - mean[e];
        mean[e] = fmaf(d, f, mean[e]);
        m2[e] = m2[e] + cm2[e] + d * d * n * f;
      }
      n = nn;
    };
    uint32_t wa[KR][VEC / 4], wb[KR][VEC / 4];
    fetch(wa, 0);
    for (int i0 = 0; i0 < nr; i0 += 2 * KR) {
      fetch(wb, i0 + KR);
      consume(wa, i0);
      if (i0 + KR >= nr) break;
      fetch(wa, i0 + 2 * KR);
      consume(wb, i0 + KR);
    }
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      ent_mean[p * W + u * EPV + e] = mean[e];
      ent_m2[p * W + u * EPV + e] = m2[e];
    }
    if (u == 0) ent_n[p] = n;
  }
  __syncthreads();

  merge_entries(ent_n, ent_mean, ent_m2, P, W, cg, ng,
                part + (((size_t)b * strips + strip) * slabs + s) * ng);
}

// Streaming route, launch 2, on launch 1's grid: merge the strip's partials,
// then normalize the slab, its rows in the reverse of launch 1's order.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) stream_apply_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float4* __restrict__ part,
    const void* __restrict__ scale, const void* __restrict__ bias, int scale_f32, int bias_f32,
    int hw, int c, int cg, int ng, int slabs, float eps) {
  constexpr int EPV = VEC / (int)sizeof(T);
  __shared__ float coef[2 * MAX_NG], shift[MAX_NG];
  const int s = blockIdx.x, strip = blockIdx.y, b = blockIdx.z, strips = gridDim.y;
  const int W = ng * cg, U = W / EPV, P = THREADS / U;
  if (threadIdx.x < ng) {
    shift[threadIdx.x] = group_shift(x, (size_t)b * hw * c + (size_t)strip * W + threadIdx.x * cg);
  }
  merge_partials(part + ((size_t)b * strips + strip) * slabs * ng, slabs, ng, eps, coef);
  __syncthreads();

  const int u = threadIdx.x % U, p = threadIdx.x / U;
  if (p >= P) return;
  const int r0 = (int)((long long)hw * s / slabs);
  const int rows = (int)((long long)hw * (s + 1) / slabs) - r0;
  const size_t base = ((size_t)b * hw + r0) * c + (size_t)strip * W + (size_t)u * EPV;
  float ks[EPV], mu[EPV], a[EPV], sh[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    const int col = u * EPV + e, j = col / cg, ch = strip * W + col;
    ks[e] = shift[j];
    mu[e] = coef[2 * j];
    a[e] = coef[2 * j + 1] * param(scale, scale_f32, ch);
    sh[e] = param(bias, bias_f32, ch);
  }
  // chunks of KR of the thread's rows, last first; the next chunk's loads
  // are in flight while a chunk is normalized and stored
  const int nr = rows > p ? (rows - p + P - 1) / P : 0;
  auto fetch = [&](uint32_t(&w)[KR][VEC / 4], int i0) {
#pragma unroll
    for (int kk = 0; kk < KR; ++kk) {
      if (i0 >= 0 && i0 + kk < nr) {
        load_words<VEC>(x + base + (size_t)(p + (i0 + kk) * P) * c, w[kk], true);
      }
    }
  };
  auto emit = [&](const uint32_t(&w)[KR][VEC / 4], int i0) {
#pragma unroll
    for (int kk = 0; kk < KR; ++kk) {
      if (i0 + kk < nr) {
        float v[EPV];
        unpack<T, VEC>(w[kk], v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) v[e] = silu(fmaf((v[e] - ks[e]) - mu[e], a[e], sh[e]));
        store_vec<T, VEC>(y + base + (size_t)(p + (i0 + kk) * P) * c, v);
      }
    }
  };
  uint32_t wa[KR][VEC / 4], wb[KR][VEC / 4];
  const int last = nr > 0 ? (nr - 1) / KR * KR : -1;
  fetch(wa, last);
  for (int i0 = last; i0 >= 0; i0 -= 2 * KR) {
    fetch(wb, i0 - KR);
    emit(wa, i0);
    if (i0 - KR < 0) break;
    fetch(wa, i0 - 2 * KR);
    emit(wb, i0 - KR);
  }
}

int resident_smem(int hw, int slabs, int row_bytes) {
  return (int)align16((size_t)((hw + slabs - 1) / slabs) * row_bytes) + EXTRA_BYTES;
}

// Lets the resident kernel use all of a block's shared memory, once a device.
template <typename T, int VEC>
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(resident_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

struct Shape {
  int batch, hw, c, cg, groups, ng, slabs, es;
};

template <typename T, int VEC>
cudaError_t run(const Shape& s, int streaming, const void* x, void* y, const void* scale,
                const void* bias, int scale_f32, int bias_f32, float eps, float4* workspace,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaError_t err;
  if (!streaming) {
    const int smem = resident_smem(s.hw, s.slabs, s.c * s.es);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    err = prepare<T, VEC>();
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(s.slabs, 1, s.batch);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, resident_kernel<T, VEC>, xt, yt, workspace, scale, bias,
                             scale_f32, bias_f32, s.hw, s.c, s.cg, s.groups, s.slabs, eps);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const dim3 grid(s.slabs, s.groups / s.ng, s.batch);
  stream_stats_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(xt, workspace, s.hw, s.c, s.cg, s.ng,
                                                            s.slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stream_apply_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
      xt, yt, workspace, scale, bias, scale_f32, bias_f32, s.hw, s.c, s.cg, s.ng, s.slabs, eps);
  return cudaGetLastError();
}

// Calls fn(T{}, integral_constant<VEC>) for x's type and the vector width.
template <typename Fn>
cudaError_t dispatch(int x_f32, int vec, Fn&& fn) {
  using I16 = std::integral_constant<int, 16>;
  using I8 = std::integral_constant<int, 8>;
  using I4 = std::integral_constant<int, 4>;
  if (x_f32) {
    if (vec == 16) return fn(float{}, I16{});
    if (vec == 8) return fn(float{}, I8{});
    return fn(float{}, I4{});
  }
  if (vec == 16) return fn(__nv_bfloat16{}, I16{});
  if (vec == 8) return fn(__nv_bfloat16{}, I8{});
  return fn(__nv_bfloat16{}, I4{});
}

// Checks a plan; fills s. 0 when the kernels take it.
int check(int x_f32, int batch, int hw, int c, int groups, int streaming, int ng, int slabs,
          int vec, Shape* s) {
  const int es = x_f32 ? 4 : 2;
  if (batch < 1 || batch > 65535 || hw < 1 || groups < 1 || c % groups || slabs < 1 ||
      slabs > hw)
    return 1;
  if (!(vec == 16 || vec == 8 || vec == 4) || (c * es) % vec) return 1;
  const int cg = c / groups;
  if (streaming) {
    const int strip_bytes = ng * cg * es;
    if (ng < 1 || ng > MAX_NG || groups % ng || strip_bytes % vec || strip_bytes / vec > THREADS)
      return 1;
  } else if (ng != groups || groups > MAX_GROUPS || c * es / vec > THREADS) {
    return 1;
  }
  *s = Shape{batch, hw, c, cg, groups, ng, slabs, es};
  return 0;
}

}  // namespace

// y = silu(groupnorm(x) * scale + bias) over x [batch, hw, c] (bf16, or fp32
// when x_f32) with `groups` groups; scale and bias [c], fp32 or bf16 each.
// The plan: streaming 0 (one cooperative launch; ng = groups, slabs a sample
// all resident at once) or 1 (two launches; strips of ng groups, slabs a
// strip); vec bytes a thread's access. The workspace holds batch * (groups /
// ng) * slabs * ng * 4 floats, 16-byte aligned. x, y contiguous and aligned
// to vec bytes.
// Returns a cudaError_t.
extern "C" int diffsensei_groupnorm_silu(const void* x, void* y, const void* scale,
                                         const void* bias, int x_f32, int scale_f32, int bias_f32,
                                         int batch, int hw, int c, int groups, float eps,
                                         int streaming, int ng, int slabs, int vec,
                                         void* workspace, void* stream) {
  Shape s;
  if (check(x_f32, batch, hw, c, groups, streaming, ng, slabs, vec, &s) || workspace == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(y) % vec ||
      reinterpret_cast<uintptr_t>(workspace) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(x_f32, vec, [&](auto t, auto v) {
    using T = decltype(t);
    return run<T, decltype(v)::value>(s, streaming, x, y, scale, bias, scale_f32, bias_f32, eps,
                                      static_cast<float4*>(workspace), st);
  });
}

// How a plan fills the card: out = {blocks an SM of its (first) kernel,
// blocks an SM of the streaming route's second kernel (0 when resident), the
// resident block's shared memory bytes (0 when streaming), the card's SMs}.
extern "C" int diffsensei_groupnorm_layout(int x_f32, int batch, int hw, int c, int groups,
                                           int streaming, int ng, int slabs, int vec, int* out) {
  Shape s;
  if (check(x_f32, batch, hw, c, groups, streaming, ng, slabs, vec, &s)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch(x_f32, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    out[0] = out[1] = out[2] = out[3] = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (streaming) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], stream_stats_kernel<T, V>,
                                                          THREADS, 0);
      if (err != cudaSuccess) return err;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], stream_apply_kernel<T, V>,
                                                           THREADS, 0);
    }
    const int smem = resident_smem(s.hw, s.slabs, s.c * s.es);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    err = prepare<T, V>();
    if (err != cudaSuccess) return err;
    out[2] = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], resident_kernel<T, V>, THREADS,
                                                         smem);
  });
}
