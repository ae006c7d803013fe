// Packed-int4 weight-only decode matmul for Hopper (sm_90a): kernel B6.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (diffsensei_tpu/ops/int4_matmul.py:125, pallas_call at :197). Computes
//   y[T, F] = bf16(x)[T, in] @ dequant(packed, scale),  1 <= T <= 16, fp32 out,
// where x is fp32 or bf16 (an fp32 x is rounded to bf16 here, round to nearest
// even, as the JAX entry rounds it), packed is uint8 [in, F/2] in the
// split-half layout (byte column j holds output column j in its low nibble,
// stored as q + 8, and output column F/2 + j in its high nibble, two's
// complement) and scale is fp32 [in/128, F].
//
// What bounds it on the H100: in the agent's decode T = 1, so a call reads
// each packed weight byte once and does 2*T flops per weight: 0.53 bytes a
// parameter with the scales, far below the card's ridge. It is a stream of
// the packed bytes at 3.35 TB/s, 4-30 us a call, so the launch, the ramp, the
// copies in flight and the instructions per byte all count. The design, one
// launch a call:
//   * a thread-block cluster (up to 16 blocks: as many as let the grid sit on
//     the card at once) owns a strip of 8*BPR byte columns (BPR = 16 at T = 1:
//     128 bytes, 256 output columns) and splits the rows, in 16-row chunks,
//     evenly over its blocks' 4 warps each: split-K;
//   * a warp streams its chunks through a ring of DEPTH stages in shared
//     memory: lane 0 issues one TMA box (16 rows x the strip, swizzled so the
//     lanes' reads are conflict-free) a chunk, and with the chunk that opens a
//     128-row group, bulk copies of the group's x and scales; an mbarrier a
//     stage counts the bytes in. (Builds that loaded DEPTH chunks ahead into
//     registers, or through cp.async, ran slower on the H100; PERF.md);
//   * the product runs on the tensor cores, mma.sync m16n8k16 with the weights
//     as A and x as B. Lane (g, c) reads BPR bytes of rows 2c, 2c+1, 2c+8 and
//     2c+9: A's rows are 8 low-nibble and 8 high-nibble columns of the same
//     bytes, its k the chunk's 16 rows. A nibble pair becomes bf16 without a
//     convert: prmt puts byte j of two rows into one word, a mask (and an xor
//     for the two's-complement high nibble) writes it into the mantissa of
//     128.0, one bf16x2 fma subtracts 136 and leaves q exactly. x, rounded to
//     bf16, is the B fragment (token = n; tokens past T are zero), so
//     T = 1..16 is one or two n-tiles;
//   * per 128-row group the fp32 partial is multiplied by the group's scale
//     and added to the lane's running sum, the scale kept out of every
//     product as the TPU kernel keeps it;
//   * the warps' sums meet in shared memory, added in warp order, and each
//     block pushes them into the shared memory of the cluster's block that
//     owns their slice of the strip (distributed shared memory); after one
//     cluster barrier every block sums its slice in rank order and writes y.
//     No scratch in device memory, no atomics, no second launch: two calls
//     give the same bits, on any stream and under a graph.
// The Mosaic tricks of the TPU kernel (shift-free unpack, the /16 pre-fold)
// are not needed here; its 512-row VMEM blocks become the cluster's split.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int G = 128;              // rows per scale group
constexpr int CHUNK = 16;           // rows per mma (its k)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int DEPTH = 4;            // chunks of weights in flight per warp
constexpr int MAX_CLUSTER = 16;

// BPR packed bytes a lane takes of each row (the strip is 8*BPR bytes), NT
// n8 tiles of tokens, NCOL token columns of an mma's C a lane keeps (1 when
// T = 1: only column 2c = 0 is a token).
template <int BPR_, int NT_, int NCOL_, typename XT_>
struct Cfg {
  static constexpr int BPR = BPR_, NT = NT_, NCOL = NCOL_;
  using XT = XT_;
  static constexpr int STRIP = 8 * BPR;                // byte columns a cluster owns
  static constexpr int COLS = 2 * STRIP;               // output columns a cluster owns
  static constexpr int TT = NCOL == 1 ? 1 : 8 * NT;    // token rows a call may have
  static constexpr int PITCH = COLS + 4;               // a token row of the sums
  // The TMA writes a chunk's 16 rows of the strip densely, swizzled (128-byte
  // rows: 16-byte unit u of row r at u ^ (r & 7); 64-byte rows: u ^ (r/2 & 3)),
  // so the lanes' reads of four rows at once are conflict-free.
  static constexpr CUtensorMapSwizzle SWIZZLE =
      BPR == 16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // a warp's shared memory, 1024-byte aligned: a ring of DEPTH weight tiles
  // and of the chunks' 16 x values of each token, two groups' scales (low,
  // then high), the ring's mbarriers
  static constexpr int W_TILE = CHUNK * STRIP;
  static constexpr int X_ROW = CHUNK * sizeof(XT);
  static constexpr int X_TILE = TT * X_ROW;
  static constexpr int S_GROUP = 2 * STRIP * 4;
  static constexpr int WARP_BYTES =
      (DEPTH * (W_TILE + X_TILE) + 2 * S_GROUP + DEPTH * 8 + 1023) / 1024 * 1024;
  static constexpr int RED_BYTES = WARPS * TT * PITCH * 4;
  static constexpr int INBOX_BYTES = (TT * COLS + MAX_CLUSTER) * 4;   // the slice's partials
  static constexpr int SMEM = 1024 + WARPS * WARP_BYTES + RED_BYTES + INBOX_BYTES;  // 1024: slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One bulk copy (the TMA's 1-d form) of `bytes` from global to shared memory,
// its arrival counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One box of a 2-d tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// (128 + v) in each bf16 half -> v - 8, exactly
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// bytes 0 and 2 of p -> their low nibbles (stored q + 8) as a bf16 pair q
__device__ __forceinline__ uint32_t low_pair(uint32_t p) {
  return minus136((p & 0x000F000Fu) | 0x43004300u);
}

// bytes 0 and 2 of p -> their high nibbles (two's complement) as a bf16 pair q
__device__ __forceinline__ uint32_t high_pair(uint32_t p) {
  return minus136(((p >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class C>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const __grid_constant__ CUtensorMap tm_packed, const typename C::XT* __restrict__ x,
    const float* __restrict__ scale, float* __restrict__ y, int tokens, int in_f, int out2) {
  constexpr int BPR = C::BPR, NT = C::NT, NCOL = C::NCOL, WORDS = BPR / 4;
  constexpr int GC = G / CHUNK;                         // chunks a scale group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int strip0 = blockIdx.y * C::STRIP;            // the strip's first byte column
  const int f = 2 * out2;
  unsigned char* const ring = smem + warp * C::WARP_BYTES;
  unsigned char* const xring = ring + DEPTH * C::W_TILE;
  float* const ssm = reinterpret_cast<float*>(xring + DEPTH * C::X_TILE);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ssm + 4 * C::STRIP);
  float* const red = reinterpret_cast<float*>(smem + WARPS * C::WARP_BYTES);
  float* const inbox = red + C::RED_BYTES / 4;

  // this warp's chunks: an even split of in/16 over the cluster's warps
  const int chunks = in_f / CHUNK;
  const int unit = rank * WARPS + warp, units = ranks * WARPS;
  const int c0 = (int)((long long)chunks * unit / units);
  const int c1 = (int)((long long)chunks * (unit + 1) / units);

  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_packed)) : "memory");
#pragma unroll
    for (int s = 0; s < DEPTH; ++s) bar_init(smem_addr(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // chunk k into ring stage (k - c0) % DEPTH, all issued by lane 0: its 16
  // rows of the strip (one TMA box), its x values (a bulk copy a token) and,
  // with the chunk that opens a group (or the warp's first), the group's
  // scales into the buffer of the group's parity
  auto issue = [&](int k) {
    if (k >= c1 || lane != 0) return;
    const int st = (k - c0) % DEPTH;
    const uint32_t bar = smem_addr(bars + st);
    const bool opens = k == c0 || k % GC == 0;
    bar_expect(bar, C::W_TILE + tokens * C::X_ROW + (opens ? C::S_GROUP : 0));
    tma_2d(ring + st * C::W_TILE, &tm_packed, bar, strip0, k * CHUNK);
    for (int t = 0; t < tokens; ++t)
      bulk_copy(xring + st * C::X_TILE + t * C::X_ROW, x + (size_t)t * in_f + k * CHUNK, C::X_ROW,
                bar);
    if (opens) {
      const int grp = k / GC;
      for (int h = 0; h < 2; ++h)
        bulk_copy(ssm + (grp & 1) * 2 * C::STRIP + h * C::STRIP,
                  scale + (size_t)grp * f + h * out2 + strip0, C::STRIP * 4, bar);
    }
  };

  float acc[NT][BPR][4];          // the open group's partial (C fragments)
  float tot[NT][BPR][2][NCOL];    // scaled sums: [low / high nibble][token 2c + kc]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int b = 0; b < BPR; ++b) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][b][i] = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kc = 0; kc < NCOL; ++kc) tot[nt][b][h][kc] = 0.0f;
    }

#pragma unroll
  for (int s = 0; s < DEPTH; ++s) issue(c0 + s);
  for (int k = c0; k < c1; ++k) {
    const int st = (k - c0) % DEPTH;
    bar_wait(smem_addr(bars + st), ((k - c0) / DEPTH) & 1);   // chunk k has landed
    const unsigned char* tile = ring + st * C::W_TILE;
    uint32_t w[4][WORDS];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 2 * c + (r & 1) + 8 * (r >> 1);
      const int unit = BPR == 16 ? g ^ (row & 7) : (g >> 1) ^ ((row >> 1) & 3);
      const unsigned char* src = tile + row * C::STRIP + unit * 16 + (BPR == 16 ? 0 : (g & 1) * 8);
      if constexpr (WORDS == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        w[r][0] = v.x, w[r][1] = v.y, w[r][2] = v.z, w[r][3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[r][0] = v.x, w[r][1] = v.y;
      }
    }
    uint32_t bfrag[NT][2];          // x of token nt*8 + g, rows 2c, 2c+1 | 2c+8, 2c+9
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int t = nt * 8 + g;
      const typename C::XT* xs =
          reinterpret_cast<const typename C::XT*>(xring + st * C::X_TILE + t * C::X_ROW);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t >= tokens || t >= C::TT) {
          bfrag[nt][h] = 0u;
        } else if constexpr (sizeof(typename C::XT) == 4) {
          const float2 v = *reinterpret_cast<const float2*>(xs + 2 * c + 8 * h);
          bfrag[nt][h] = bf16_pair(v.x, v.y);
        } else {
          bfrag[nt][h] = *reinterpret_cast<const uint32_t*>(xs + 2 * c + 8 * h);
        }
      }
    }
#pragma unroll
    for (int wi = 0; wi < WORDS; ++wi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | ((4 + j) << 8);           // byte j of two rows -> bytes 0, 2
        const uint32_t p01 = __byte_perm(w[0][wi], w[1][wi], sel);
        const uint32_t p23 = __byte_perm(w[2][wi], w[3][wi], sel);
        // A rows g: low nibble columns, g + 8: high; k = 2c, 2c+1 | 2c+8, 2c+9
        const uint32_t a[4] = {low_pair(p01), high_pair(p01), low_pair(p23), high_pair(p23)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][4 * wi + j], a, bfrag[nt]);
      }
    if (k % GC == GC - 1 || k + 1 == c1) {   // the group closes: scale its partial into the sums
      const float* sp = ssm + ((k / GC) & 1) * 2 * C::STRIP + g * BPR;
#pragma unroll
      for (int q = 0; q < BPR / 4; ++q) {
        const float4 lo = *reinterpret_cast<const float4*>(sp + 4 * q);
        const float4 hi = *reinterpret_cast<const float4*>(sp + C::STRIP + 4 * q);
        const float slo[4] = {lo.x, lo.y, lo.z, lo.w}, shi[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float* d = acc[nt][4 * q + e];
#pragma unroll
            for (int kc = 0; kc < NCOL; ++kc) {
              tot[nt][4 * q + e][0][kc] = fmaf(d[kc], slo[e], tot[nt][4 * q + e][0][kc]);
              tot[nt][4 * q + e][1][kc] = fmaf(d[2 + kc], shi[e], tot[nt][4 * q + e][1][kc]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) d[i] = 0.0f;
          }
      }
    }
    __syncwarp();                   // every lane is done with stage st and the scales
    issue(k + DEPTH);
  }

  // the warp's sums into shared memory; a strip column (h, byte g*BPR + b)
  // sits at h*STRIP + b*8 + g, so the 8 lanes g of a store hit 8 banks
  float* const mine = red + warp * C::TT * C::PITCH;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int kc = 0; kc < NCOL; ++kc) {
      const int t = nt * 8 + 2 * c + kc;
      if (t < tokens && t < C::TT) {
#pragma unroll
        for (int b = 0; b < BPR; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) mine[t * C::PITCH + h * C::STRIP + b * 8 + g] = tot[nt][b][h][kc];
      }
    }
  __syncthreads();
  // the block's sums, warp by warp in order, pushed into the inbox of the
  // cluster's block that owns their slice of the strip's outputs
  const int n = tokens * C::COLS;
  const int per = (n + ranks - 1) / ranks;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int t = e / C::COLS, col = e % C::COLS;
    const int h = col / C::STRIP, byte = col % C::STRIP;
    const int idx = t * C::PITCH + h * C::STRIP + (byte % BPR) * 8 + byte / BPR;
    float s = red[idx];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * C::TT * C::PITCH + idx];
    const int owner = e / per;
    cluster.map_shared_rank(inbox, owner)[rank * per + e - owner * per] = s;
  }
  cluster.sync();                   // every block's partials have landed; none is read again
  // this block's slice: the blocks' partials summed in rank order
  for (int i = threadIdx.x; i < per && rank * per + i < n; i += THREADS) {
    float s = inbox[i];
    for (int q = 1; q < ranks; ++q) s += inbox[q * per + i];
    const int e = rank * per + i, t = e / C::COLS, col = e % C::COLS;
    y[(size_t)t * f + (size_t)(col / C::STRIP) * out2 + strip0 + col % C::STRIP] = s;
  }
}

// Calls fn(Cfg<...>{}) for the configuration that serves `tokens` and x's type.
template <typename Fn>
cudaError_t dispatch(int tokens, int x_f32, Fn&& fn) {
  if (tokens == 1) {
    return x_f32 ? fn(Cfg<16, 1, 1, float>{}) : fn(Cfg<16, 1, 1, __nv_bfloat16>{});
  }
  if (tokens <= 8) {
    return x_f32 ? fn(Cfg<8, 1, 2, float>{}) : fn(Cfg<8, 1, 2, __nv_bfloat16>{});
  }
  return x_f32 ? fn(Cfg<8, 2, 2, float>{}) : fn(Cfg<8, 2, 2, __nv_bfloat16>{});
}

template <class C>
cudaLaunchConfig_t launch_config(int cluster, int out2, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, out2 / C::STRIP, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's attributes (its shared memory, clusters above 8 blocks)
// once a device; returns the device's SM count.
template <class C>
cudaError_t prepare(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev]) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(decode_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(decode_kernel<C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *sms;
  return err;
}

// The cluster a call takes unless it names one: the largest power of two up
// to 16 that keeps the grid within 2.5 blocks an SM (measured on the H100 at
// the agent's shapes: more blocks stream more rows at once, but past that
// they queue behind the reduction or thin out each warp's stream). It depends
// on the shape alone, so fp32 and bf16 x sum in the same order.
template <class C>
cudaError_t pick_cluster(int out2, int* cluster) {
  int sms = 0;
  const cudaError_t err = prepare<C>(&sms);
  if (err != cudaSuccess || *cluster > 0) return err;
  const int strips = out2 / C::STRIP;
  *cluster = 1;
  while (*cluster < MAX_CLUSTER && 2 * strips * (2 * *cluster) <= 5 * sms) *cluster *= 2;
  return cudaSuccess;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime: no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// packed [in, out2] bytes as a 2-d map of boxes of 16 rows x one strip.
template <class C>
bool map_packed(CUtensorMap* map, const void* packed, int in_f, int out2) {
  const cuuint64_t dims[2] = {(cuuint64_t)out2, (cuuint64_t)in_f}, strides[1] = {(cuuint64_t)out2};
  const cuuint32_t box[2] = {(cuuint32_t)C::STRIP, (cuuint32_t)CHUNK}, unit[2] = {1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(packed), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, C::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid(int tokens, int in_f, int out2, int cluster) {
  return tokens >= 1 && tokens <= 16 && in_f > 0 && out2 > 0 && in_f % G == 0 &&
         out2 % 128 == 0 && cluster >= 0 && cluster <= MAX_CLUSTER;
}

}  // namespace

// x fp32 (x_f32 = 1) or bf16 [T, in]; packed uint8
// [in, out2]; scale fp32 [in/128, 2*out2]; y fp32 [T, 2*out2]. Contiguous,
// 16-byte aligned x, packed and scale, in % 128 == 0, out2 % 128 == 0,
// 1 <= T <= 16; cluster 0 (the kernel picks) or 1..16 blocks. One launch.
extern "C" int diffsensei_int4_decode_matmul(const void* x, int x_f32, const void* packed,
                                             const void* scale, void* y, int tokens, int in_f,
                                             int out2, int cluster, void* stream) {
  if (!valid(tokens, in_f, out2, cluster)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(tokens, x_f32, [&](auto cfg) {
    using C = decltype(cfg);
    int cl = cluster;
    cudaError_t err = pick_cluster<C>(out2, &cl);
    if (err != cudaSuccess) return err;
    CUtensorMap tm;
    if (!map_packed<C>(&tm, packed, in_f, out2)) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t lc = launch_config<C>(cl, out2, s, &attr);
    err = cudaLaunchKernelEx(&lc, decode_kernel<C>, tm, static_cast<const typename C::XT*>(x),
                             static_cast<const float*>(scale), static_cast<float*>(y), tokens,
                             in_f, out2);
    return err != cudaSuccess ? err : cudaGetLastError();
  });
}

// How the kernel that serves (tokens, x's type) fills the card at a width
// out2 with `cluster` blocks a cluster (0: the one it picks): out = {blocks
// an SM, clusters resident at once, strip bytes, threads, shared memory
// bytes, grid blocks, cluster}.
extern "C" int diffsensei_int4_layout(int tokens, int x_f32, int out2, int cluster, int* out) {
  if (!valid(tokens, G, out2, cluster)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(tokens, x_f32, [&](auto cfg) {
    using C = decltype(cfg);
    int cl = cluster;
    cudaError_t err = pick_cluster<C>(out2, &cl);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], decode_kernel<C>, THREADS, C::SMEM);
    }
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t lc = launch_config<C>(cl, out2, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&out[1], decode_kernel<C>, &lc);
    out[2] = C::STRIP;
    out[3] = THREADS;
    out[4] = C::SMEM;
    out[5] = (int)(lc.gridDim.x * lc.gridDim.y);
    out[6] = cl;
    return err;
  });
}
