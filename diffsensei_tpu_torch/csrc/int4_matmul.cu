// Packed-int4 weight-only decode matmul for Hopper (sm_90a): kernel B6.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (diffsensei_tpu/ops/int4_matmul.py:125, pallas_call at :197). Computes
//   y[T, F] = bf16(x)[T, in] @ dequant(packed, scale),  T <= 16, fp32 out,
// where packed is uint8 [in, F/2] in the split-half layout (byte column j holds
// output column j in its low nibble, stored as q + 8, and output column F/2 + j
// in its high nibble, two's complement) and scale is fp32 [in/128, F].
//
// What bounds it on the H100: in the agent's decode T = 1, so every call reads
// each packed weight byte once and does 2*T flops per weight: 0.53 bytes a
// parameter with the scales, far below the card's bf16 ridge. It is a stream of
// the packed bytes at 3.35 TB/s. The design:
//   * pass 1: one block per (256 byte columns, 128-row scale group). 64 threads,
//     each owning 4 byte columns (8 output columns), walk the group's 128 rows;
//     a warp reads 128 contiguous bytes of a row per step. The group's x slice
//     sits in shared memory as fp32 and is read by broadcast. Nibbles become
//     floats without a convert: prmt puts the biased nibble (0..15) into the
//     mantissa of 2^23, one subtraction leaves q. The block sums q * x over its
//     group in fp32 for each of the T rows, multiplies by the group's scale and
//     writes the partial to an fp32 scratch [in/128, T, F];
//   * pass 2: sums the partials over the groups in a fixed order, so the result
//     is the same bits on every run (no float atomics);
//   * T is a template argument (1..16), so T = 1 does one row of FMAs, not 16.
// The Mosaic tricks of the TPU kernel (shift-free unpack, the /16 pre-fold)
// are not needed here. wgmma / mma.sync for T = 16 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 128;               // rows per scale group and per block
constexpr int NTHREADS = 64;
constexpr int BPT = 4;               // packed bytes (byte columns) per thread
constexpr int COLS = NTHREADS * BPT; // byte columns per block
constexpr int RED_THREADS = 256;

// byte j of `word` (a nibble value v in 0..15) -> float(v - 8)
__device__ __forceinline__ float nibble(uint32_t word, int j) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | j)) - 8388616.0f;
}

template <int T>
__global__ void __launch_bounds__(NTHREADS) decode_partial(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, float* __restrict__ part, int in_f, int out2) {
  __shared__ float xs[T][G];
  const int g = blockIdx.y;
  const int row0 = g * G;
  for (int idx = threadIdx.x; idx < T * G; idx += NTHREADS) {
    const int t = idx / G, i = idx % G;
    xs[t][i] = __bfloat162float(x[(size_t)t * in_f + row0 + i]);
  }
  __syncthreads();

  const int col = blockIdx.x * COLS + threadIdx.x * BPT;
  if (col >= out2) return;

  float acc[T][2 * BPT];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int k = 0; k < 2 * BPT; ++k) acc[t][k] = 0.0f;

  const uint32_t* src = reinterpret_cast<const uint32_t*>(packed + (size_t)row0 * out2 + col);
  const size_t pitch = out2 / 4;     // row pitch in 32-bit words
#pragma unroll 16
  for (int i = 0; i < G; ++i) {
    const uint32_t w = __ldg(src + i * pitch);
    const uint32_t lo = w & 0x0F0F0F0Fu;                          // q + 8
    const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // two's complement -> q + 8
    float v[2 * BPT];
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      v[j] = nibble(lo, j);
      v[BPT + j] = nibble(hi, j);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float xv = xs[t][i];
#pragma unroll
      for (int k = 0; k < 2 * BPT; ++k) acc[t][k] = fmaf(xv, v[k], acc[t][k]);
    }
  }

  const int f = 2 * out2;
  const float4 slo = *reinterpret_cast<const float4*>(scale + (size_t)g * f + col);
  const float4 shi = *reinterpret_cast<const float4*>(scale + (size_t)g * f + out2 + col);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float* p = part + ((size_t)g * T + t) * f;
    *reinterpret_cast<float4*>(p + col) =
        make_float4(acc[t][0] * slo.x, acc[t][1] * slo.y, acc[t][2] * slo.z, acc[t][3] * slo.w);
    *reinterpret_cast<float4*>(p + out2 + col) =
        make_float4(acc[t][4] * shi.x, acc[t][5] * shi.y, acc[t][6] * shi.z, acc[t][7] * shi.w);
  }
}

// y[n] = sum over groups, in group order, of part[g][n]  (n = T * F)
__global__ void __launch_bounds__(RED_THREADS) reduce_groups(
    const float* __restrict__ part, float* __restrict__ y, int groups, int n) {
  const int idx = blockIdx.x * RED_THREADS + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) s += part[(size_t)g * n + idx];
  y[idx] = s;
}

template <int T>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* part, void* y,
                   int in_f, int out2, cudaStream_t stream) {
  const int groups = in_f / G;
  dim3 grid((out2 + COLS - 1) / COLS, groups);
  decode_partial<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(part), in_f, out2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = T * 2 * out2;
  reduce_groups<<<(n + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(y), groups, n);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [T, in]; packed uint8 [in, out2]; scale fp32 [in/128, 2*out2];
// part fp32 scratch [in/128, T, 2*out2]; y fp32 [T, 2*out2]. Contiguous,
// 16-byte aligned packed and scale, in % 128 == 0, out2 % 128 == 0, 1 <= T <= 16.
extern "C" int diffsensei_int4_decode_matmul(const void* x, const void* packed, const void* scale,
                                             void* part, void* y, int tokens, int in_f, int out2,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_f <= 0 || out2 <= 0 || in_f % G || out2 % 128) return (int)cudaErrorInvalidValue;
  switch (tokens) {
#define DIFFSENSEI_INT4_CASE(T) \
  case T:                       \
    return (int)launch<T>(x, packed, scale, part, y, in_f, out2, s);
    DIFFSENSEI_INT4_CASE(1) DIFFSENSEI_INT4_CASE(2) DIFFSENSEI_INT4_CASE(3)
    DIFFSENSEI_INT4_CASE(4) DIFFSENSEI_INT4_CASE(5) DIFFSENSEI_INT4_CASE(6)
    DIFFSENSEI_INT4_CASE(7) DIFFSENSEI_INT4_CASE(8) DIFFSENSEI_INT4_CASE(9)
    DIFFSENSEI_INT4_CASE(10) DIFFSENSEI_INT4_CASE(11) DIFFSENSEI_INT4_CASE(12)
    DIFFSENSEI_INT4_CASE(13) DIFFSENSEI_INT4_CASE(14) DIFFSENSEI_INT4_CASE(15)
    DIFFSENSEI_INT4_CASE(16)
#undef DIFFSENSEI_INT4_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
