// Yardsticks for kernel B6 (diffsensei_tpu_torch/csrc/int4_matmul.cu): read
// the bytes of a packed int4 weight [in, out2] once, with no arithmetic, the
// way B6 walks them (a block a 128-byte strip and a share of the rows, four
// warps splitting the block's rows in 16-row chunks, 4 chunks in flight a
// warp), by three kinds of copy: 16-byte register loads, cp.async into shared
// memory, and bulk copies (the TMA) onto an mbarrier. And one plain
// contiguous read of the same bytes. Built by tools/torch_int4_probe.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4, DEPTH = 4;

__device__ __forceinline__ uint4 load_na(const uint8_t* p) {
  uint4 w;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w) : "l"(p));
  return w;
}

__device__ __forceinline__ uint32_t fold(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the chunks [c0, c1) of this warp, as B6 splits them
__device__ __forceinline__ void my_chunks(int in_f, int ranks, int* c0, int* c1) {
  const int chunks = in_f / 16, unit = blockIdx.x * WARPS + threadIdx.x / 32;
  *c0 = (int)((long long)chunks * unit / (ranks * WARPS));
  *c1 = (int)((long long)chunks * (unit + 1) / (ranks * WARPS));
}

__global__ void __launch_bounds__(256) contiguous(const uint8_t* p, size_t n, uint32_t* out) {
  uint32_t acc = 0;
  const size_t stride = (size_t)gridDim.x * 256 * 16;
  size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 16;
  for (; i + 3 * stride < n; i += 4 * stride)
    acc ^= fold(load_na(p + i)) ^ fold(load_na(p + i + stride)) ^
           fold(load_na(p + i + 2 * stride)) ^ fold(load_na(p + i + 3 * stride));
  for (; i < n; i += stride) acc ^= fold(load_na(p + i));
  if (acc == 0x12345678u) out[0] = acc;
}

// lane (g, c) reads rows 2c, 2c+1, 2c+8, 2c+9 of a chunk at byte 16g of the strip
__global__ void __launch_bounds__(32 * WARPS) registers(const uint8_t* p, int in_f, int out2,
                                                        int ranks, uint32_t* out) {
  const int lane = threadIdx.x % 32, g = lane >> 2, c = lane & 3;
  const uint8_t* base = p + (size_t)(2 * c) * out2 + blockIdx.y * 128 + g * 16;
  int c0, c1;
  my_chunks(in_f, ranks, &c0, &c1);
  uint32_t acc = 0;
  for (int k = c0; k < c1; k += DEPTH) {
    uint4 w[DEPTH][4];
#pragma unroll
    for (int s = 0; s < DEPTH; ++s)
      if (k + s < c1) {
        const uint8_t* q = base + (size_t)(k + s) * 16 * out2;
#pragma unroll
        for (int r = 0; r < 4; ++r) w[s][r] = load_na(q + (size_t)((r & 1) + 8 * (r >> 1)) * out2);
      }
#pragma unroll
    for (int s = 0; s < DEPTH; ++s)
      if (k + s < c1)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc ^= fold(w[s][r]);
  }
  if (acc == 0x12345678u) out[0] = acc;
}

__global__ void __launch_bounds__(32 * WARPS) cp_async(const uint8_t* p, int in_f, int out2,
                                                       int ranks, uint32_t* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int lane = threadIdx.x % 32, g = lane >> 2, c = lane & 3;
  const uint8_t* base = p + (size_t)(2 * c) * out2 + blockIdx.y * 128 + g * 16;
  unsigned char* ring = sm + (threadIdx.x / 32) * DEPTH * 2048;
  int c0, c1;
  my_chunks(in_f, ranks, &c0, &c1);
  auto issue = [&](int k) {
    if (k < c1) {
      const uint8_t* q = base + (size_t)k * 16 * out2;
      unsigned char* d = ring + (k % DEPTH) * 2048 + lane * 16;
      for (int r = 0; r < 4; ++r)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     ::"r"(smem(d + r * 512)), "l"(q + (size_t)((r & 1) + 8 * (r >> 1)) * out2));
    }
    asm volatile("cp.async.commit_group;");
  };
  uint32_t acc = 0;
  for (int s = 0; s < DEPTH; ++s) issue(c0 + s);
  for (int k = c0; k < c1; ++k) {
    asm volatile("cp.async.wait_group %0;" ::"n"(DEPTH - 1));
    const unsigned char* src = ring + (k % DEPTH) * 2048 + lane * 16;
    for (int r = 0; r < 4; ++r) acc ^= fold(*reinterpret_cast<const uint4*>(src + r * 512));
    __syncwarp();
    issue(k + DEPTH);
  }
  if (acc == 0x12345678u) out[0] = acc;
}

// lanes 0-15 issue a 128-byte bulk copy a row of the chunk
__global__ void __launch_bounds__(32 * WARPS) bulk(const uint8_t* p, int in_f, int out2,
                                                   int ranks, uint32_t* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int PITCH = 144, STAGE = 16 * PITCH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, c = lane & 3;
  unsigned char* ring = sm + warp * DEPTH * STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + WARPS * DEPTH * STAGE) + warp * DEPTH;
  int c0, c1;
  my_chunks(in_f, ranks, &c0, &c1);
  if (lane == 0) {
    for (int s = 0; s < DEPTH; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const uint8_t* col = p + blockIdx.y * 128;
  auto issue = [&](int k) {
    if (k >= c1) return;
    const int st = (k - c0) % DEPTH;
    const unsigned bar = smem(bars + st);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 2048;" ::"r"(bar) : "memory");
    __syncwarp();
    if (lane < 16)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], 128, [%2];"
                   ::"r"(smem(ring + st * STAGE + lane * PITCH)), "l"(col + (size_t)(k * 16 + lane) * out2),
                     "r"(bar) : "memory");
  };
  uint32_t acc = 0;
  for (int s = 0; s < DEPTH; ++s) issue(c0 + s);
  for (int k = c0; k < c1; ++k) {
    const int st = (k - c0) % DEPTH;
    asm volatile("{\n.reg .pred p;\nWAIT: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra WAIT;\n}\n"
                 ::"r"(smem(bars + st)), "r"(((k - c0) / DEPTH) & 1) : "memory");
    const unsigned char* src = ring + st * STAGE + g * 16;
    const int rows[4] = {2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9};
    for (int r = 0; r < 4; ++r) acc ^= fold(*reinterpret_cast<const uint4*>(src + rows[r] * PITCH));
    __syncwarp();
    issue(k + DEPTH);
  }
  if (acc == 0x12345678u) out[0] = acc;
}

}  // namespace

extern "C" int probe_contiguous(const void* p, long long n, int blocks, void* out, void* stream) {
  contiguous<<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint8_t*)p, (size_t)n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// how: 0 registers, 1 cp.async, 2 bulk copies; a grid of ranks x out2/128 blocks
extern "C" int probe_strips(int how, const void* p, int in_f, int out2, int ranks, void* out,
                            void* stream) {
  const dim3 grid(ranks, out2 / 128);
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* q = (const uint8_t*)p;
  uint32_t* o = (uint32_t*)out;
  if (how == 0) {
    registers<<<grid, 32 * WARPS, 0, s>>>(q, in_f, out2, ranks, o);
  } else if (how == 1) {
    const int bytes = WARPS * DEPTH * 2048;
    cudaFuncSetAttribute(cp_async, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cp_async<<<grid, 32 * WARPS, bytes, s>>>(q, in_f, out2, ranks, o);
  } else {
    const int bytes = WARPS * DEPTH * (16 * 144 + 8);
    cudaFuncSetAttribute(bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    bulk<<<grid, 32 * WARPS, bytes, s>>>(q, in_f, out2, ranks, o);
  }
  return (int)cudaGetLastError();
}
