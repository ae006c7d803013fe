// Hopper (sm_90a) building blocks of the attention kernels: B1, B2 and B4's
// head_dim-64 path (flash_attention.cu), B7 (chunked_attention.cu) and B8
// (single_pass_attention.cu), and of the VAE's convolution B9
// (vae_conv.cu: TF32 products with A in registers, 5-d TMA boxes). TMA
// loads of bf16 tiles 64 values wide through mbarrier rings, wgmma on
// them, the register layouts that join the two products of attention, and
// what warpgroups and the blocks of a
// thread-block cluster exchange through: named barriers, and asynchronous
// stores and bulk copies into another block's shared memory that complete on
// its mbarrier. This file is their one home; each source that includes it
// builds into its own library, and `ops/_build.py` hashes the included
// headers with the source.
//
// A block is one or two consumer warpgroups (threads 0-127, 128-255, each 64
// q or key rows) and, in B1, B2, B4 and B7 at small chunks, a producer warp
// whose lane 0 issues the TMA loads (B8 and B7 at chunks 256 and 512 leave
// them to thread 0 and keep to eight warps, up to 255 registers a thread for
// their 128 scores): the block's own tiles once, then K or
// V tiles through a ring of slots, each slot handed over by a "full"
// barrier (the transfer's bytes) and an "empty" one (all its consumers have
// read it). Every tile is written with the 128-byte swizzle, so one
// descriptor serves S = Q K^T (K-major) and O += P V (V through the
// transpose bit).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

typedef __nv_bfloat16 bf16;

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace hop {

constexpr int T = 64;                        // rows of every tile; wgmma m64n64k16
constexpr int CONSUMERS = 128;               // one warpgroup: warps 0-3
constexpr int THREADS = CONSUMERS + 32;      // + the producer warp
constexpr uint32_t TILE = T * 64 * 2;        // one 64 x 64 bf16 tile: 8 KB

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed; CLUSTER acquires at
// cluster scope, for barriers that other blocks of the cluster complete with
// `st_async` or `bulk_to_peer`. A wait that never ends (a lost transfer)
// traps, so the launch fails instead of hanging the card.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    if constexpr (CLUSTER) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } else {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(c4) : "memory");
}

// Shared-memory matrix descriptor of a tile TMA wrote with the 128-byte
// swizzle: 8-row groups 1024 bytes apart. The same value serves both majors
// (K-major ignores the leading offset; a 64-wide MN-major tile has one block).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups are still running (they finish in order).
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads') over `n` threads, a multiple
// of 32: `named_sync` arrives and waits, `named_arrive` arrives only. Shared
// memory written before either is visible to the threads that waited.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Thread-block clusters: this block's rank and the cluster's size.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives once and waits once a phase; release / acquire order the
// shared-memory accesses before it with those after it.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// The address in the shared window of cluster block `rank` of what lies at
// `addr` in this block's shared memory (the layouts are the same).
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// An asynchronous store of two floats into a cluster block's shared memory
// (`addr` from `peer_addr`) whose bytes complete on that block's mbarrier
// `bar` (also a `peer_addr`), as a TMA load's do: the sender does not wait,
// the receiver expects the bytes of a phase (`mbar_expect_tx`) and waits on
// the barrier.
__device__ __forceinline__ void st_async(uint32_t addr, float x, float y, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               ::"r"(addr), "f"(x), "f"(y), "r"(bar) : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from this block's shared memory to a cluster block's (`dst` and `bar` from
// `peer_addr`), done by the TMA unit and completed on that block's mbarrier.
// Generic-proxy writes to `src` must be fenced first (`fence_proxy_async`).
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Tell the compiler an accumulator's values are dead: the next product
// overwrites them (its first k-step does not accumulate), so its registers
// are free from their last read until that product is issued.
template <int N>
__device__ __forceinline__ void drop_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(d[i]));
}

#define HOP_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOP_D32_OUT(d)                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// d (64 x 64, fp32) = [d +] A B^T, A and B 64 x 16 K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOP_D32_OUT(d) : "l"(a), "l"(b), "r"(accumulate));
}

#define HOP_D64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOP_D64_OUT(d)                                                                  \
  HOP_D32_OUT(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),         \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, fp32) = [d +] A B^T, A 64 x 16 and B 128 x 16 K-major tiles in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOP_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOP_D64_OUT(d) : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A B, A 64 x 16 in registers (the m16n8k16 A fragment of
// each warp's 16 rows), B 16 x 64 in shared memory with N contiguous.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOP_D32_OUT(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) = [d +] A B^T in TF32, A 64 x 8 in registers (each
// warp's 16 rows: a[0] row g col t, a[1] row g + 8 col t, a[2] row g col
// t + 4, a[3] row g + 8 col t + 4, for lane 4g + t; fp32 values whose low 13
// bits the tensor cores ignore) and B 128 x 8 K-major in shared memory (a
// 32-byte step of a tile of 128-byte rows, 128-byte swizzle). TF32 has no
// transpose bits: both operands are K-major.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOP_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOP_D64_OUT(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Warpgroup-wide register budgets (all four warps execute it): a producer
// warpgroup gives registers up, consumers take them, within the block's
// allocation at launch.
template <int N>
__device__ __forceinline__ void regs_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void regs_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }

#define HOP_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define HOP_D128_OUT(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 256, fp32) = [d +] A B^T, A 64 x 16 and B 256 x 16 K-major tiles in
// shared memory (B: four 64-row tiles one after another).
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOP_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : HOP_D128_OUT(d) : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOP_D32
#undef HOP_D128
#undef HOP_D128_OUT
#undef HOP_D32_OUT
#undef HOP_D64
#undef HOP_D64_OUT

// The accumulator of a 64 x N product holds, in thread (warp w, lane 4g + t),
// element 4n + e at row 16w + g + 8(e >> 1), column 8n + 2t + (e & 1): for a
// k-step kk of the next product its columns 16kk..16kk+15 are the A fragment.
template <int KS>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[KS][4], const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0. (exp2f
// adds a fix-up for them, which cost B2 twice its time.)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The row max over the four lanes of a quad that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Barriers at bar0 + 8i: [0] the block's own tiles, [1 + s] stage s full,
// [1 + stages + s] stage s empty (released by all `consumers` threads).
__device__ __forceinline__ void init_ring(uint32_t bar0, int stages, uint32_t consumers) {
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar0 + 8 * (1 + s), 1);
      mbar_init(bar0 + 8 * (1 + stages + s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A ring of STAGES slots of SLOT bytes each (one TMA box), with the barriers
// of `init_ring(bar0, STAGES, consumers)`: the loading side, which walks the
// ring's sequence of boxes, the i-th in slot i % STAGES. `slots` is the first
// slot's address.
template <int STAGES, uint32_t SLOT = TILE>
struct Ring {
  uint32_t slots, bar0;
  int i = 0;
  __device__ Ring(uint32_t slots_, uint32_t bar0_) : slots(slots_), bar0(bar0_) {}
  // load the next box (rows `row0`.. of `map` at head h, batch b) once its
  // slot is free
  __device__ void load(const CUtensorMap* map, int row0, int h, int b) {
    const uint32_t full = bar0 + 8 * (1 + i % STAGES);
    if (i >= STAGES) mbar_wait(bar0 + 8 * (1 + STAGES + i % STAGES), (i / STAGES - 1) & 1);
    mbar_expect_tx(full, SLOT);
    tma_4d(slots + (i % STAGES) * SLOT, map, full, 0, row0, h, b);
    ++i;
  }
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime: no -lcuda.
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

// [B, H, S, 64] bf16 with element strides (b, h, s) as a 4-d map (D, S, H, B)
// of boxes of box_rows x 64, 128-byte swizzle; rows past S read as zeros.
bool map_rows(CUtensorMap* map, const void* ptr, int B, int H, int S, const long long* str,
              int box_rows = T) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)str[2] * 2, (cuuint64_t)str[1] * 2, (cuuint64_t)str[0] * 2};
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1 && strides[i] == 0) strides[i] = 16;  // unused: any legal stride
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop

}  // namespace
