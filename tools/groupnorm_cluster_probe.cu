// The thread-block-cluster design for kernel B3 (GroupNorm + SiLU), kept to
// be measured beside the shipped kernel (tools/torch_groupnorm_variants.py).
//
// Built with the port's nvcc flags and -I diffsensei_tpu_torch/csrc: it
// includes the shipped source for its helpers (vector loads and stores, the
// shift a group, the merge of a block's entries), so its arithmetic is the
// shipped kernel's and only the layout differs.
//
// A strip is ng whole groups of one sample (W = ng * cg channels, all its
// rows). A cluster of `cs` blocks (up to 16) owns one strip: block rank r
// copies rows [hw * r / cs, hw * (r + 1) / cs) of the strip into its shared
// memory once (cp.async, consecutive threads on consecutive addresses across
// the strip's width), takes each group's (count, mean, M2) of them from
// shared memory, and the cluster's blocks exchange those partials through
// distributed shared memory, merging them in rank order after one cluster
// barrier. Each block then normalizes its slab from shared memory and writes
// it, either with vector stores from registers or (bulk) back into shared
// memory and out with one bulk copy a row piece (cp.async.bulk, the TMA
// engine). One read and one write of x. Grid (cs, strips, batch).

#include "groupnorm_silu.cu"

namespace {

// a cluster block's shared memory after its slab: the threads' entries as in
// the resident kernel, the block's partials (read by the cluster through
// distributed shared memory), the merged (mean, rstd) and the shift a group
constexpr int CLUSTER_EXTRA = (2 * SCRATCH + THREADS) * 4 + MAX_NG * 16 + 3 * MAX_NG * 4;

template <typename T, int VEC, bool BULK>
__global__ void __launch_bounds__(THREADS) cluster_kernel(
    const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ scale,
    const void* __restrict__ bias, int scale_f32, int bias_f32, int hw, int c, int cg, int ng,
    float eps) {
  constexpr int EPV = VEC / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int strip = blockIdx.y, b = blockIdx.z;
  const int W = ng * cg, U = W / EPV, P = THREADS / U;
  const int u = threadIdx.x % U, p = threadIdx.x / U, col0 = u * EPV;
  const bool active = p < P;
  const int r0 = (int)((long long)hw * rank / cs);
  const int rows = (int)((long long)hw * (rank + 1) / cs) - r0;
  const int rows_max = (hw + cs - 1) / cs;
  T* const slab = reinterpret_cast<T*>(smem);
  float* const ent_mean = reinterpret_cast<float*>(smem + align16((size_t)rows_max * W * sizeof(T)));
  float* const ent_m2 = ent_mean + SCRATCH;
  float* const ent_n = ent_m2 + SCRATCH;
  float4* const part = reinterpret_cast<float4*>(ent_n + THREADS);
  float* const coef = reinterpret_cast<float*>(part + MAX_NG);
  float* const shift = coef + 2 * MAX_NG;
  const size_t g0 = ((size_t)b * hw + r0) * c + (size_t)strip * W;   // the slab's first element

  if (threadIdx.x < ng) {
    shift[threadIdx.x] = group_shift(x, (size_t)b * hw * c + (size_t)strip * W + threadIdx.x * cg);
  }
  float a[EPV], sh[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    a[e] = param(scale, scale_f32, strip * W + col0 + e);
    sh[e] = param(bias, bias_f32, strip * W + col0 + e);
  }
  for (int i = threadIdx.x; i < rows * U; i += THREADS) {
    const int r = i / U, q = i % U;
    cp_async<VEC>(slab + (size_t)r * W + q * EPV, x + g0 + (size_t)r * c + q * EPV);
  }
  cp_async_wait_all();
  __syncthreads();
  float ks[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) ks[e] = shift[(col0 + e) / cg];

  // a thread's values of each channel (rows p, p + P, ...): their mean, then
  // their M2 about it, from shared memory; then the block's partial a group
  const int mine = active && rows > p ? (rows - p + P - 1) / P : 0;
  const T* const sp = slab + (size_t)p * W + col0;
  float acc[EPV], mu[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) acc[e] = 0.0f;
  for (int i = 0; i < mine; ++i) {
    float v[EPV];
    load_vec<T, VEC>(sp + (size_t)i * P * W, v, false);
#pragma unroll
    for (int e = 0; e < EPV; ++e) acc[e] += v[e] - ks[e];
  }
  const float inv = mine > 0 ? 1.0f / (float)mine : 0.0f;
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    mu[e] = acc[e] * inv;
    acc[e] = 0.0f;
  }
  for (int i = 0; i < mine; ++i) {
    float v[EPV];
    load_vec<T, VEC>(sp + (size_t)i * P * W, v, false);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const float d = (v[e] - ks[e]) - mu[e];
      acc[e] = fmaf(d, d, acc[e]);
    }
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      ent_mean[p * W + col0 + e] = mu[e];
      ent_m2[p * W + col0 + e] = acc[e];
    }
    if (u == 0) ent_n[p] = (float)mine;
  }
  __syncthreads();
  merge_entries(ent_n, ent_mean, ent_m2, P, W, cg, ng, part);

  // every block's partials written; a warp a group merges the cluster's in
  // rank order (lane l reads rank l's through distributed shared memory)
  cluster.sync();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < ng; j += WARPS) {
    const float4 e = lane < cs ? cluster.map_shared_rank(part, lane)[j]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float n = lane_sum(e.x, 32);
    const float mean = lane_sum(e.x * e.y, 32) / n;
    const float d = e.y - mean;
    const float m2 = lane_sum(e.z + e.x * d * d, 32);
    if (lane == 0) {
      coef[2 * j] = mean;
      coef[2 * j + 1] = rsqrtf(m2 / n + eps);
    }
  }
  cluster.sync();                   // no block's partials are read again; coef is set

  if (active) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const int j = (col0 + e) / cg;
      mu[e] = coef[2 * j];
      a[e] *= coef[2 * j + 1];
    }
    for (int i = 0; i < mine; ++i) {
      float v[EPV];
      const size_t off = (size_t)(p + i * P) * W + col0;
      load_vec<T, VEC>(slab + off, v, false);
#pragma unroll
      for (int e = 0; e < EPV; ++e) v[e] = silu(fmaf((v[e] - ks[e]) - mu[e], a[e], sh[e]));
      if constexpr (BULK) {
        store_vec<T, VEC>(slab + off, v);           // in place: this thread read it
      } else {
        store_vec<T, VEC>(y + g0 + (size_t)(p + i * P) * c + col0, v);
      }
    }
  }
  if constexpr (BULK) {
    // the normalized slab out, one bulk copy a row piece of W values
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const uint32_t bytes = (uint32_t)(W * sizeof(T));
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       y + g0 + (size_t)r * c),
                   "r"(smem_addr(slab + (size_t)r * W)), "r"(bytes)
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <typename T, int VEC, bool BULK>
cudaError_t cluster_run(const void* x, void* y, const void* scale, const void* bias,
                        int scale_f32, int bias_f32, int batch, int hw, int c, int groups, int ng,
                        int cs, float eps, cudaStream_t stream, int* active_clusters) {
  auto kernel = cluster_kernel<T, VEC, BULK>;
  const int cg = c / groups;
  const int smem = (int)align16((size_t)((hw + cs - 1) / cs) * ng * cg * sizeof(T)) + CLUSTER_EXTRA;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, groups / ng, batch);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (active_clusters) {
    err = cudaOccupancyMaxActiveClusters(active_clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y), scale, bias,
                           scale_f32, bias_f32, hw, c, cg, ng, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The cluster design over x [batch, hw, c] (bf16, or fp32 when x_f32) with
// `groups` groups: strips of ng groups, `cs` blocks a strip, bulk stores or
// vector stores; a thread's vector is the widest of 16, 8 and 4 bytes that
// divides a strip's row piece into at most 512. Fills *vec and, when
// active_clusters is not null, the clusters the card holds at once. Returns a
// cudaError_t.
extern "C" int gn_cluster(const void* x, void* y, const void* scale, const void* bias, int x_f32,
                          int scale_f32, int bias_f32, int batch, int hw, int c, int groups, int ng,
                          int cs, int bulk, float eps, void* stream, int* vec,
                          int* active_clusters) {
  const int es = x_f32 ? 4 : 2;
  if (batch < 1 || hw < cs || groups < 1 || c % groups || ng < 1 || ng > MAX_NG || groups % ng ||
      cs < 1 || cs > 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int piece = ng * (c / groups) * es;
  *vec = 0;
  for (int v : {16, 8, 4}) {
    if (piece % v == 0 && piece / v <= THREADS) {
      *vec = v;
      break;
    }
  }
  if (*vec == 0 || (c * es) % *vec || (bulk && (piece % 16 || (c * es) % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(x_f32, *vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    auto go = [&](auto b) {
      return cluster_run<T, V, decltype(b)::value>(x, y, scale, bias, scale_f32, bias_f32, batch,
                                                   hw, c, groups, ng, cs, eps, st,
                                                   active_clusters);
    };
    return bulk ? go(std::true_type{}) : go(std::false_type{});
  });
}
