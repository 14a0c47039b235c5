// Softmax marginals of the integral decode: a split, streaming online softmax
// with several slices in flight per thread and no block barrier in the slice
// loop.
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/integral_pallas.py:_fwd_kernel
// (called through _marginals_fwd_impl).
//
// Computes, for logits of shape (B, K*D, H, W) (contiguous, fp32 or bf16) and
// each joint (b, k), the softmax over the joint's D*H*W volume and its three
// axis marginals:
//     accu_x (B, K, W), accu_y (B, K, H), accu_z (B, K, D)
// plus the joint's max m (B, K) and Z = sum exp(x - m) (B, K), all fp32. 1/Z
// is taken as 1 where Z <= 0, as the TPU kernel does.
//
// Bound on an H100: bytes. The volume is read once: B*K*D*H*W*sizeof(logit)
// bytes, 1.21 GB at the training shape (B=128, K=18, D=H=W=64, bf16), so
// >= 0.361 ms at 3.35 TB/s; 0.604 GB (>= 0.180 ms) at the serving shape
// (B=32, fp32). One exp and a few adds per logit are ~10 % of that time at
// the MUFU and issue rates, so the design is about keeping HBM busy:
//
//   * Bytes in flight. Keeping 3.35 TB/s busy at ~1 us of loaded latency
//     takes ~25 KB in flight per SM (more as the latency grows under load).
//     A thread reads U accesses of V logits per slice chunk, 16 bytes each
//     (fp32: V=4, U=4; bf16: V=8, U=2), with cp.async into its own slots of
//     a ring of P stages in shared memory (fp32 P=4, bf16 P=6), and waits
//     only on its own copies (cp.async.wait_group): slices d+1..d+P-1 are in
//     flight while it computes slice d. That is (P-1)*U*16*256 = 48 / 40 KB
//     per 256-thread block, the ring 64 / 48 KB of shared memory and no
//     register; at three blocks per SM (__launch_bounds__(256, 3)) >= 144 /
//     120 KB in flight per SM. The ring is in shared memory and not in
//     registers: four slices held in registers took 115-127 registers, so
//     two blocks per SM, and left bf16 well short of the bound (PERF.md).
//     bf16 with W % 8 != 0 takes a narrow branch of the same kernel: 8-byte
//     copies of V=4, U=4, P=6.
//   * No block barrier per slice. In the (B, K*D, H, W) layout a joint's
//     volume is D contiguous slices of H*W logits; a block walks a run of
//     them in chunks of 256*U*V = 4096 logits (one chunk per 64x64 slice),
//     and thread t always reads the same U vectors of a chunk, so it keeps
//     S = sum over d of exp(x - M) for its U*V positions in registers. The
//     online-softmax state is per warp: the running max M (exact: a max is
//     order-free) grows by a vote and a shuffle max only when some lane
//     sees a larger value, and then S is rescaled; each slice's z partial
//     is a shuffle sum that lane 0 stores with the M it was taken against.
//     Per chunk the block takes its max over the warps' M and adds S into
//     its x (per column) and y (per row) sums in shared memory, two
//     barriers per chunk; per block, the slices' z partials are rescaled
//     to the block max once, as the earlier design did per slice.
//   * A grid that fills the card. Each joint's D slices are split over a
//     cluster of `split` blocks (1, 2 or 4; ops/integral_kernel.py:
//     marginals_plan picks the smallest split whose last wave is at least
//     90 % full at three blocks per SM, else the fullest), which combine
//     their (M, Z, x/y sums) through distributed shared memory: no second
//     launch. On 132 SMs (396 resident blocks): B=32 is 576 joints, split
//     2, 1,152 blocks, 2.9 waves (the last 91 % full; split 1 would be 1.5
//     waves, the last 45 % full); B=128 is 2,304 joints, split 1, 5.8
//     waves (the last 82 % full). A block takes one joint's share: on the
//     card clusters of 4 ran slower than 1 or 2 at both batches, and
//     clusters that each walk several joints with the ring running on
//     across them were slower on the training case (PERF.md).
//   * Any H*W. A slice larger than one chunk is walked chunk by chunk (each
//     chunk over all of the block's slices), a smaller one leaves the
//     threads past its end idle. The ring is one chunk per stage whatever
//     H*W is.
//
// Limits checked by the wrapper (ops/integral_kernel.py): W % 4 == 0,
// contiguous, 16-byte aligned logits, and shared memory (the ring, W + H
// and the block's share of D, see smem_bytes) within the card's 227 KB.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // running-max start, as the TPU kernel's NEG
constexpr unsigned kFull = 0xffffffffu;

// One access of N 32-bit words (16 or 8 bytes).
template <int N>
struct Raw {
  uint32_t w[N];
};

__device__ __forceinline__ void lds(Raw<4>& r, const unsigned char* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  r.w[0] = q.x;
  r.w[1] = q.y;
  r.w[2] = q.z;
  r.w[3] = q.w;
}

__device__ __forceinline__ void lds(Raw<2>& r, const unsigned char* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  r.w[0] = q.x;
  r.w[1] = q.y;
}

// 8 bytes global -> shared, asynchronously (the narrow bf16 branch).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if (N == 4) {
    xas::cp_async16(dst, src, true);
  } else {
    cp_async8(dst, src);
  }
}

// The words of an access as floats: one fp32 logit or two bf16 logits (the
// lower half first) per word.
template <bool kBf16, int N>
__device__ __forceinline__ void unpack(const Raw<N>& r, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kBf16) {
      v[2 * i] = __uint_as_float(r.w[i] << 16);
      v[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    } else {
      v[i] = __uint_as_float(r.w[i]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared memory of a block: the ring of P stages of a chunk, then the
// floats laid out in marginals_kernel.
size_t smem_bytes(int ring_bytes, int D, int H, int W, int split) {
  const int nloc = (D + split - 1) / split;
  return ring_bytes +
         (size_t)(2 * kWarps + 2 + W + H + (2 * kWarps + 1) * nloc) *
             sizeof(float);
}

// T logits, V per access, U accesses per thread per chunk, P ring stages.
// Grid: joints * split blocks in clusters of split; the cluster of joint j
// is blocks [j*split, (j+1)*split), rank r takes slices [r*D/split,
// (r+1)*D/split).
template <typename T, int V, int U, int P>
__global__ void __launch_bounds__(kThreads, 3)
marginals_kernel(const T* __restrict__ logits, int D, int H, int W,
                 int split, float* __restrict__ ax_out,
                 float* __restrict__ ay_out, float* __restrict__ az_out,
                 float* __restrict__ m_out, float* __restrict__ z_out) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kBytes = V * (int)sizeof(T);  // one access
  constexpr int kWords = kBytes / 4;
  constexpr int kChunk = kThreads * U;  // accesses per chunk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int joint = blockIdx.x / split;
  const int d0 = rank * D / split;
  const int nloc = (rank + 1) * D / split - d0;  // this block's slices
  const int nloc_max = (D + split - 1) / split;
  const int hw = H * W;
  const int nv = hw / V;  // accesses per slice
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // ring[p][u][thread]: access u of this thread in stage p; a thread reads
  // back only what it copied itself
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + t * kBytes;
  const uint32_t ring_s = xas::smem_u32(ring);
  float* wmax = reinterpret_cast<float*>(smem_raw + P * kChunk * kBytes);
  float* red = wmax + kWarps;      // [kWarps] warp partials of the block's Z
  float* tot = red + kWarps;       // [2] the block's (M, Z), read by its peers
  float* sxy = tot + 2;            // [W + H] x then y sums, against the block max
  float* zs = sxy + W + H;         // [kWarps][nloc_max] slice partials of a warp
  float* mz = zs + kWarps * nloc_max;  // [kWarps][nloc_max] the M of each
  float* zb = mz + kWarps * nloc_max;  // [nloc_max] the block's slice sums

  for (int i = t; i < W + H; i += kThreads) sxy[i] = 0.f;
  for (int i = t; i < kWarps * nloc_max; i += kThreads) {
    zs[i] = 0.f;
    mz[i] = kNeg;
  }
  __syncthreads();

  const T* vol = logits + ((size_t)joint * D + d0) * hw;
  float* zs_w = zs + warp * nloc_max;
  float* mz_w = mz + warp * nloc_max;
  float m = kNeg;     // this warp's running max, the same in every lane
  float mblk = kNeg;  // the block's, the same in every thread
  const int nchunks = (nv + kChunk - 1) / kChunk;

  for (int c = 0; c < nchunks; ++c) {
    const int q0 = c * kChunk + t;  // this thread's first access in a slice
    float s_acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) s_acc[u][j] = 0.f;

    // a warp whose first access lies past the slice's end has nothing here
    if (nloc > 0 && c * kChunk + warp * 32 < nv) {
      bool ok[U];
      const T* src[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = q0 + u * kThreads < nv;
        src[u] = vol + (size_t)(q0 + u * kThreads) * V;
      }
      // slices 0..P-2 in flight, one commit group each
#pragma unroll
      for (int p = 0; p < P - 1; ++p) {
        if (p < nloc) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (ok[u])
              cp_async<kWords>(ring_s + (p * U + u) * kThreads * kBytes,
                               src[u] + (size_t)p * hw);
        }
        xas::cp_async_commit();
      }
      int st_in = P - 1;  // the stage slice d+P-1 goes to
      int st_out = 0;     // the stage slice d is read from
      for (int d = 0; d < nloc; ++d) {
        if (d + P - 1 < nloc) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (ok[u])
              cp_async<kWords>(ring_s + (st_in * U + u) * kThreads * kBytes,
                               src[u] + (size_t)(d + P - 1) * hw);
        }
        xas::cp_async_commit();
        xas::cp_async_wait<P - 1>();  // this thread's copies of slice d landed
        float v[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ok[u]) {
            Raw<kWords> r;
            lds(r, ring + (st_out * U + u) * kThreads * kBytes);
            unpack<kBf16>(r, v[u]);
          } else {  // -inf: adds exp(-inf) = 0
#pragma unroll
            for (int j = 0; j < V; ++j) v[u][j] = __int_as_float(0xff800000);
          }
        }
        st_in = st_in + 1 == P ? 0 : st_in + 1;
        st_out = st_out + 1 == P ? 0 : st_out + 1;
        float lm = v[0][0];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < V; ++j) lm = fmaxf(lm, v[u][j]);
        if (__any_sync(kFull, lm > m)) {  // the warp's max grows
          const float nm = warp_max(lm);
          const float f = __expf(m - nm);
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int j = 0; j < V; ++j) s_acc[u][j] *= f;
          m = nm;
        }
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float e = __expf(v[u][j] - m);
            s_acc[u][j] += e;
            s += e;
          }
        s = warp_sum(s);
        if (lane == 0) {  // earlier chunks' partial of slice d, rescaled
          zs_w[d] = zs_w[d] * __expf(mz_w[d] - m) + s;
          mz_w[d] = m;
        }
      }
    }

    // the chunk's S into the block's x/y sums, against the block's max
    if (lane == 0) wmax[warp] = m;
    __syncthreads();
    float nm = mblk;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) nm = fmaxf(nm, wmax[i]);
    if (nm > mblk) {
      const float f = __expf(mblk - nm);
      for (int i = t; i < W + H; i += kThreads) sxy[i] *= f;
      mblk = nm;
    }
    __syncthreads();
    const float f = __expf(m - mblk);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      if (q < nv) {
        const int e0 = q * V;
        const int h = e0 / W;
        const int w0 = e0 - h * W;
        float row = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float a = s_acc[u][j] * f;
          atomicAdd(&sxy[w0 + j], a);
          row += a;
        }
        atomicAdd(&sxy[W + h], row);
      }
    }
  }
  __syncthreads();

  // the block's slice sums and Z, against its max
  float part = 0.f;
  for (int i = t; i < nloc; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += zs[w * nloc_max + i] * __expf(mz[w * nloc_max + i] - mblk);
    zb[i] = a;
    part += a;
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (t == 0) {
    float z = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) z += red[w];
    tot[0] = mblk;
    tot[1] = z;
  }
  cluster.sync();  // every block of the joint has its (M, Z), sums and zb

  float mj = kNeg;
  for (int r = 0; r < split; ++r)
    mj = fmaxf(mj, cluster.map_shared_rank(tot, r)[0]);
  float z = 0.f;
  for (int r = 0; r < split; ++r) {
    const float* pt = cluster.map_shared_rank(tot, r);
    z += pt[1] * __expf(pt[0] - mj);
  }
  const float zinv = z > 0.f ? 1.f / z : 1.f;
  const float own = __expf(mblk - mj) * zinv;
  for (int i = t; i < nloc; i += kThreads)
    az_out[(size_t)joint * D + d0 + i] = zb[i] * own;
  for (int i = rank * kThreads + t; i < W + H; i += split * kThreads) {
    float a = 0.f;
    for (int r = 0; r < split; ++r) {
      const float mr = cluster.map_shared_rank(tot, r)[0];
      a += cluster.map_shared_rank(sxy, r)[i] * __expf(mr - mj);
    }
    if (i < W) {
      ax_out[(size_t)joint * W + i] = a * zinv;
    } else {
      ay_out[(size_t)joint * H + i - W] = a * zinv;
    }
  }
  if (rank == 0 && t == 0) {
    m_out[joint] = mj;
    z_out[joint] = z;
  }
  cluster.sync();  // the peers have read this block's shared memory
}

// The kernels of the three variants (the wrapper's VARIANTS, in order).
template <typename T, int V, int U, int P>
struct Variant {
  using Logit = T;
  static constexpr int kRingBytes = P * kThreads * U * V * (int)sizeof(T);
  static auto kernel() { return marginals_kernel<T, V, U, P>; }
};

using Fp32 = Variant<float, 4, 4, 4>;
using Bf16 = Variant<__nv_bfloat16, 8, 2, 6>;
using Bf16Narrow = Variant<__nv_bfloat16, 4, 4, 6>;

template <typename V>
cudaLaunchConfig_t launch_config(int joints, int D, int H, int W, int split,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(joints * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(V::kRingBytes, D, H, W, split);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename V>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(V::kernel(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename V>
cudaError_t launch(const void* logits, int joints, int D, int H, int W,
                   int split, float* ax, float* ay, float* az, float* m,
                   float* z, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<V>(joints, D, H, W, split, stream, &attr);
  cudaError_t err = prepare<V>(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, V::kernel(),
                           static_cast<const typename V::Logit*>(logits), D,
                           H, W, split, ax, ay, az, m, z);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename V>
cudaError_t info(int D, int H, int W, int split, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, V::kernel());
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<V>(1, D, H, W, split, nullptr, &attr);
  err = prepare<V>(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, V::kernel(), kThreads, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(&clusters, V::kernel(), &cfg);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)cfg.dynamicSmemBytes;
  out[3] = blocks;
  out[4] = clusters;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// variant: 0 = fp32 logits, 16-byte reads; 1 = bf16, 16-byte reads (W % 8
// == 0); 2 = bf16, 8-byte reads. split: blocks (a cluster) per joint, 1-8.
// Returns the launch's CUDA error.
int xas_integral_marginals(int variant, const void* logits, int joints,
                           int D, int H, int W, int split, float* ax,
                           float* ay, float* az, float* m, float* z,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<Fp32>(logits, joints, D, H, W, split, ax, ay, az, m, z, s);
    case 1:
      return launch<Bf16>(logits, joints, D, H, W, split, ax, ay, az, m, z, s);
    case 2:
      return launch<Bf16Narrow>(logits, joints, D, H, W, split, ax, ay, az, m,
                                z, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the card makes of a variant at a plan: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] dynamic shared bytes a block,
// out[3] resident blocks per SM, out[4] resident clusters on the card.
int xas_integral_marginals_info(int variant, int D, int H, int W, int split,
                                int* out) {
  switch (variant) {
    case 0:
      return info<Fp32>(D, H, W, split, out);
    case 1:
      return info<Bf16>(D, H, W, split, out);
    case 2:
      return info<Bf16Narrow>(D, H, W, split, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
