// Softmax marginals of the integral decode, one block per joint.
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
// Bound on an H100: bytes. The kernel must read the volume once:
// B*K*D*H*W*sizeof(logit) bytes; at the serving shape (B=32, K=18, D=H=W=64,
// fp32 logits) that is 604 MB, so >= 180 us at 3.35 TB/s (>= 45 us at B=8).
// The arithmetic is one exp and a few adds per element, far below the
// card's rate, so the design aims at one coalesced read of the volume:
//
//   * In the (B, K*D, H, W) layout joint k's volume is one contiguous block of
//     D slices of H*W values. A block of H*W/4 threads walks it slice by
//     slice; thread t always loads the same 4 consecutive values (one 16-byte
//     fp32 or 8-byte bf16 load) of each slice, so its column w and row h never
//     change. It keeps its x partial sums (4 values) and its y partial sum in
//     registers for the whole walk.
//   * Online softmax: per slice the block takes the slice max, raises the
//     running max M and rescales the register sums when M grows; the slice sum
//     (the z marginal at d) is stored with the M it was taken against and
//     rescaled once at the end. The next slice's load is issued before the
//     current slice's reductions, so the read stays in flight across them.
//   * At the end the threads that share a column (row) add their register
//     sums into shared memory once, and the block writes the normalized
//     marginals.
//
// Limits checked by the wrapper (ops/integral_kernel.py): W % 4 == 0 and
// H*W <= 4096 (one slice per block pass, at most 1024 threads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // running-max start, as the TPU kernel's NEG
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(1024)
marginals_kernel(const T* __restrict__ logits, int D, int H, int W,
                 float* __restrict__ ax_out, float* __restrict__ ay_out,
                 float* __restrict__ az_out, float* __restrict__ m_out,
                 float* __restrict__ z_out) {
  extern __shared__ float smem[];
  float* red_max = smem;        // [32] per-warp slice max
  float* red_sum = smem + 32;   // [32] per-warp slice sum
  float* total = smem + 64;     // [1]  Z, broadcast
  float* zs = smem + 96;        // [D]  slice sums, each against mrun[d]
  float* mrun = zs + D;         // [D]  running max when slice d was summed
  float* sx = mrun + D;         // [W]
  float* sy = sx + W;           // [H]

  const int joint = blockIdx.x;  // b * K + k
  const int hw = H * W;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool active = t < hw / 4;
  const T* base = logits + (size_t)joint * D * hw + 4 * t;

  for (int i = t; i < W; i += blockDim.x) sx[i] = 0.f;
  for (int i = t; i < H; i += blockDim.x) sy[i] = 0.f;

  float ax[4] = {0.f, 0.f, 0.f, 0.f};
  float ay = 0.f;
  float m = kNeg;
  float nxt[4] = {kNeg, kNeg, kNeg, kNeg};
  if (active) load4(base, nxt);

  for (int d = 0; d < D; ++d) {
    float v[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
    if (active && d + 1 < D) load4(base + (size_t)(d + 1) * hw, nxt);

    float lm = warp_max(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
    if (lane == 0) red_max[warp] = lm;
    __syncthreads();
    // Every warp reduces the same per-warp values in the same order, so all
    // threads hold the same slice max without a second barrier.
    const float bm = warp_max(lane < nwarps ? red_max[lane] : kNeg);
    if (bm > m) {  // uniform across the block
      const float f = __expf(m - bm);
      ax[0] *= f;
      ax[1] *= f;
      ax[2] *= f;
      ax[3] *= f;
      ay *= f;
      m = bm;
    }
    float s = 0.f;
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = __expf(v[j] - m);
        ax[j] += e;
        s += e;
      }
    }
    ay += s;
    s = warp_sum(s);
    if (lane == 0) red_sum[warp] = s;
    __syncthreads();
    if (warp == 0) {
      const float bs = warp_sum(lane < nwarps ? red_sum[lane] : 0.f);
      if (lane == 0) {
        zs[d] = bs;
        mrun[d] = m;
      }
    }
    // red_max is next written after this iteration's first barrier, which
    // every reader of it has passed; red_sum is next written after the next
    // iteration's first barrier, which warp 0 reaches only after reading it.
  }

  if (active) {
    const int w0 = (4 * t) % W;
    const int h = (4 * t) / W;
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(&sx[w0 + j], ax[j]);
    atomicAdd(&sy[h], ay);
  }
  __syncthreads();
  if (warp == 0) {
    float part = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float zi = zs[i] * __expf(mrun[i] - m);
      zs[i] = zi;
      part += zi;
    }
    part = warp_sum(part);
    if (lane == 0) total[0] = part;
  }
  __syncthreads();
  const float z = total[0];
  const float zinv = z > 0.f ? 1.f / z : 1.f;
  for (int i = t; i < W; i += blockDim.x) ax_out[(size_t)joint * W + i] = sx[i] * zinv;
  for (int i = t; i < H; i += blockDim.x) ay_out[(size_t)joint * H + i] = sy[i] * zinv;
  for (int i = t; i < D; i += blockDim.x) az_out[(size_t)joint * D + i] = zs[i] * zinv;
  if (t == 0) {
    m_out[joint] = m;
    z_out[joint] = z;
  }
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = fp32 logits, 1 = bf16 logits. Returns cudaGetLastError().
int xas_integral_marginals(int dtype, const void* logits, int joints, int D,
                           int H, int W, float* ax, float* ay, float* az,
                           float* m, float* z, void* stream) {
  const int quads = H * W / 4;
  const int threads = (quads + 31) / 32 * 32;
  const size_t smem = (96 + 2 * D + W + H) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    marginals_kernel<float><<<joints, threads, smem, s>>>(
        static_cast<const float*>(logits), D, H, W, ax, ay, az, m, z);
  } else {
    marginals_kernel<__nv_bfloat16><<<joints, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(logits), D, H, W, ax, ay, az, m, z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
