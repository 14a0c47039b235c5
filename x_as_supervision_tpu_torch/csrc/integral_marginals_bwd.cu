// Backward of the integral decode's softmax marginals, one pass over the
// logits.
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/integral_pallas.py:_bwd_kernel
// (called through _marginals_vjp_bwd).
//
// For logits x of shape (B, K*D, H, W) (contiguous, fp32 or bf16), the
// forward's per-joint max m and sum Z (B*K, fp32), the cotangents of the three
// marginals gx (B, K, W), gy (B, K, H), gz (B, K, D) and the per-joint inner
// product <p, g> = sum gx*ax + sum gy*ay + sum gz*az (B*K, computed by the
// wrapper from the forward marginals, as the TPU version does outside its
// kernel), it writes
//     dx[b, k*D + d, h, w] = p * (gx[w] + gy[h] + gz[d] - <p, g>),
//     p = exp(x - m) / Z          (1/Z taken as 1 where Z <= 0)
// in x's type. p is rebuilt from the saved scalars: no softmax volume is kept
// between the passes.
//
// Bound on an H100: bytes. The kernel reads every logit once and writes every
// gradient once: at the flagship shape (B = 128, K = 18, D = H = W = 64,
// bf16) 2 x 1.21 GB, >= 0.72 ms at 3.35 TB/s. The cotangent vectors are a few
// MB and stay in L2. So the design is an elementwise grid-stride pass with
// one 16-byte load and one 16-byte store per thread and step (4 fp32 or 8
// bf16 logits, all in one row since W % VEC == 0), and an accurate expf (the
// arithmetic is far below the card's rate).
//
// Limits checked by the wrapper (ops/integral_kernel.py): W % (16 /
// sizeof(logit)) == 0, 16-byte aligned contiguous logits and gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float v[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(256)
marginals_bwd_kernel(const T* __restrict__ x, const float* __restrict__ m,
                     const float* __restrict__ z,
                     const float* __restrict__ inner,
                     const float* __restrict__ gx, const float* __restrict__ gy,
                     const float* __restrict__ gz, T* __restrict__ dx,
                     size_t vecs, int D, int H, int W) {
  constexpr int N = Vec<T>::N;
  const size_t hw = (size_t)H * W;
  const size_t dhw = hw * D;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < vecs;
       v += (size_t)gridDim.x * blockDim.x) {
    const size_t i = v * N;  // first element; the N elements share a row
    const size_t joint = i / dhw;
    const size_t r = i - joint * dhw;
    const int d = (int)(r / hw);
    const int h = (int)((r / W) % H);
    const int w0 = (int)(r % W);
    const float zj = __ldg(z + joint);
    const float zinv = zj > 0.f ? 1.f / zj : 1.f;
    const float mj = __ldg(m + joint);
    const float base = __ldg(gy + joint * H + h) + __ldg(gz + joint * D + d) -
                       __ldg(inner + joint);
    const float* gxr = gx + joint * W + w0;
    float val[N];
    Vec<T>::load(x + i, val);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float p = expf(val[j] - mj) * zinv;
      val[j] = p * (__ldg(gxr + j) + base);
    }
    Vec<T>::store(dx + i, val);
  }
}

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 per SM, grid-stride beyond

template <typename T>
void launch(const void* x, const float* m, const float* z, const float* inner,
            const float* gx, const float* gy, const float* gz, void* dx,
            size_t total, int D, int H, int W, cudaStream_t s) {
  const size_t vecs = total / Vec<T>::N;
  size_t blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks == 0) return;
  marginals_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), m, z, inner, gx, gy, gz, static_cast<T*>(dx),
      vecs, D, H, W);
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = fp32 logits, 1 = bf16 logits; joints = B * K. Returns
// cudaGetLastError().
int xas_integral_marginals_bwd(int dtype, const void* x, const float* m,
                               const float* z, const float* inner,
                               const float* gx, const float* gy,
                               const float* gz, void* dx, int joints, int D,
                               int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)joints * D * H * W;
  if (dtype == 0) {
    launch<float>(x, m, z, inner, gx, gy, gz, dx, total, D, H, W, s);
  } else {
    launch<__nv_bfloat16>(x, m, z, inner, gx, gy, gz, dx, total, D, H, W, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
