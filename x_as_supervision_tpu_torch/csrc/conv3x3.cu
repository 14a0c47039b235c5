// 3x3 SAME convolution with bias for small channel counts (the physique
// net's convs and their stride-1 input gradients).
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/conv_pallas.py:_conv_kernel
// (called through _conv_call / conv3x3_nhcw).
//
// Computes, with x (B, Cin, H, W) NCHW contiguous (fp32 or bf16), w
// (Cout, Cin, 3, 3) in x's type and bias (Cout) fp32:
//     y[b, co, oy, ox] = bias[co] + sum_{ci, ky, kx}
//                        w[co, ci, ky, kx] * x[b, ci, S*oy + ky - 1, S*ox + kx - 1]
// with zero padding of 1 and stride S in {1, 2}; products and sums in fp32,
// y (B, Cout, Ho, Wo) stored in x's type, Ho = (H - 1) / S + 1.
// The TPU kernel's NHCW layout, lane rolls and 2x2 space-to-depth fold for
// stride 2 are TPU choices; here stride 2 is computed directly.
//
// Bound on an H100: mostly bytes. The channel counts are 1 to 128, so a
// layer does 18*Cin*Cout operations per output pixel against
// (Cin + Cout) * sizeof(T) bytes per pixel. At the flagship shape (B = 128,
// bf16) 32->32 at 256^2 moves 1.07 GB (0.32 ms) for 155 GFLOP (0.16 ms of
// bf16 tensor-core rate); 128->128 at 64^2 is the same count on fewer bytes
// and is bound by operations. This first version runs the products on the
// CUDA cores in fp32 (67 TFLOP/s peak), so it is bound by its own FMA rate,
// not by the card's; tensor cores are left to a later change.
//
// Design, simple and right first:
//   * A block of 256 threads owns a 16 x 32 tile of output pixels of one
//     image and COB (1, 4 or 16) output channels; each thread computes two
//     pixels (rows ty and ty + 8 of the tile) for all COB channels in
//     registers.
//   * Input channels go in chunks of CIB = 4: the block stages the chunk's
//     (15*S + 3) x (31*S + 3) input halo tile in fp32 into shared memory
//     (zeros outside the image) and the (CIB, 9, COB) weights, then every
//     thread runs 9 * CIB taps, each one shared-memory read per pixel and
//     COB FMAs against weights that all threads read at one address
//     (broadcast).
//   * The epilogue writes each channel's 32-pixel rows coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;   // tile width (output pixels), one warp
constexpr int TY = 8;    // thread rows; each thread does rows ty and ty + TY
constexpr int OTH = 2 * TY;
constexpr int CIB = 4;   // input channels per staged chunk
constexpr int NT = TX * TY;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

template <typename T, int COB, int S>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y, int Cin,
               int Cout, int H, int W, int Ho, int Wo, int tiles_x) {
  constexpr int IH = (OTH - 1) * S + 3;
  constexpr int IW = (TX - 1) * S + 3;
  __shared__ float in_s[CIB][IH][IW];
  __shared__ __align__(16) float w_s[CIB][9][COB];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int tile_y = blockIdx.x / tiles_x;
  const int tile_x = blockIdx.x % tiles_x;
  const int co0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const int oy0 = tile_y * OTH;
  const int ox0 = tile_x * TX;
  const int iy0 = oy0 * S - 1;
  const int ix0 = ox0 * S - 1;

  float acc0[COB], acc1[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const float bj = co0 + j < Cout ? __ldg(bias + co0 + j) : 0.f;
    acc0[j] = bj;
    acc1[j] = bj;
  }

  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * Cin * plane;
  for (int c0 = 0; c0 < Cin; c0 += CIB) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < CIB * IH * IW; i += NT) {
      const int ci = i / (IH * IW);
      const int r = i % (IH * IW);
      const int gy = iy0 + r / IW;
      const int gx = ix0 + r % IW;
      float v = 0.f;
      if (c0 + ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_float(xb[(size_t)(c0 + ci) * plane + (size_t)gy * W + gx]);
      in_s[ci][r / IW][r % IW] = v;
    }
    for (int i = tid; i < CIB * 9 * COB; i += NT) {
      const int ci = i / (9 * COB);
      const int tap = (i / COB) % 9;
      const int j = i % COB;
      float v = 0.f;
      if (c0 + ci < Cin && co0 + j < Cout)
        v = to_float(w[((size_t)(co0 + j) * Cin + c0 + ci) * 9 + tap]);
      w_s[ci][tap][j] = v;
    }
    __syncthreads();
    const int nci = min(CIB, Cin - c0);
#pragma unroll
    for (int ci = 0; ci < CIB; ++ci) {
      if (ci < nci) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3;
          const int kx = tap % 3;
          const float a0 = in_s[ci][ty * S + ky][tx * S + kx];
          const float a1 = in_s[ci][(ty + TY) * S + ky][tx * S + kx];
          if constexpr (COB % 4 == 0) {
#pragma unroll
            for (int j = 0; j < COB; j += 4) {
              const float4 wv = *reinterpret_cast<const float4*>(&w_s[ci][tap][j]);
              acc0[j] = fmaf(a0, wv.x, acc0[j]);
              acc0[j + 1] = fmaf(a0, wv.y, acc0[j + 1]);
              acc0[j + 2] = fmaf(a0, wv.z, acc0[j + 2]);
              acc0[j + 3] = fmaf(a0, wv.w, acc0[j + 3]);
              acc1[j] = fmaf(a1, wv.x, acc1[j]);
              acc1[j + 1] = fmaf(a1, wv.y, acc1[j + 1]);
              acc1[j + 2] = fmaf(a1, wv.z, acc1[j + 2]);
              acc1[j + 3] = fmaf(a1, wv.w, acc1[j + 3]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < COB; ++j) {
              const float wv = w_s[ci][tap][j];
              acc0[j] = fmaf(a0, wv, acc0[j]);
              acc1[j] = fmaf(a1, wv, acc1[j]);
            }
          }
        }
      }
    }
  }

  const int ox = ox0 + tx;
  if (ox >= Wo) return;
  const int oy_a = oy0 + ty;
  const int oy_b = oy0 + ty + TY;
  T* yb = y + (size_t)b * Cout * Ho * Wo;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = co0 + j;
    if (co >= Cout) break;
    T* yc = yb + (size_t)co * Ho * Wo;
    if (oy_a < Ho) from_float(acc0[j], yc + (size_t)oy_a * Wo + ox);
    if (oy_b < Ho) from_float(acc1[j], yc + (size_t)oy_b * Wo + ox);
  }
}

template <typename T, int COB>
void launch_cob(const void* x, const void* w, const float* bias, void* y,
                int B, int Cin, int Cout, int H, int W, int stride,
                cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int tiles_x = (Wo + TX - 1) / TX;
  const int tiles_y = (Ho + OTH - 1) / OTH;
  const dim3 grid(tiles_x * tiles_y, (Cout + COB - 1) / COB, B);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (stride == 1) {
    conv3x3_kernel<T, COB, 1><<<grid, NT, 0, s>>>(xt, wt, bias, yt, Cin, Cout,
                                                  H, W, Ho, Wo, tiles_x);
  } else {
    conv3x3_kernel<T, COB, 2><<<grid, NT, 0, s>>>(xt, wt, bias, yt, Cin, Cout,
                                                  H, W, Ho, Wo, tiles_x);
  }
}

template <typename T>
void launch(const void* x, const void* w, const float* bias, void* y, int B,
            int Cin, int Cout, int H, int W, int stride, cudaStream_t s) {
  if (Cout == 1) {
    launch_cob<T, 1>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else if (Cout < 16) {
    launch_cob<T, 4>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else {
    launch_cob<T, 16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  }
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = fp32, 1 = bf16 (x, w and y); stride 1 or 2. Returns
// cudaGetLastError().
int xas_conv3x3(int dtype, const void* x, const void* w, const float* bias,
                void* y, int B, int Cin, int Cout, int H, int W, int stride,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else {
    launch<__nv_bfloat16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
