// 3x3 SAME convolution with bias for the physique net's channel counts (its
// convs and their stride-1 input gradients), channels-last.
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/conv_pallas.py:_conv_kernel
// (called through _conv_call / conv3x3_nhcw).
//
// Computes, with x (B, H, W, Cin) channels-last (fp32 or bf16) and bias
// (Cout) fp32:
//     y[b, oy, ox, co] = bias[co] + sum_{ky, kx, ci}
//                        w[co, ci, ky, kx] * x[b, S*oy + ky - 1, S*ox + kx - 1, ci]
// with zero padding of 1 and stride S in {1, 2}; products of working-type
// values summed in fp32; y (B, Ho, Wo, Cout) channels-last in x's type,
// Ho = (H - 1) / S + 1. The TPU kernel's NHCW layout, lane rolls and 2x2
// space-to-depth fold for stride 2 are TPU choices; here stride 2 is read
// directly.
//
// Bound on an H100: mostly bytes. The channel counts are 1 to 128, so a
// layer does 18*Cin*Cout operations per output pixel against
// (Cin/S^2 + Cout) * sizeof(T) bytes per pixel. At the flagship shape
// (B = 128, bf16) 32->32 at 256^2 moves 1.07 GB (0.32 ms) for 155 GFLOP
// (0.16 ms at the bf16 tensor-core rate); 128->128 at 64^2 and 128->64,
// 64->128 at 128^2 are bound by operations (0.16-0.31 ms). On the CUDA cores
// (67 TFLOP/s fp32) the 155 GFLOP alone take 2.3 ms, so the bf16 path with
// Cin, Cout >= 32 runs on the tensor cores.
//
// Two paths, chosen by shape in ops/conv3x3.py (conv3x3_path):
//
// tensor cores (bf16, Cin >= 32 and Cout >= 32; Cin % 32 == Cout % 32 == 0):
//   an implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin, on mma.sync
//   m16n8k16 (bf16 in, fp32 sums).
//   * A block of 8 warps owns a TH x 16 tile of output pixels of one image
//     (TH = 16 at stride 1, 8 at stride 2) and NB (32, 64 or 128) output
//     channels, so a byte-bound layer reads x about once.
//   * For each 32-channel slice of Cin, it stages the tile's
//     ((TH-1)*S + 3) x (15*S + 3) x 32 input halo and the slice's
//     (9, NB, 32) weights in shared memory with 16-byte cp.async;
//     out-of-image pixels are zero-filled, which is exactly SAME padding.
//     Two slices are in flight: the next one loads while this one is used.
//   * Each warp owns TH / 8 output rows of 16 pixels (one m16 tile each).
//     The 9 taps read shifted views of the one staged halo: ldmatrix takes
//     one address per row, so a shift by a pixel, or stride 2, costs
//     nothing. 64-byte pixels are stored with their four 16-byte chunks
//     permuted by pixel (chunk j at j ^ ((p / 2) % 4)), so the 8 rows of an
//     ldmatrix hit distinct banks (stride 1; two-way at stride 2); the
//     weights, (tap, co) rows of 32 channels, the same way.
//   * Epilogue: bias added to the fp32 sums, y rounded to bf16, staged in
//     shared memory and stored channels-last with 16-byte stores.
//
// CUDA cores (fp32, and bf16 with Cin or Cout below 32: the physique net's
// 1->32 and 32->1 and their input gradients):
//   * A block of 256 threads owns a 16 x 32 tile of output pixels of one
//     image and COB (1, 4 or 16) output channels; each thread computes
//     two pixels (rows ty and ty + 8 of the tile) for all COB channels in
//     registers.
//   * Input channels go in chunks of 4: the block stages the chunk's
//     (15*S + 3) x (31*S + 3) input halo in fp32 into shared memory (zeros
//     outside the image) and the (4, 9, COB) weights, then every thread
//     runs 9 * 4 taps, each one shared-memory read per pixel and COB FMAs
//     against weights that all threads read at one address (broadcast).
//   * The epilogue writes each pixel's COB channels contiguously, 16 bytes
//     at a time where they align.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ tensor cores

constexpr int CK = 32;       // input channels per staged slice: 64 bytes a pixel
constexpr int TC_WARPS = 8;
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int TC_TW = 16;    // tile width: one m16 row of pixels

template <int NB, int S>
struct TcTile {
  static constexpr int MT = S == 1 ? 2 : 1;  // m16 rows per warp
  static constexpr int TH = TC_WARPS * MT;
  static constexpr int IH = (TH - 1) * S + 3;
  static constexpr int IW = (TC_TW - 1) * S + 3;
  static constexpr int HALO_BYTES = IH * IW * CK * 2;
  static constexpr int W_BYTES = 9 * NB * CK * 2;
  static constexpr int STAGE_BYTES = (HALO_BYTES + W_BYTES + 127) / 128 * 128;
  static constexpr int Y_LD = NB + 8;  // bf16 staging row
  static constexpr int Y_BYTES = TH * TC_TW * Y_LD * 2;
  static int smem(int slices) {
    const int ring = (slices > 1 ? 2 : 1) * STAGE_BYTES;
    return ring > Y_BYTES ? ring : Y_BYTES;
  }
};

// byte offset of 16-byte chunk j (0..3) of 64-byte row p
__device__ __forceinline__ uint32_t sw64(int p, int j) {
  return static_cast<uint32_t>(p * 64 + ((j ^ ((p >> 1) & 3)) << 4));
}

// Two blocks an SM where the registers allow it without slowing the kernel
// (32 output channels; 64 at stride 2); the byte-bound shapes gain from the
// second block's loads.
template <int NB, int S>
__global__ void __launch_bounds__(TC_NT, (NB == 32 || (NB == 64 && S == 2)) ? 2 : 1)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ y,
                  int Cin, int Cout, int H, int W, int Ho, int Wo,
                  int tiles_x) {
  using T = TcTile<NB, S>;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int oy0 = (blockIdx.x / tiles_x) * T::TH;
  const int ox0 = (blockIdx.x % tiles_x) * TC_TW;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int iy0 = oy0 * S - 1;
  const int ix0 = ox0 * S - 1;
  const int slices = Cin / CK;

  // w is packed (Cin / 32, 9, Cout, 32): a slice's (tap, co) rows of 32
  // input channels.
  auto load = [&](int sl) {
    if (sl < slices) {
      uint8_t* halo = smem + (sl & 1) * T::STAGE_BYTES;
      uint8_t* ws = halo + T::HALO_BYTES;
      for (int v = tid; v < T::IH * T::IW * 4; v += TC_NT) {
        const int p = v / 4;
        const int j = v % 4;
        const int gy = iy0 + p / T::IW;
        const int gx = ix0 + p % T::IW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const bf16* src = ok ? x + (((size_t)b * H + gy) * W + gx) * Cin + sl * CK + j * 8 : x;
        xas::cp_async16(xas::smem_u32(halo + sw64(p, j)), src, ok);
      }
      for (int v = tid; v < 9 * NB * 4; v += TC_NT) {
        const int q = v / 4;  // tap * NB + n
        const int j = v % 4;
        const bf16* src = w + (((size_t)sl * 9 + q / NB) * Cout + n0 + q % NB) * CK + j * 8;
        xas::cp_async16(xas::smem_u32(ws + sw64(q, j)), src, true);
      }
    }
    xas::cp_async_commit();
  };

  float acc[T::MT][NB / 8][4];
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int n = 0; n < NB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // ldmatrix rows of this lane: A, pixel lane % 16 of the warp's row, K
  // chunk lane / 16 of the 16; B, output channel (lane % 8) + 8 * (lane / 16)
  // of a 16-channel pair of n8 blocks, K chunk (lane / 8) % 2.
  const int a_px = lane % 16;
  const int a_kc = lane / 16;
  const int b_n = lane % 8 + 8 * (lane / 16);
  const int b_kc = (lane / 8) % 2;

  load(0);
  for (int sl = 0; sl < slices; ++sl) {
    load(sl + 1);
    xas::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* halo = smem + (sl & 1) * T::STAGE_BYTES;
    const uint8_t* ws = halo + T::HALO_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[T::MT][4];
#pragma unroll
        for (int m = 0; m < T::MT; ++m) {
          const int p = ((warp * T::MT + m) * S + ky) * T::IW + a_px * S + kx;
          xas::ldmatrix_x4(xas::smem_u32(halo + sw64(p, 2 * kk + a_kc)), a[m]);
        }
#pragma unroll
        for (int n2 = 0; n2 < NB / 16; ++n2) {
          uint32_t bfr[4];
          xas::ldmatrix_x4(xas::smem_u32(ws + sw64(tap * NB + n2 * 16 + b_n, 2 * kk + b_kc)), bfr);
#pragma unroll
          for (int m = 0; m < T::MT; ++m) {
            xas::mma_16816(acc[m][2 * n2], a[m], bfr[0], bfr[1]);
            xas::mma_16816(acc[m][2 * n2 + 1], a[m], bfr[2], bfr[3]);
          }
        }
      }
    }
    __syncthreads();  // this slice's stage is free for slice sl + 2
  }
  xas::cp_async_wait<0>();

  // Accumulator layout: acc[m][nb] holds pixels g = lane / 4 and g + 8 of
  // the warp's m-th row, channels 8 nb + 2 (lane % 4) + {0, 1}.
  bf16* ys = reinterpret_cast<bf16*>(smem);  // [TH * 16][Y_LD]
  const int g = lane / 4;
  const int tq = lane % 4;
#pragma unroll
  for (int nb = 0; nb < NB / 8; ++nb) {
    const int col = 8 * nb + 2 * tq;
    const float b0 = __ldg(bias + n0 + col);
    const float b1 = __ldg(bias + n0 + col + 1);
#pragma unroll
    for (int m = 0; m < T::MT; ++m) {
      const int r = (warp * T::MT + m) * TC_TW + g;
      *reinterpret_cast<__nv_bfloat162*>(ys + r * T::Y_LD + col) =
          __floats2bfloat162_rn(acc[m][nb][0] + b0, acc[m][nb][1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(ys + (r + 8) * T::Y_LD + col) =
          __floats2bfloat162_rn(acc[m][nb][2] + b0, acc[m][nb][3] + b1);
    }
  }
  __syncthreads();
  for (int v = tid; v < T::TH * TC_TW * NB / 8; v += TC_NT) {
    const int r = v / (NB / 8);
    const int cv = v % (NB / 8);
    const int oy = oy0 + r / TC_TW;
    const int ox = ox0 + r % TC_TW;
    if (oy < Ho && ox < Wo) {
      *reinterpret_cast<uint4*>(y + (((size_t)b * Ho + oy) * Wo + ox) * Cout + n0 + cv * 8) =
          *reinterpret_cast<const uint4*>(ys + r * T::Y_LD + cv * 8);
    }
  }
}

template <int NB, int S>
cudaError_t launch_tc(const void* x, const void* w, const float* bias,
                      void* y, int B, int Cin, int Cout, int H, int W,
                      cudaStream_t s) {
  using T = TcTile<NB, S>;
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  const int tiles_x = (Wo + TC_TW - 1) / TC_TW;
  const int tiles_y = (Ho + T::TH - 1) / T::TH;
  const int smem = T::smem(Cin / CK);
  auto kernel = conv3x3_tc_kernel<NB, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_x * tiles_y, Cout / NB, B);
  kernel<<<grid, TC_NT, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
      static_cast<bf16*>(y), Cin, Cout, H, W, Ho, Wo, tiles_x);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_tc_nb(const void* x, const void* w, const float* bias,
                         void* y, int B, int Cin, int Cout, int H, int W,
                         int stride, cudaStream_t s) {
  return stride == 1 ? launch_tc<NB, 1>(x, w, bias, y, B, Cin, Cout, H, W, s)
                     : launch_tc<NB, 2>(x, w, bias, y, B, Cin, Cout, H, W, s);
}

// ------------------------------------------------------------ CUDA cores

constexpr int TX = 32;   // tile width (output pixels), one warp
constexpr int TY = 8;    // thread rows; each thread does rows ty and ty + TY
constexpr int OTH = 2 * TY;
constexpr int CIB = 4;   // input channels per staged chunk
constexpr int NT = TX * TY;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, bf16* p) { *p = __float2bfloat16_rn(v); }

// Stores n = 16 / sizeof(T) consecutive channels of one pixel as one 16-byte
// vector.
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

template <typename T, int COB>
__device__ __forceinline__ void store_pixel(T* yp, const float* acc, int nco,
                                            bool vec) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (COB % V == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < COB; j += V) store16(yp + j, acc + j);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < COB; ++j)
    if (j < nco) from_float(acc[j], yp + j);
}

template <typename T, int COB, int S>
__global__ void __launch_bounds__(NT)
conv3x3_cc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y, int Cin,
                  int Cout, int H, int W, int Ho, int Wo, int tiles_x) {
  constexpr int IH = (OTH - 1) * S + 3;
  constexpr int IW = (TX - 1) * S + 3;
  __shared__ float in_s[CIB][IH][IW];
  __shared__ __align__(16) float w_s[CIB][9][COB];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int oy0 = (blockIdx.x / tiles_x) * OTH;
  const int ox0 = (blockIdx.x % tiles_x) * TX;
  const int co0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const int iy0 = oy0 * S - 1;
  const int ix0 = ox0 * S - 1;

  float acc0[COB], acc1[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const float bj = co0 + j < Cout ? __ldg(bias + co0 + j) : 0.f;
    acc0[j] = bj;
    acc1[j] = bj;
  }

  const T* xb = x + (size_t)b * H * W * Cin;
  for (int c0 = 0; c0 < Cin; c0 += CIB) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < IH * IW; i += NT) {
      const int gy = iy0 + i / IW;
      const int gx = ix0 + i % IW;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* px = in ? xb + ((size_t)gy * W + gx) * Cin + c0 : xb;
#pragma unroll
      for (int ci = 0; ci < CIB; ++ci)
        in_s[ci][i / IW][i % IW] = in && c0 + ci < Cin ? to_float(px[ci]) : 0.f;
    }
    // w is packed (Cin, 9, Cout)
    for (int i = tid; i < CIB * 9 * COB; i += NT) {
      const int ci = i / (9 * COB);
      const int tap = (i / COB) % 9;
      const int j = i % COB;
      float v = 0.f;
      if (c0 + ci < Cin && co0 + j < Cout)
        v = to_float(w[((size_t)(c0 + ci) * 9 + tap) * Cout + co0 + j]);
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
  const int nco = min(COB, Cout - co0);
  const bool vec = nco == COB && Cout % (16 / (int)sizeof(T)) == 0;
  const int oy_a = oy0 + ty;
  const int oy_b = oy0 + ty + TY;
  T* yb = y + (size_t)b * Ho * Wo * Cout + co0;
  if (oy_a < Ho) store_pixel<T, COB>(yb + ((size_t)oy_a * Wo + ox) * Cout, acc0, nco, vec);
  if (oy_b < Ho) store_pixel<T, COB>(yb + ((size_t)oy_b * Wo + ox) * Cout, acc1, nco, vec);
}

template <typename T, int COB>
void launch_cc_cob(const void* x, const void* w, const float* bias, void* y,
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
    conv3x3_cc_kernel<T, COB, 1><<<grid, NT, 0, s>>>(xt, wt, bias, yt, Cin,
                                                     Cout, H, W, Ho, Wo, tiles_x);
  } else {
    conv3x3_cc_kernel<T, COB, 2><<<grid, NT, 0, s>>>(xt, wt, bias, yt, Cin,
                                                     Cout, H, W, Ho, Wo, tiles_x);
  }
}

template <typename T>
void launch_cc(const void* x, const void* w, const float* bias, void* y,
               int B, int Cin, int Cout, int H, int W, int stride,
               cudaStream_t s) {
  if (Cout == 1) {
    launch_cc_cob<T, 1>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else if (Cout < 16) {
    launch_cc_cob<T, 4>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else {
    // 16 channels a block: 32 take about 140 registers a thread, which
    // leaves room for one block an SM
    launch_cc_cob<T, 16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  }
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Tensor-core path: bf16 x, w packed (Cin / 32, 9, Cout, 32), Cin % 32 == 0,
// Cout % 32 == 0; stride 1 or 2. Returns a CUDA error code, 0 on success.
int xas_conv3x3_tc(const void* x, const void* w, const float* bias, void* y,
                   int B, int Cin, int Cout, int H, int W, int stride,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin % CK || Cout % 32 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (Cout % 128 == 0) {
    err = launch_tc_nb<128>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else if (Cout % 64 == 0) {
    err = launch_tc_nb<64>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else {
    err = launch_tc_nb<32>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  }
  return static_cast<int>(err);
}

// CUDA-core path: dtype 0 = fp32, 1 = bf16 (x, w and y); w packed
// (Cin, 9, Cout); stride 1 or 2. Returns a CUDA error code, 0 on success.
int xas_conv3x3_cc(int dtype, const void* x, const void* w, const float* bias,
                   void* y, int B, int Cin, int Cout, int H, int W, int stride,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    launch_cc<float>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else {
    launch_cc<bf16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
