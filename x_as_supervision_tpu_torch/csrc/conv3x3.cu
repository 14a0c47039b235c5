// 3x3 SAME convolution with bias for the physique net's channel counts (its
// convs and their stride-1 input gradients), channels-last.
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/conv_pallas.py:91
// _conv_kernel (called through _conv_call, :149, and conv3x3_nhcw).
//
// Computes, with x (B, H, W, Cin) channels-last (fp32 or bf16) and bias
// (Cout) fp32 or none:
//     y[b, oy, ox, co] = bias[co] + sum_{ky, kx, ci}
//                        w[co, ci, ky, kx] * x[b, S*oy + ky - 1, S*ox + kx - 1, ci]
// with zero padding of 1 and stride S in {1, 2}; products of working-type
// values summed in fp32; y (B, Ho, Wo, Cout) channels-last in x's type,
// Ho = (H - 1) / S + 1. The TPU kernel's NHCW layout, lane rolls and 2x2
// space-to-depth fold for stride 2 are TPU choices; here every kernel reads
// stride 2 directly and stages only the halo its outputs need.
//
// Bound on an H100: 18*Cin*Cout operations per output pixel against
// (Cin/S^2 + Cout) * sizeof(T) bytes. At the flagship shape (B = 128, bf16)
// 32->32 at 256^2 moves 1.07 GB (0.32 ms) for 155 GFLOP (0.16 ms at the
// bf16 tensor-core rate); 1->32 and 32->1 move 0.55 GB (0.165 ms) for 4.8
// GFLOP: bytes. In fp32 on the FMA units (67 TFLOP/s) every conv with 16 or
// more channels on both sides is bound by operations.
//
// Three paths, chosen by shape in ops/conv3x3.py (conv3x3_path):
//
// thin (Cin = 1 or Cout = 1, fp32 and bf16: the physique net's first and
// last convs and their input gradients). Bound by bytes; see
// conv3x3_thin_kernel.
//
// tensor cores (bf16, Cin % 16 == 0 and Cout % 16 == 0, both above 1):
//   an implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin, on mma.sync
//   m16n8k16 (bf16 in, fp32 sums).
//   * A block of 8 warps owns a TH x 16 tile of output pixels of one image
//     (TH = 16 at stride 1, 8 at stride 2) and NB (16, 32, 64 or 128)
//     output channels, so a byte-bound layer reads x about once.
//   * For each 32-channel slice of Cin, it stages the tile's
//     ((TH-1)*S + 3) x (15*S + 3) x 32 input halo and the slice's
//     (9, NB, 32) weights in shared memory with 16-byte cp.async;
//     out-of-image pixels are zero-filled, which is exactly SAME padding,
//     and so are the upper 16 channels of a last slice of 16 (Cin % 32 ==
//     16: a tensor-parallel rank's 16-channel shard), whose packed weights
//     are zero. Two slices are in flight: the next one loads while this
//     one is used.
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
// FMA units (everything else: fp32 at every width, bf16 with channel
// counts off the multiples of 16): a register-tiled implicit GEMM; see
// conv3x3_fma_kernel.

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
// (16 and 32 output channels; 64 at stride 2); the byte-bound shapes gain
// from the second block's loads.
template <int NB, int S>
__global__ void __launch_bounds__(TC_NT, (NB <= 32 || (NB == 64 && S == 2)) ? 2 : 1)
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
  const int slices = (Cin + CK - 1) / CK;

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
        // a last slice of 16 channels (Cin % 32 == 16) zero-fills its upper
        // half; its packed weights are zero there
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && sl * CK + j * 8 < Cin;
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
    const float b0 = bias ? __ldg(bias + n0 + col) : 0.f;
    const float b1 = bias ? __ldg(bias + n0 + col + 1) : 0.f;
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
  const int smem = T::smem((Cin + CK - 1) / CK);
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

// ------------------------------------------------ shared by the CUDA-core kernels

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, bf16* p) { *p = __float2bfloat16_rn(v); }

// 16 bytes of shared memory as 4 floats
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Stores 16 / sizeof(T) consecutive channels of one pixel as one 16-byte
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

// Halo column hx (0 .. IW-1) at stride 2 is stored at position
// (hx & 1) * NE + hx / 2, NE = (IW + 1) / 2: the even columns, then the odd
// ones, so that the lanes of a warp, whose outputs are 2 columns apart in
// the input, read consecutive positions. At stride 1 the column is its own
// position.
template <int S>
__device__ __forceinline__ int halo_pos(int hx, int iw) {
  if constexpr (S == 1) {
    return hx;
  } else {
    return (hx & 1) * ((iw + 1) / 2) + (hx >> 1);
  }
}

// ------------------------------------------------------------ thin kernel

constexpr int THIN_E_NT = 256;  // Cin = 1: 8 warps
constexpr int THIN_E_TW = 64;   // output tile: 16 rows x 64 columns
constexpr int THIN_E_TH = 16;
constexpr int THIN_R_NT = 128;  // Cout = 1: 4 warps, each 32 columns
constexpr int THIN_R_TW = 32;
constexpr int THIN_R_ROWS = 4;  // output rows a thread (stride 1; 2 at stride 2)
constexpr int THIN_R_TILES = 1; // tiles a block, down its column strip
constexpr int THIN_SLOT = 64;   // bytes of one pixel's channels a pass stages

// the thin kernel's weights in shared memory: (9, C padded to 32)
__host__ __device__ constexpr int thin_cpad(int c) { return (c + 31) / 32 * 32; }

// w's fp32 value rounded to the working type and back: what the products
// take (exact for fp32)
template <typename T>
__device__ __forceinline__ float round_w(float v);
template <>
__device__ __forceinline__ float round_w<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_w<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int S>
struct ThinReduce {
  static constexpr int ROWS = S == 1 ? THIN_R_ROWS : THIN_R_ROWS / 2;
  static constexpr int TH = ROWS * (THIN_R_NT / 32);
  static constexpr int IH = (TH - 1) * S + 3;
  static constexpr int IW = (THIN_R_TW - 1) * S + 3;
  static constexpr int HALO_BYTES = IH * IW * THIN_SLOT;
  // two halo buffers where a block has more than one stage
  static __host__ __device__ int buffers(int passes, int tiles_y) {
    return (tiles_y < THIN_R_TILES ? tiles_y : THIN_R_TILES) * passes > 1 ? 2 : 1;
  }
  static int smem(int cpad, int passes, int tiles_y) {
    return buffers(passes, tiles_y) * HALO_BYTES + 9 * cpad * 4;
  }
};

// Cin = 1 (EXPAND; Cout = 1 too) or Cout = 1 with Cin > 1 (reduce); w
// (C, 9) fp32, C the side that is not 1, K order (channel, tap): w as the
// module holds it, rounded to T here (so the wrapper launches no packing
// copy).
template <typename T, int S, bool EXPAND>
__global__ void __launch_bounds__(EXPAND ? THIN_E_NT : THIN_R_NT, EXPAND ? 2 : 4)
conv3x3_thin_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    int C, int H, int W, int Ho, int Wo, int tiles_x) {
  constexpr int V = 16 / sizeof(T);  // channels in 16 bytes
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.z;

  if constexpr (EXPAND) {
    // y[p, co] = bias[co] + sum_tap w[tap, co] x[p + tap]: 9 FMAs per
    // output value against its 2 or 4 bytes written. A lane owns one
    // 16-byte vector of a pixel's Cout channels, its 9 x V weights in
    // registers; a warp stores 32 / nv consecutive pixels, one
    // contiguous run. The one-channel halo is staged once, in fp32.
    constexpr int TH = THIN_E_TH, TW = THIN_E_TW;
    constexpr int IH = (TH - 1) * S + 3, IW = (TW - 1) * S + 3;
    float* in_s = reinterpret_cast<float*>(smem);  // [IH][IW]
    // this block's weights, rounded: [9][nv * V], 16-byte aligned
    float* ws = in_s + (IH * IW + 3) / 4 * 4;
    const int oy0 = (blockIdx.x / tiles_x) * TH;
    const int ox0 = (blockIdx.x % tiles_x) * TW;
    const int iy0 = oy0 * S - 1;
    const int ix0 = ox0 * S - 1;
    const T* xb = x + (size_t)b * H * W;
    for (int i = tid; i < IH * IW; i += THIN_E_NT) {
      const int gy = iy0 + i / IW;
      const int gx = ix0 + i % IW;
      in_s[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                    ? to_float(xb[(size_t)gy * W + gx]) : 0.f;
    }
    const int nv_all = (C + V - 1) / V;
    const int v0 = blockIdx.y * 32;  // a block covers at most 32 vectors
    const int nv = min(32, nv_all - v0);
    const int nc = nv * V;
    for (int i = tid; i < 9 * nc; i += THIN_E_NT) {
      const int c = v0 * V + i % nc;
      ws[i] = c < C ? round_w<T>(w[c * 9 + i / nc]) : 0.f;
    }
    __syncthreads();
    const int ppw = 32 / nv;  // pixels a warp step
    const int j = lane % nv;
    const int pl = lane / nv;
    const int co = (v0 + j) * V;
    float wr[9][V];
    float br[V];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        const float4 f = *reinterpret_cast<const float4*>(ws + t * nc + j * V + v);
        wr[t][v] = f.x;
        wr[t][v + 1] = f.y;
        wr[t][v + 2] = f.z;
        wr[t][v + 3] = f.w;
      }
#pragma unroll
    for (int v = 0; v < V; ++v)
      br[v] = bias && co + v < C ? __ldg(bias + co + v) : 0.f;
    if (pl >= ppw) return;
    const bool vec = C % V == 0;
    for (int p = warp * ppw + pl; p < TH * TW; p += (THIN_E_NT / 32) * ppw) {
      const int r = p / TW;
      const int c = p % TW;
      const int oy = oy0 + r;
      const int ox = ox0 + c;
      if (oy >= Ho || ox >= Wo) continue;
      float xv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) xv[t] = in_s[(r * S + t / 3) * IW + c * S + t % 3];
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[v] = br[v];
#pragma unroll
        for (int t = 0; t < 9; ++t) acc[v] = fmaf(xv[t], wr[t][v], acc[v]);
      }
      T* yp = y + (((size_t)b * Ho + oy) * Wo + ox) * C + co;
      if (vec) {
        store16(yp, acc);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (co + v < C) from_float(acc[v], yp + v);
      }
    }
  } else {
    // y[p] = bias + sum_{tap, ci} w[tap, ci] x[p + tap, ci]: 64 bytes read
    // per pixel (bf16, 32 channels) for 2 written. A block owns a column
    // strip of 32 outputs and THIN_R_TILES tiles of TH rows down it. Per
    // tile it stages the (TH + 2) x 34 halo (stride 2: 2 TH + 1 rows x 65)
    // with 16-byte cp.async, 64 bytes of each pixel's channels a pass (one
    // pass at bf16 Cin = 32), so each input byte crosses from memory once
    // but for the halo's overlap; where a block has more than one stage
    // (passes, tiles) the next one loads while this one is summed. The
    // 16-byte chunk j of pixel slot q sits at j ^ ((q / 2) % 4), so 8
    // consecutive slots fill the 8 bank groups (ldmatrix's 8 rows, or a
    // quarter warp's 16-byte reads). The sum over 288 products per output
    // would keep the FMA units busier than the bytes keep the memory, so
    // in bf16 it runs on the tensor cores.
    using R = ThinReduce<S>;
    constexpr int ROWS = R::ROWS, IH = R::IH, IW = R::IW;
    constexpr int GC = THIN_SLOT / sizeof(T);  // channels a pass
    static_assert(THIN_R_NT / 4 < IW, "the loader steps at most one halo row");
    const int tiles_y = (Ho + R::TH - 1) / R::TH;
    const int passes = (C + GC - 1) / GC;
    float* ws = reinterpret_cast<float*>(
        smem + R::buffers(passes, tiles_y) * R::HALO_BYTES);  // [9][cpad]
    const int ty0 = (blockIdx.x / tiles_x) * THIN_R_TILES;
    const int ox0 = (blockIdx.x % tiles_x) * THIN_R_TW;
    const int ix0 = ox0 * S - 1;
    const int stages = min(THIN_R_TILES, tiles_y - ty0) * passes;
    const int cpad = thin_cpad(C);
    for (int i = tid; i < 9 * cpad; i += THIN_R_NT) {
      const int c = i % cpad;
      ws[i] = c < C ? round_w<T>(w[c * 9 + i / cpad]) : 0.f;
    }
    const T* xb = x + (size_t)b * H * W * C;
    const bool vec_in = C % V == 0;  // pixel rows 16-byte aligned

    auto load = [&](int st) {
      if (st < stages) {
        uint8_t* halo = smem + (st & 1) * R::HALO_BYTES;
        const int iy0 = (ty0 + st / passes) * R::TH * S - 1;
        const int g0 = (st % passes) * GC;
        // thread tid stages chunk tid % 4 of every 32nd pixel: (hy, hx)
        // stepped, not divided out, each time
        const int j = tid % 4;
        int hy = 0;
        int hx = tid / 4;
        for (int px = tid / 4; px < IH * IW; px += THIN_R_NT / 4) {
          const int gy = iy0 + hy;
          const int gx = ix0 + hx;
          const int ch = g0 + j * V;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          uint8_t* dst = halo + sw64(hy * IW + halo_pos<S>(hx, IW), j);
          const T* src = xb + ((size_t)gy * W + gx) * C + ch;
          if (vec_in) {
            xas::cp_async16(xas::smem_u32(dst), in && ch < C ? src : x, in && ch < C);
          } else {
            T* d = reinterpret_cast<T*>(dst);
#pragma unroll
            for (int e = 0; e < V; ++e)
              d[e] = in && ch + e < C ? src[e] : T(0.f);
          }
          hx += THIN_R_NT / 4;  // 32 < IW: at most one row further
          if (hx >= IW) {
            hx -= IW;
            ++hy;
          }
        }
      }
      xas::cp_async_commit();
    };

    // bf16: tensor cores (mma.sync m16n8k16, fp32 sums of the exact bf16
    // products). A warp's ROWS output rows are 2 ROWS m16 tiles of 16
    // pixels; A, a tile's pixels x 16 channels at one tap, comes from the
    // staged halo by ldmatrix (a shifted view, as in the tensor-core
    // kernel); B holds the tap's 16 weights in column 0 and zeros in the
    // other 7, so D's column 0 is the tile's sums. fp32: FMAs, a lane's
    // column and ROWS rows, two sums a row (even and odd channels).
    constexpr bool MMA = sizeof(T) == 2;
    constexpr int TILES = 2 * ROWS;  // m16 tiles a warp (bf16)
    float acc[MMA ? TILES : ROWS][MMA ? 4 : 2];
    const float b0 = bias ? __ldg(bias) : 0.f;
#pragma unroll
    for (int r = 0; r < (MMA ? TILES : ROWS); ++r)
#pragma unroll
      for (int e = 0; e < (MMA ? 4 : 2); ++e) acc[r][e] = 0.f;
    load(0);
    for (int st = 0; st < stages; ++st) {
      load(st + 1);
      xas::cp_async_wait<1>();
      __syncthreads();
      const uint8_t* halo = smem + (st & 1) * R::HALO_BYTES;
      const int g0 = (st % passes) * GC;
      if constexpr (MMA) {
        // B fragments of this pass: lanes 0-3 hold column 0, channels
        // 2 (lane % 4) + {0, 1} (b[.][0]) and + 8 (b[.][1]) of each
        // 16-channel half of the 64-byte slot
        uint32_t bw[9][2][2];
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* wp = ws + t * cpad + g0 + kk * 16 + h * 8 + 2 * (lane % 4);
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  lane < 4 ? wp[0] : 0.f, lane < 4 ? wp[1] : 0.f);
              bw[t][kk][h] = *reinterpret_cast<const uint32_t*>(&v);
            }
        const int a_px = lane % 16;
        const int a_kc = lane / 16;
#pragma unroll
        for (int m = 0; m < TILES; ++m) {
          const int r = m / 2;  // the warp's r-th output row
          const int col = (m % 2) * 16 + a_px;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int q = ((warp * ROWS + r) * S + t / 3) * IW +
                          halo_pos<S>(col * S + t % 3, IW);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              uint32_t a[4];
              xas::ldmatrix_x4(xas::smem_u32(halo + sw64(q, 2 * kk + a_kc)), a);
              xas::mma_16816(acc[m], a, bw[t][kk][0], bw[t][kk][1]);
            }
          }
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          if (g0 + j * V >= C) break;
          float wj[9][V];
#pragma unroll
          for (int t = 0; t < 9; ++t)
#pragma unroll
            for (int v = 0; v < V; v += 4) {
              const float4 f = *reinterpret_cast<const float4*>(ws + t * cpad + g0 + j * V + v);
              wj[t][v] = f.x;
              wj[t][v + 1] = f.y;
              wj[t][v + 2] = f.z;
              wj[t][v + 3] = f.w;
            }
          // input rows of this lane's outputs: (warp * ROWS + r) * S + ky
#pragma unroll
          for (int u = 0; u < (ROWS - 1) * S + 3; ++u) {
            const int hy = warp * ROWS * S + u;
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              float xf[V];
              unpack16(*reinterpret_cast<const uint4*>(
                           halo + sw64(hy * IW + halo_pos<S>(lane * S + kx, IW), j)),
                       xf);
#pragma unroll
              for (int ky = 0; ky < 3; ++ky) {
                const int d = u - ky;
                if (d >= 0 && d % S == 0 && d / S < ROWS) {
#pragma unroll
                  for (int v = 0; v < V; ++v)
                    acc[d / S][v & 1] = fmaf(xf[v], wj[ky * 3 + kx][v], acc[d / S][v & 1]);
                }
              }
            }
          }
        }
      }
      if (g0 + GC >= C) {  // the tile's last pass: store, start anew
        const int oy0 = (ty0 + st / passes) * R::TH;
        if constexpr (MMA) {
          // D's column 0: rows lane / 4 (acc[m][0]) and lane / 4 + 8
          // (acc[m][2]) of tile m, in lanes lane % 4 == 0
          if (lane % 4 == 0) {
#pragma unroll
            for (int m = 0; m < TILES; ++m) {
              const int oy = oy0 + warp * ROWS + m / 2;
              const int ox = ox0 + (m % 2) * 16 + lane / 4;
              T* yp = y + ((size_t)b * Ho + oy) * Wo + ox;
              if (oy < Ho && ox < Wo) from_float(acc[m][0] + b0, yp);
              if (oy < Ho && ox + 8 < Wo) from_float(acc[m][2] + b0, yp + 8);
            }
          }
        } else {
          const int ox = ox0 + lane;
          if (ox < Wo) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const int oy = oy0 + warp * ROWS + r;
              if (oy < Ho)
                from_float(acc[r][0] + acc[r][1] + b0, y + ((size_t)b * Ho + oy) * Wo + ox);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < (MMA ? TILES : ROWS); ++r)
#pragma unroll
          for (int e = 0; e < (MMA ? 4 : 2); ++e) acc[r][e] = 0.f;
      }
      __syncthreads();  // this stage is free for stage st + 2
    }
    xas::cp_async_wait<0>();
  }
}

template <typename T, int S>
cudaError_t launch_thin_s(const void* x, const float* w, const float* bias,
                          void* y, int B, int Cin, int Cout, int H, int W,
                          cudaStream_t s) {
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (Cin == 1) {
    constexpr int IH = (THIN_E_TH - 1) * S + 3, IW = (THIN_E_TW - 1) * S + 3;
    const int tiles_x = (Wo + THIN_E_TW - 1) / THIN_E_TW;
    const int tiles_y = (Ho + THIN_E_TH - 1) / THIN_E_TH;
    constexpr int V = 16 / sizeof(T);
    const int groups = ((Cout + V - 1) / V + 31) / 32;
    const dim3 grid(tiles_x * tiles_y, groups, B);
    // the halo and a block's weights, (9, 32 vectors) fp32
    constexpr int SMEM = ((IH * IW + 3) / 4 * 4 + 9 * 32 * V) * 4;
    conv3x3_thin_kernel<T, S, true><<<grid, THIN_E_NT, SMEM, s>>>(
        xt, w, bias, yt, Cout, H, W, Ho, Wo, tiles_x);
    return cudaGetLastError();
  }
  using R = ThinReduce<S>;
  const int tiles_x = (Wo + THIN_R_TW - 1) / THIN_R_TW;
  const int tiles_y = (Ho + R::TH - 1) / R::TH;
  constexpr int GC = THIN_SLOT / sizeof(T);
  const int smem = R::smem(thin_cpad(Cin), (Cin + GC - 1) / GC, tiles_y);
  auto kernel = conv3x3_thin_kernel<T, S, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_x * ((tiles_y + THIN_R_TILES - 1) / THIN_R_TILES), 1, B);
  kernel<<<grid, THIN_R_NT, smem, s>>>(xt, w, bias, yt, Cin, H, W, Ho,
                                       Wo, tiles_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_thin(const void* x, const float* w, const float* bias,
                        void* y, int B, int Cin, int Cout, int H, int W,
                        int stride, cudaStream_t s) {
  return stride == 1
             ? launch_thin_s<T, 1>(x, w, bias, y, B, Cin, Cout, H, W, s)
             : launch_thin_s<T, 2>(x, w, bias, y, B, Cin, Cout, H, W, s);
}

// ------------------------------------------------------------ FMA kernel

constexpr int FMA_NT = 128;
constexpr int FMA_TW = 16;  // output columns of a tile, one per lane % 16
constexpr int FMA_KC = 8;   // input channels a stage: two planes of 4

template <int BN, int S>
struct FmaTile {
  static constexpr int RG = 64 / BN;  // row groups of 8 output rows
  static constexpr int TH = 8 * RG;
  static constexpr int IH = (TH - 1) * S + 3;
  static constexpr int IW = (FMA_TW - 1) * S + 3;
  static constexpr int HALO_BYTES = 2 * IH * IW * 16;
  static constexpr int W_BYTES = FMA_KC * 9 * BN * 4;
  static constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
  static int smem(int chunks) { return (chunks > 1 ? 2 : 1) * STAGE_BYTES; }
};

// An implicit GEMM on the FMA units: M = output pixels, N = Cout, K =
// (channel, tap). A block of 128 threads owns a TH x 16 tile of output
// pixels and BN output channels; a thread owns one column's 8 rows x 8
// channels (64 fp32 sums). Per stage of 8 input channels the block stages
// the tile's halo (fp32, two planes of 4 channels a pixel) and the
// (8, 9, BN) weights with 16-byte cp.async, the next stage in flight while
// this one is used; each tap then takes 8 16-byte reads of the halo and 8
// of the weights for 256 FMAs. w packed (Cin padded to 8, 9, Cout padded
// to BN) fp32.
// Three blocks an SM at stride 1; two at stride 2, whose longer halo
// addressing spilled at three.
template <typename T, int BN, int S>
__global__ void __launch_bounds__(FMA_NT, S == 1 ? 3 : 2)
conv3x3_fma_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y,
                   int Cin, int Cout, int cout_pad, int H, int W, int Ho,
                   int Wo, int tiles_x) {
  using F = FmaTile<BN, S>;
  constexpr int IH = F::IH, IW = F::IW;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int p = tid % FMA_TW;
  const int q = tid / FMA_TW;
  const int rg = q / (BN / 8);
  const int g = q % (BN / 8);
  const int oy0 = (blockIdx.x / tiles_x) * F::TH;
  const int ox0 = (blockIdx.x % tiles_x) * FMA_TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int iy0 = oy0 * S - 1;
  const int ix0 = ox0 * S - 1;
  const int chunks = (Cin + FMA_KC - 1) / FMA_KC;
  const T* xb = x + (size_t)b * H * W * Cin;
  // fp32 pixel rows 16-byte aligned: cp.async; else converted by the threads
  const bool vec_in = sizeof(T) == 4 && Cin % 4 == 0;

  auto load = [&](int k) {
    if (k < chunks) {
      uint8_t* st = smem + (k & 1) * F::STAGE_BYTES;
      float4* halo = reinterpret_cast<float4*>(st);  // [2][IH][IW]
      float* ws = reinterpret_cast<float*>(st + F::HALO_BYTES);
      const int c0 = k * FMA_KC;
      for (int i = tid; i < 2 * IH * IW; i += FMA_NT) {
        const int plane = i / (IH * IW);
        const int hy = (i / IW) % IH;
        const int hx = i % IW;
        const int gy = iy0 + hy;
        const int gx = ix0 + hx;
        const int ch = c0 + 4 * plane;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float4* dst = halo + (plane * IH + hy) * IW + halo_pos<S>(hx, IW);
        const T* src = xb + ((size_t)gy * W + gx) * Cin + ch;
        if (vec_in) {
          xas::cp_async16(xas::smem_u32(dst), in && ch < Cin ? src : x, in && ch < Cin);
        } else {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = in && ch + e < Cin ? to_float(src[e]) : 0.f;
          *dst = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      for (int i = tid; i < FMA_KC * 9 * BN / 4; i += FMA_NT) {
        const int row = i / (BN / 4);  // channel * 9 + tap
        const int part = i % (BN / 4);
        xas::cp_async16(xas::smem_u32(ws + row * BN + part * 4),
                        w + ((size_t)c0 * 9 + row) * cout_pad + co0 + part * 4, true);
      }
    }
    xas::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[r][n] = 0.f;

  load(0);
  for (int k = 0; k < chunks; ++k) {
    load(k + 1);
    xas::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = smem + (k & 1) * F::STAGE_BYTES;
    const float4* halo = reinterpret_cast<const float4*>(st);
    const float4* ws = reinterpret_cast<const float4*>(st + F::HALO_BYTES);
#pragma unroll 1
    for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap % 3;
        const int pos = halo_pos<S>(p * S + kx, IW);
        float4 a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[r] = halo[(plane * IH + (rg * 8 + r) * S + ky) * IW + pos];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (plane * 4 + e) * 9 + tap;
          const float4 w0 = ws[row * (BN / 4) + 2 * g];
          const float4 w1 = ws[row * (BN / 4) + 2 * g + 1];
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float av = e == 0 ? a[r].x : e == 1 ? a[r].y : e == 2 ? a[r].z : a[r].w;
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[r][n] = fmaf(av, wv[n], acc[r][n]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for chunk k + 2
  }
  xas::cp_async_wait<0>();

  const int ox = ox0 + p;
  const int co = co0 + g * 8;
  if (ox >= Wo || co >= Cout) return;
  float bv[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) bv[n] = bias && co + n < Cout ? __ldg(bias + co + n) : 0.f;
  constexpr int V = 16 / sizeof(T);
  const bool vec = co + 8 <= Cout && Cout % V == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int oy = oy0 + rg * 8 + r;
    if (oy >= Ho) break;
    float v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) v[n] = acc[r][n] + bv[n];
    T* yp = y + (((size_t)b * Ho + oy) * Wo + ox) * Cout + co;
    if (vec) {
#pragma unroll
      for (int n = 0; n < 8; n += V) store16(yp + n, v + n);
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (co + n < Cout) from_float(v[n], yp + n);
    }
  }
}

template <typename T, int BN, int S>
cudaError_t launch_fma(const void* x, const float* w, const float* bias,
                       void* y, int B, int Cin, int Cout, int H, int W,
                       cudaStream_t s) {
  using F = FmaTile<BN, S>;
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  const int tiles_x = (Wo + FMA_TW - 1) / FMA_TW;
  const int tiles_y = (Ho + F::TH - 1) / F::TH;
  const int cout_pad = (Cout + BN - 1) / BN * BN;
  const int smem = F::smem((Cin + FMA_KC - 1) / FMA_KC);
  auto kernel = conv3x3_fma_kernel<T, BN, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_x * tiles_y, cout_pad / BN, B);
  kernel<<<grid, FMA_NT, smem, s>>>(static_cast<const T*>(x), w, bias,
                                    static_cast<T*>(y), Cin, Cout, cout_pad,
                                    H, W, Ho, Wo, tiles_x);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_fma_bn(const void* x, const float* w, const float* bias,
                          void* y, int B, int Cin, int Cout, int H, int W,
                          int stride, cudaStream_t s) {
  return stride == 1
             ? launch_fma<T, BN, 1>(x, w, bias, y, B, Cin, Cout, H, W, s)
             : launch_fma<T, BN, 2>(x, w, bias, y, B, Cin, Cout, H, W, s);
}

template <typename T>
cudaError_t launch_fma_t(const void* x, const float* w, const float* bias,
                         void* y, int B, int Cin, int Cout, int H, int W,
                         int stride, int bn, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_fma_bn<T, 16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
    case 32: return launch_fma_bn<T, 32>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
    case 64: return launch_fma_bn<T, 64>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Tensor-core path: bf16 x, w packed (ceil(Cin / 32), 9, Cout, 32) with
// zeros past Cin, Cin % 16 == 0, Cout % 16 == 0; stride 1 or 2; bias fp32
// or null. Returns a CUDA error code, 0 on success.
int xas_conv3x3_tc(const void* x, const void* w, const float* bias, void* y,
                   int B, int Cin, int Cout, int H, int W, int stride,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin % 16 || Cout % 16 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (Cout % 128 == 0) {
    err = launch_tc_nb<128>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else if (Cout % 64 == 0) {
    err = launch_tc_nb<64>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else if (Cout % 32 == 0) {
    err = launch_tc_nb<32>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  } else {
    err = launch_tc_nb<16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  }
  return static_cast<int>(err);
}

// Thin kernel: Cin == 1 or Cout == 1; dtype 0 = fp32, 1 = bf16 (x and y);
// w (C, 9) fp32, C the side that is not 1 (rounded to x's type in the
// kernel); bias fp32 or null; stride 1 or 2.
int xas_conv3x3_thin(int dtype, const void* x, const float* w,
                     const float* bias, void* y, int B, int Cin, int Cout,
                     int H, int W, int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((Cin != 1 && Cout != 1) || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 ? launch_thin<float>(x, w, bias, y, B, Cin, Cout, H, W, stride, s)
                 : launch_thin<bf16>(x, w, bias, y, B, Cin, Cout, H, W, stride, s);
  return static_cast<int>(err);
}

// FMA kernel: everything else; dtype 0 = fp32, 1 = bf16 (x and y); w
// packed (Cin padded to 8, 9, Cout padded to bn) fp32; bn 16, 32 or 64;
// bias fp32 or null; stride 1 or 2.
int xas_conv3x3_fma(int dtype, const void* x, const float* w,
                    const float* bias, void* y, int B, int Cin, int Cout,
                    int H, int W, int stride, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 ? launch_fma_t<float>(x, w, bias, y, B, Cin, Cout, H, W, stride, bn, s)
                 : launch_fma_t<bf16>(x, w, bias, y, B, Cin, Cout, H, W, stride, bn, s);
  return static_cast<int>(err);
}

}  // extern "C"
