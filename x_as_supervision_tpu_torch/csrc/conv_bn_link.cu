// Fused BN-apply -> ReLU -> 3x3 conv -> output-stats link of a ResNet
// bottleneck.
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/conv_bn_pallas.py:_kernel
// (called through fused_bn_relu_conv / fused_link).
//
// Computes, with x (B, H, W, Cin) channels-last, w (3, 3, Cin, Cout) and
// per-channel fp32 scale/shift (Cin):
//     a     = relu(x * scale + shift), in fp32, rounded to x's type
//     y     = conv3x3_SAME(a, w), accumulated in fp32, stored in x's type
//     stats = (sum over pixels and batch of y, of y^2), (2, Cout) fp32,
//             taken from the fp32 accumulator before y is rounded.
// The SAME halo is zero AFTER the activation (not relu(shift)), as in the TPU
// kernel, which stages the activated image into a zero-padded scratch.
//
// Bound on an H100: operations. At the serving shape (B=32, 16x16x256 -> 256)
// a link is an implicit GEMM of M = B*H*W = 8192 pixels, N = Cout = 256,
// K = 9*Cin = 2304: 2*M*N*K = 9.66 GFLOP, >= 9.8 us at the 989 TFLOP/s bf16
// dense peak, against about 9.6 MB of traffic (x and y at 4.2 MB each in bf16,
// w 1.2 MB), >= 2.9 us at 3.35 TB/s. The 8x8x512 links have the same count.
//
// Design, a simple tile that is right first:
//   * A block owns a BM x BN = 64 x 64 tile of (pixels x output channels) and
//     walks K as 9 taps x Cin/32 chunks. For each step it stages the shifted
//     input tile (64 pixels x 32 channels) into shared memory, applying the
//     BN affine and ReLU in fp32 and rounding to the working type on the way
//     (out-of-image taps and pixels past the end stage as zero), and stages
//     the 32 x 64 weight tile. The next step's global loads are issued into
//     registers before the current step's products, so they overlap.
//   * bf16: four warps, each a 32 x 32 sub-tile of 2 x 2 WMMA 16x16x16
//     fragments with fp32 accumulators (mma.sync on the tensor cores).
//     fp32: plain FMA, each thread an 8 x 4 sub-tile, so the fp32 path keeps
//     full fp32 products as the TPU kernel's fp32 path does.
//   * Epilogue: the accumulators go through shared memory; the block writes y
//     and one (2, BN) partial of the stats per pixel tile. A second small
//     kernel sums the partials over the pixel tiles in a fixed order, so the
//     stats are deterministic.
// Limits checked by the wrapper (ops/conv_bn.py): Cin % 32 == 0,
// Cout % 64 == 0. wgmma and TMA are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 128;
constexpr int CS_LD = BN + 4;  // fp32 epilogue tile row stride

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int VEC = 4;        // elements per 16-byte vector
  static constexpr int A_LD = BK + 1;  // fp32 A tile row stride
  static constexpr int B_LD = BN + 4;
  __device__ static void to_float(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 from_float(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int A_LD = BK + 8;  // WMMA needs a multiple of 8 elements
  static constexpr int B_LD = BN + 8;
  __device__ static void to_float(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 from_float(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr int kSmemBytes = BM * CS_LD * 4;  // the largest of the unioned tiles
static_assert(BM * Traits<float>::A_LD * 4 + BK * Traits<float>::B_LD * 4 <= kSmemBytes, "fp32 tiles");
static_assert(BM * Traits<__nv_bfloat16>::A_LD * 2 + BK * Traits<__nv_bfloat16>::B_LD * 2 <= kSmemBytes, "bf16 tiles");

template <typename T>
__global__ void __launch_bounds__(NT)
link_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            T* __restrict__ y, float* __restrict__ partial, int B, int H,
            int W, int Cin, int Cout) {
  using Tr = Traits<T>;
  constexpr int VEC = Tr::VEC;
  constexpr int A_VECS = BM * BK / VEC / NT;  // A vectors per thread
  constexpr int B_VECS = BK * BN / VEC / NT;
  constexpr int A_ROW_VECS = BK / VEC;
  constexpr int B_ROW_VECS = BN / VEC;

  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* As = reinterpret_cast<T*>(smem);                              // [BM][A_LD]
  T* Bs = reinterpret_cast<T*>(smem + BM * Tr::A_LD * sizeof(T));  // [BK][B_LD]
  float* Cs = reinterpret_cast<float*>(smem);                      // [BM][CS_LD]

  const int tid = threadIdx.x;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = Cin / BK;
  const int steps = 9 * chunks;

  // The pixel rows this thread stages are the same at every step.
  int a_b[A_VECS], a_h[A_VECS], a_w[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int p = m0 + (tid + i * NT) / A_ROW_VECS;
    a_b[i] = p < M ? p / (H * W) : -1;
    a_h[i] = (p / W) % H;
    a_w[i] = p % W;
  }

  uint4 a_reg[A_VECS], b_reg[B_VECS];
  bool a_ok[A_VECS];

  auto load = [&](int step) {
    const int tap = step / chunks;
    const int c0 = (step % chunks) * BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int cv = (tid + i * NT) % A_ROW_VECS;
      const int hh = a_h[i] + dy;
      const int ww = a_w[i] + dx;
      a_ok[i] = a_b[i] >= 0 && hh >= 0 && hh < H && ww >= 0 && ww < W;
      if (a_ok[i]) {
        const size_t off = (((size_t)a_b[i] * H + hh) * W + ww) * Cin + c0 + cv * VEC;
        a_reg[i] = __ldg(reinterpret_cast<const uint4*>(x + off));
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / B_ROW_VECS;
      const int cv = v % B_ROW_VECS;
      const size_t off = ((size_t)tap * Cin + c0 + r) * Cout + n0 + cv * VEC;
      b_reg[i] = __ldg(reinterpret_cast<const uint4*>(w + off));
    }
  };

  auto stage = [&](int step) {
    const int c0 = (step % chunks) * BK;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / A_ROW_VECS;
      const int cv = v % A_ROW_VECS;
      float f[VEC];
      if (a_ok[i]) {
        Tr::to_float(a_reg[i], f);
        const int c = c0 + cv * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = fmaxf(fmaf(f[j], __ldg(scale + c + j), __ldg(shift + c + j)), 0.f);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = 0.f;
      }
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint4*>(As + r * Tr::A_LD + cv * VEC) = Tr::from_float(f);
      } else {
        // A_LD is odd for fp32 (conflict-free column reads), so store scalars.
#pragma unroll
        for (int j = 0; j < VEC; ++j) As[r * Tr::A_LD + cv * VEC + j] = f[j];
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / B_ROW_VECS;
      const int cv = v % B_ROW_VECS;
      *reinterpret_cast<uint4*>(Bs + r * Tr::B_LD + cv * VEC) = b_reg[i];
    }
  };

  if constexpr (VEC == 8) {
    using namespace nvcuda;
    const int warp = tid / 32;
    const int wm = warp / 2;  // 32-row half of the tile
    const int wn = warp % 2;  // 32-column half
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    load(0);
    for (int step = 0; step < steps; ++step) {
      stage(step);
      __syncthreads();
      if (step + 1 < steps) load(step + 1);
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * Tr::A_LD + ks, Tr::A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + ks * Tr::B_LD + wn * 32 + j * 16, Tr::B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * CS_LD + wn * 32 + j * 16,
                                acc[i][j], CS_LD, wmma::mem_row_major);
  } else {
    const int tx = tid % 16;  // 4 output channels each
    const int ty = tid / 16;  // 8 pixels each
    float acc[8][4] = {};
    load(0);
    for (int step = 0; step < steps; ++step) {
      stage(step);
      __syncthreads();
      if (step + 1 < steps) load(step + 1);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + k * Tr::B_LD + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = As[(ty * 8 + i) * Tr::A_LD + k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * CS_LD + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();

  // y, one 16-byte vector per store.
  for (int v = tid; v < BM * BN / VEC; v += NT) {
    const int r = v / B_ROW_VECS;
    const int cv = v % B_ROW_VECS;
    const int p = m0 + r;
    if (p < M) {
      *reinterpret_cast<uint4*>(y + (size_t)p * Cout + n0 + cv * VEC) =
          Tr::from_float(Cs + r * CS_LD + cv * VEC);
    }
  }
  // Stats partials of this pixel tile: threads [0, BN) sum y, [BN, 2BN) y^2.
  if (tid < 2 * BN) {
    const int c = tid % BN;
    const bool sq = tid >= BN;
    const int rows = min(BM, M - m0);
    float s = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = Cs[r * CS_LD + c];
      s = sq ? fmaf(v, v, s) : s + v;
    }
    partial[((size_t)blockIdx.x * 2 + sq) * Cout + n0 + c] = s;
  }
}

// stats[i] = sum over pixel tiles g of partial[g][i], i over (2, Cout).
__global__ void stats_kernel(const float* __restrict__ partial, int tiles,
                             int n, float* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < tiles; ++g) s += partial[(size_t)g * n + i];
  stats[i] = s;
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scratch rows of `partial` the caller allocates: (tiles, 2, Cout) fp32.
int xas_conv_bn_link_tiles(int B, int H, int W) { return (B * H * W + BM - 1) / BM; }

// dtype: 0 = fp32, 1 = bf16 (x, w and y). Returns cudaGetLastError().
int xas_conv_bn_link(int dtype, const void* x, const void* w,
                     const float* scale, const float* shift, void* y,
                     float* partial, float* stats, int B, int H, int W,
                     int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = xas_conv_bn_link_tiles(B, H, W);
  const dim3 grid(tiles, Cout / BN);
  if (dtype == 0) {
    link_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), scale,
        shift, static_cast<float*>(y), partial, B, H, W, Cin, Cout);
  } else {
    link_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), scale, shift,
        static_cast<__nv_bfloat16*>(y), partial, B, H, W, Cin, Cout);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 2 * Cout;
  stats_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, tiles, n, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
