// Fused BN-apply -> ReLU -> 3x3 conv -> output-stats link of a ResNet
// bottleneck.
//
// Replaces the TPU kernel x_as_supervision_tpu/ops/conv_bn_pallas.py:_kernel
// (called through fused_bn_relu_conv / fused_link).
//
// Computes, with x (B, H, W, Cin) channels-last and per-channel fp32
// scale/shift (Cin):
//     a     = relu(x * scale + shift), in fp32, rounded to x's type
//     y     = conv3x3_SAME(a, w), accumulated in fp32, stored in x's type
//     stats = (sum over pixels and batch of y, of y^2), (2, Cout) fp32,
//             taken from the fp32 accumulator before y is rounded.
// The SAME halo is zero AFTER the activation (not relu(shift)), as in the TPU
// kernel, which stages the activated image into a zero-padded scratch.
//
// Bound on an H100: operations. A link is an implicit GEMM of M = B*H*W
// pixels, N = Cout, K = 9*Cin. At the training shape (B = 128, 16x16x256 ->
// 256) that is 38.7 GFLOP, >= 39 us at the 989 TFLOP/s bf16 dense peak,
// against 17.9 MB of traffic (>= 5.3 us at 3.35 TB/s); 8x8x512 has the same
// count. Only wgmma reaches that rate, and it needs tiles large enough to
// do about 300 operations per byte staged.
//
// bf16 design (wgmma): a direct convolution on shifted views of one staged,
// activated halo.
//   * A block owns BM pixels x BN output channels, (BM, BN) one of
//     128x256, 128x128, 64x128, 128x64, 64x64, chosen by the wrapper from the
//     shape so that the grid fills the card. Its pixels are G regions of
//     RH x RW pixels (an 8x16 or 16x8 patch of one image, or G whole 8x8
//     images), cut into 8x8 m64 tiles; each of its NWG warpgroups owns one
//     and multiplies it by the BN-wide weight tile with wgmma.mma_async
//     m64nBNk16, bf16 in, fp32 accumulators in registers (the widest N
//     reads the least shared memory per product).
//   * The K loop is 64-channel chunks x 9 taps. For each chunk the block
//     stages the regions' raw x with a one-pixel halo, (RH+2) x (RW+2) slots
//     of 128 bytes, by 16-byte cp.async (zero-fill outside the image), then
//     rewrites it in place as relu(x * scale + shift) in fp32 rounded to
//     bf16, with the out-of-image slots (and channels past Cin) set to zero
//     after the activation. The 9 taps are then 9 wgmma descriptors into
//     that one buffer: an m64 tile's 8 pixel rows are 8 groups of 8
//     contiguous slots, RW+2 slots apart, and a tap moves the start by
//     ky rows and kx slots. x crosses L2 about once per chunk instead of
//     once per tap, and each pixel is activated once, not nine times.
//   * The halo is double-buffered (the next chunk's loads while this chunk's
//     taps multiply), the weight tiles (BN rows of 64 K for one tap, packed
//     by the wrapper as (tap, Cout, Cin), K-major, the layout wgmma reads
//     untransposed) ride a ring of 4 stages, 2 steps ahead. All staged tiles
//     use the 128-byte swizzle. One wgmma group stays in flight.
//   * Epilogue: (sum y, sum y^2) of the fp32 accumulators over the pixels
//     inside the image, reduced across the warp with shuffles and across
//     warps through shared memory in a fixed order into one (2, BN) partial
//     per block; y rounded to bf16, staged in shared memory and stored
//     channels-last with 16-byte stores. A second small kernel sums the
//     partials over the blocks in a fixed order, so the stats are
//     deterministic.
// fp32 (the correctness checks only): plain FMA on 64 x 64 tiles, K = 32 per
// step, each thread an 8 x 4 sub-tile, as before; weights packed
// (tap, Cin, Cout).
// Limits checked by the wrapper (ops/conv_bn.py): Cin % 32 == 0 (a chunk
// past Cin is zero), Cout % 64 == 0 and divisible by BN, 16-byte aligned x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16, wgmma

constexpr int KC = 64;            // input channels per chunk: one 128-byte row
constexpr int ROW = KC * 2;       // bytes of a staged pixel (one swizzle row)
constexpr int AHEAD = 2;          // K steps whose weight tiles are in flight
constexpr int B_STAGES = AHEAD + 2;
constexpr int HALO_AT = 6;        // chunk c's halo lands with step 9c - HALO_AT
constexpr int SLOTS_PER_M64 = 100;  // an 8x8 tile's 10x10 halo: the most per m64

__device__ __forceinline__ void bf16x8_to_float(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 float_to_bf16x8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A block: NWG warpgroups, each one m64 tile of 8 x 8 pixels by BN output
// channels.
template <int NWG, int BN>
struct Tile {
  static constexpr int BM = 64 * NWG;
  static constexpr int NT = 128 * NWG;
  static constexpr int HALO_BYTES = (NWG * SLOTS_PER_M64 * ROW + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = BN * ROW;
  static constexpr int B_OFF = 2 * HALO_BYTES;
  static constexpr int Y_LD = BN + 8;  // bf16 staging row, conflict-free
  static constexpr int RED_BYTES = NWG * 4 * 2 * BN * 4;
  static constexpr int SMEM = B_OFF + B_STAGES * B_BYTES + 1024;  // +1024: alignment
  static_assert(HALO_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "1024-byte tiles");
  static_assert(RED_BYTES + BM * Y_LD * 2 <= B_OFF + B_STAGES * B_BYTES, "epilogue fits");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The block's pixels: G regions, each RH x RW pixels of one image (region g
// is image b0 + g), cut into 8 x 8 m64 tiles; each region is staged with
// its one-pixel halo, (RH + 2) x (RW + 2) slots of 64 channels.
struct Geometry {
  int B, H, W, RH, RW, G;
  int b0, h0, w0;  // this block's first image and its regions' corner
  __device__ int pitch() const { return RW + 2; }
  __device__ int region_slots() const { return (RH + 2) * (RW + 2); }
  __device__ int slots() const { return G * region_slots(); }
  __device__ int tiles_per_region() const { return (RH / 8) * (RW / 8); }
  // first halo slot of m64 tile m, and its image pixel (row 0 of the tile)
  __device__ void tile(int m, int& slot0, int& b, int& h, int& w) const {
    const int g = m / tiles_per_region();
    const int r = m % tiles_per_region();
    const int ti = r / (RW / 8);
    const int tj = r % (RW / 8);
    slot0 = g * region_slots() + 8 * ti * pitch() + 8 * tj;
    b = b0 + g;
    h = h0 + 8 * ti;
    w = w0 + 8 * tj;
  }
};

template <int NWG, int BN>
__global__ void __launch_bounds__(128 * NWG, 1)
link_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, bf16* __restrict__ y,
                  float* __restrict__ partial, int B, int H, int W, int Cin,
                  int Cout, int RH, int RW, int G) {
  using T = Tile<NWG, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  Geometry geo{B, H, W, RH, RW, G, 0, 0, 0};
  {
    const int tiles_w = (W + RW - 1) / RW;
    const int tiles_h = (H + RH - 1) / RH;
    const int bx = blockIdx.x;
    geo.w0 = (bx % tiles_w) * RW;
    geo.h0 = ((bx / tiles_w) % tiles_h) * RH;
    geo.b0 = (bx / (tiles_w * tiles_h)) * G;
  }
  const int n0 = blockIdx.y * BN;
  const int chunks = (Cin + KC - 1) / KC;
  const int steps = 9 * chunks;
  const int slots = geo.slots();
  const int jc = tid % 8;  // the 16-byte column (channels 8 jc ..) this thread stages

  // This thread's halo pieces are v = tid + k * NT (slot v / 8, column jc).
  // Slot q of region g holds pixel (b0 + g, h0 - 1 + q / pitch, w0 - 1 +
  // q % pitch); -1 where that pixel is outside the image.
  auto halo_src = [&](int q, int c) -> long long {
    const int g = q / geo.region_slots();
    const int r = q % geo.region_slots();
    const int b = geo.b0 + g;
    const int h = geo.h0 - 1 + r / geo.pitch();
    const int ww = geo.w0 - 1 + r % geo.pitch();
    if (b >= B || h < 0 || h >= H || ww < 0 || ww >= W || c >= Cin) return -1;
    return (((long long)b * H + h) * W + ww) * Cin + c;
  };

  auto load_halo = [&](int c) {
    uint8_t* halo = smem + (c & 1) * T::HALO_BYTES;
    const int cc = c * KC + jc * 8;
    for (int q = tid / 8; q < slots; q += T::NT / 8) {
      const long long off = halo_src(q, cc);
      xas::cp_async16(xas::smem_u32(halo + xas::sw128(q, jc)), off >= 0 ? x + off : x, off >= 0);
    }
  };

  // relu(x * scale + shift) in place, zero outside the image (after the
  // activation) and past Cin; each thread rewrites the pieces it copied.
  auto activate_halo = [&](int c) {
    uint8_t* halo = smem + (c & 1) * T::HALO_BYTES;
    const int cc = c * KC + jc * 8;
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const bool ok = cc < Cin;
      const float4 a = ok ? __ldg(reinterpret_cast<const float4*>(scale + cc + j)) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = ok ? __ldg(reinterpret_cast<const float4*>(shift + cc + j)) : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[j] = a.x; sc[j + 1] = a.y; sc[j + 2] = a.z; sc[j + 3] = a.w;
      sh[j] = b.x; sh[j + 1] = b.y; sh[j + 2] = b.z; sh[j + 3] = b.w;
    }
    for (int q = tid / 8; q < slots; q += T::NT / 8) {
      uint4* piece = reinterpret_cast<uint4*>(halo + xas::sw128(q, jc));
      float f[8];
      if (halo_src(q, cc) >= 0) {
        bf16x8_to_float(*piece, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = fmaxf(fmaf(f[j], sc[j], sh[j]), 0.f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
      *piece = float_to_bf16x8(f);
    }
  };

  auto load_b = [&](int t) {
    uint8_t* Bs = smem + T::B_OFF + (t % B_STAGES) * T::B_BYTES;
    const int tap = t % 9;
    const int c0 = (t / 9) * KC;
    for (int v = tid; v < BN * 8; v += T::NT) {
      const int n = v / 8;
      const int j = v % 8;
      const bool ok = c0 + j * 8 < Cin;
      const bf16* src = ok ? w + ((size_t)tap * Cout + n0 + n) * Cin + c0 + j * 8 : w;
      xas::cp_async16(xas::smem_u32(Bs + xas::sw128(n, j)), src, ok);
    }
  };

  // Commit group t holds step t's weight tile and, for t = 9c - HALO_AT
  // (t = 0 for c = 0), chunk c's halo: issued once chunk c - 2's products,
  // which read the same halo buffer, are done.
  auto issue = [&](int t) {
    if (t < steps) {
      load_b(t);
      if (t == 0) load_halo(0);
      if ((t + HALO_AT) % 9 == 0 && (t + HALO_AT) / 9 < chunks) load_halo((t + HALO_AT) / 9);
    }
    xas::cp_async_commit();  // possibly empty: keeps the group count uniform
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // This warpgroup's m64 tile: its halo slot at tap (0, 0) and its first
  // pixel. A tap (ky, kx) starts ky rows and kx slots further, and the
  // tile's eight pixel rows are eight groups of eight contiguous slots,
  // pitch slots apart.
  int slot0, tb, th, tw;
  geo.tile(wg, slot0, tb, th, tw);
  const uint32_t group_bytes = geo.pitch() * ROW;

#pragma unroll
  for (int t = 0; t < AHEAD; ++t) issue(t);
  for (int s = 0; s < steps; ++s) {
    const int tap = s % 9;
    const int c = s / 9;
    xas::cp_async_wait<AHEAD - 1>();  // this thread's copies of group s landed
    if (tap == 0) activate_halo(c);
    xas::fence_proxy_async();
    __syncthreads();  // every copy and activation of step s is visible
    issue(s + AHEAD);  // B slot of step s - 2, whose products are done
    const uint32_t halo = xas::smem_u32(smem + (c & 1) * T::HALO_BYTES);
    const uint64_t db = xas::desc_sw128(
        xas::smem_u32(smem + T::B_OFF + (s % B_STAGES) * T::B_BYTES));
    const int shift_slots = (tap / 3) * geo.pitch() + tap % 3;
    const uint64_t da = xas::desc_sw128(halo + (slot0 + shift_slots) * ROW, group_bytes);
    xas::wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) xas::wgmma_bf16<BN>(acc, da + 2 * k, db + 2 * k);
    xas::wgmma_commit();
    xas::wgmma_wait<1>();  // step s - 1's products are done
  }
  xas::wgmma_wait<0>();
  xas::fence_regs(acc);
  xas::cp_async_wait<0>();
  __syncthreads();  // the halo and weight buffers are free for the epilogue

  // Accumulator layout (m64nBN): warp q of the group holds rows 16q + g and
  // 16q + g + 8 (g = lane / 4); for each 8-column block j, acc[4j + e] is
  // (row g, column 8j + 2*(lane % 4) + e) and acc[4j + 2 + e] the same
  // column of row g + 8. Row r of an m64 tile is pixel (r / 8, r % 8) of its
  // 8 x 8 block; rows outside the image count in no sum and are not stored.
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  float* red = reinterpret_cast<float*>(smem);  // [warps][2][BN]
  bf16* ys = reinterpret_cast<bf16*>(smem + T::RED_BYTES);  // [BM][Y_LD]
  const int r0 = (warp % 4) * 16 + g;  // rows r0, r0 + 8: pixel rows r0/8, r0/8 + 1
  const bool in_bw = tb < B && tw + r0 % 8 < W;
  const bool ok0 = in_bw && th + r0 / 8 < H;
  const bool ok1 = in_bw && th + r0 / 8 + 1 < H;
  const int row = wg * 64 + r0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = ok0 ? acc[4 * j + e] : 0.f;
      const float v1 = ok1 ? acc[4 * j + 2 + e] : 0.f;
      float sy = v0 + v1;
      float sq = fmaf(v0, v0, v1 * v1);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sy += __shfl_xor_sync(0xffffffffu, sy, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (g == 0) {
        red[(warp * 2 + 0) * BN + 8 * j + 2 * tq + e] = sy;
        red[(warp * 2 + 1) * BN + 8 * j + 2 * tq + e] = sq;
      }
    }
    const int col = 8 * j + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(ys + row * T::Y_LD + col) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(ys + (row + 8) * T::Y_LD + col) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += T::NT) {
    const int sq = i / BN;
    const int c = i % BN;
    float s = 0.f;
    for (int q = 0; q < NWG * 4; ++q) s += red[(q * 2 + sq) * BN + c];
    partial[((size_t)blockIdx.x * 2 + sq) * Cout + n0 + c] = s;
  }
  for (int v = tid; v < T::BM * BN / 8; v += T::NT) {
    const int row = v / (BN / 8);
    const int cv = v % (BN / 8);
    int sl, b, h, ww;
    geo.tile(row / 64, sl, b, h, ww);
    h += (row % 64) / 8;
    ww += row % 8;
    if (b < B && h < H && ww < W) {
      *reinterpret_cast<uint4*>(y + (((size_t)b * H + h) * W + ww) * Cout + n0 + cv * 8) =
          *reinterpret_cast<const uint4*>(ys + row * T::Y_LD + cv * 8);
    }
  }
}

// ------------------------------------------------------------ fp32, FMA

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 32;
constexpr int FNT = 128;
constexpr int A_LD = FBK + 1;  // odd: conflict-free column reads
constexpr int B_LD = FBN + 4;
constexpr int CS_LD = FBN + 4;
constexpr int kFmaSmem = FBM * CS_LD * 4;  // the largest of the unioned tiles
static_assert(FBM * A_LD * 4 + FBK * B_LD * 4 <= kFmaSmem, "fp32 tiles");

__global__ void __launch_bounds__(FNT)
link_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ shift, float* __restrict__ y,
                float* __restrict__ partial, int B, int H, int W, int Cin,
                int Cout) {
  constexpr int A_VECS = FBM * FBK / 4 / FNT;  // 16-byte vectors per thread
  constexpr int B_VECS = FBK * FBN / 4 / FNT;
  constexpr int A_ROW_VECS = FBK / 4;
  constexpr int B_ROW_VECS = FBN / 4;

  __shared__ __align__(128) float smem[kFmaSmem / 4];
  float* As = smem;                // [FBM][A_LD]
  float* Bs = smem + FBM * A_LD;   // [FBK][B_LD]
  float* Cs = smem;                // [FBM][CS_LD]

  const int tid = threadIdx.x;
  const int M = B * H * W;
  const int m0 = blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int chunks = Cin / FBK;
  const int steps = 9 * chunks;

  int a_b[A_VECS], a_h[A_VECS], a_w[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int p = m0 + (tid + i * FNT) / A_ROW_VECS;
    a_b[i] = p < M ? p / (H * W) : -1;
    a_h[i] = (p / W) % H;
    a_w[i] = p % W;
  }
  float4 a_reg[A_VECS], b_reg[B_VECS];
  bool a_ok[A_VECS];

  auto load = [&](int step) {
    const int tap = step / chunks;
    const int c0 = (step % chunks) * FBK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int cv = (tid + i * FNT) % A_ROW_VECS;
      const int hh = a_h[i] + dy;
      const int ww = a_w[i] + dx;
      a_ok[i] = a_b[i] >= 0 && hh >= 0 && hh < H && ww >= 0 && ww < W;
      if (a_ok[i]) {
        const size_t off = (((size_t)a_b[i] * H + hh) * W + ww) * Cin + c0 + cv * 4;
        a_reg[i] = __ldg(reinterpret_cast<const float4*>(x + off));
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * FNT;
      const size_t off = ((size_t)tap * Cin + c0 + v / B_ROW_VECS) * Cout + n0 + (v % B_ROW_VECS) * 4;
      b_reg[i] = __ldg(reinterpret_cast<const float4*>(w + off));
    }
  };

  auto stage = [&](int step) {
    const int c0 = (step % chunks) * FBK;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * FNT;
      const int r = v / A_ROW_VECS;
      const int c = c0 + (v % A_ROW_VECS) * 4;
      float f[4] = {a_reg[i].x, a_reg[i].y, a_reg[i].z, a_reg[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = a_ok[i] ? fmaxf(fmaf(f[j], __ldg(scale + c + j), __ldg(shift + c + j)), 0.f) : 0.f;
        As[r * A_LD + (v % A_ROW_VECS) * 4 + j] = f[j];
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * FNT;
      *reinterpret_cast<float4*>(Bs + (v / B_ROW_VECS) * B_LD + (v % B_ROW_VECS) * 4) = b_reg[i];
    }
  };

  const int tx = tid % 16;  // 4 output channels each
  const int ty = tid / 16;  // 8 pixels each
  float acc[8][4] = {};
  load(0);
  for (int step = 0; step < steps; ++step) {
    stage(step);
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
#pragma unroll 8
    for (int k = 0; k < FBK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * B_LD + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(ty * 8 + i) * A_LD + k];
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
  __syncthreads();

  for (int v = tid; v < FBM * FBN / 4; v += FNT) {
    const int r = v / B_ROW_VECS;
    const int cv = v % B_ROW_VECS;
    if (m0 + r < M) {
      *reinterpret_cast<float4*>(y + (size_t)(m0 + r) * Cout + n0 + cv * 4) =
          *reinterpret_cast<const float4*>(Cs + r * CS_LD + cv * 4);
    }
  }
  if (tid < 2 * FBN) {  // threads [0, FBN) sum y, [FBN, 2 FBN) y^2
    const int c = tid % FBN;
    const bool sq = tid >= FBN;
    const int rows = min(FBM, M - m0);
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

template <int NWG, int BN>
cudaError_t launch_wgmma(const void* x, const void* w, const float* scale,
                         const float* shift, void* y, float* partial, int B,
                         int H, int W, int Cin, int Cout, int RH, int RW,
                         int G, int blocks, cudaStream_t s) {
  using T = Tile<NWG, BN>;
  if (G * RH * RW != T::BM || RH % 8 || RW % 8 ||
      G * (RH + 2) * (RW + 2) > NWG * SLOTS_PER_M64 || Cout % BN)
    return cudaErrorInvalidValue;
  auto kernel = link_wgmma_kernel<NWG, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, Cout / BN);
  kernel<<<grid, T::NT, T::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, shift,
      static_cast<bf16*>(y), partial, B, H, W, Cin, Cout, RH, RW, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype 0 = fp32: the FMA kernel, w packed (9, Cin, Cout), one block per
// 64 pixels (rh = rw = g = 0). dtype 1 = bf16: the wgmma kernel with tile
// (bm, bn) one of those instantiated below, w packed (9, Cout, Cin), and
// each block g regions of rh x rw pixels (g * rh * rw == bm; rh, rw
// multiples of 8; regions of one image each, image-major). The caller
// allocates `partial` as (blocks, 2, Cout) fp32, blocks = the first grid
// dimension. Returns a CUDA error code, 0 on success.
int xas_conv_bn_link(int dtype, int bm, int bn, int rh, int rw, int g,
                     const void* x, const void* w, const float* scale,
                     const float* shift, void* y, float* partial,
                     float* stats, int B, int H, int W, int Cin, int Cout,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  int blocks = 0;
  if (dtype == 0 && bm == FBM && bn == FBN) {
    blocks = (B * H * W + FBM - 1) / FBM;
    link_fma_kernel<<<dim3(blocks, Cout / FBN), FNT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), scale,
        shift, static_cast<float*>(y), partial, B, H, W, Cin, Cout);
    err = cudaGetLastError();
  } else if (dtype == 1 && g > 0 && rh > 0 && rw > 0) {
    blocks = ((B + g - 1) / g) * ((H + rh - 1) / rh) * ((W + rw - 1) / rw);
#define XAS_TILE(NWG_, BN_)                                                    \
  if (bm == 64 * NWG_ && bn == BN_)                                            \
    err = launch_wgmma<NWG_, BN_>(x, w, scale, shift, y, partial, B, H, W, Cin, \
                                  Cout, rh, rw, g, blocks, s);
    XAS_TILE(2, 256)
    XAS_TILE(2, 128)
    XAS_TILE(1, 128)
    XAS_TILE(2, 64)
    XAS_TILE(1, 64)
#undef XAS_TILE
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 2 * Cout;
  stats_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, blocks, n, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
