// SAME 3x3x3 convolution + bias (+ReLU) on a batch of channels-last f32
// volumes.
//
// Replaces: 3deecelltracker_tpu/ops/pallas_conv.py::conv3x3x3_fused, which
// computes relu(conv_same(x, w) + b) for x (z, y, x, c_in), w DHWIO
// (3, 3, 3, c_in, c_out), b (c_out,), with f32 accumulation.  It is the math
// of every 3x3x3 layer of the StarDist backbone (batch 1) and, without the
// ReLU, of every 3x3x3 layer of the legacy U-Net, whose tile batch (e.g. 16
// tiles of (160, 160, 16)) is one launch per layer: the batch index is folded
// into grid.z.
//
// What bounds it on an H100: arithmetic.  At the bench geometry the
// backbone's 3x3x3 layers are ~300 GFLOP per volume against ~0.1 GB of
// activations, so the kernel runs on the f32 CUDA-core FMA pipes (67 TFLOP/s
// peak at 700 W); TF32/bf16 wgmma would change the numerics and is later work.
//
// Design (simple, right first): a block of 16x16 threads owns a 16x16 (y, x)
// output tile at one z and a chunk of COT=32 output channels.  For each z-tap
// and each chunk of CK=8 input channels it stages the 18x18 input halo tile
// (channel-planar, so neighbouring threads read neighbouring banks) and the
// 9 x CK x COT weight slab in shared memory.  Each thread keeps its pixel's 32
// accumulators in registers; one weight row is a broadcast float4 read that
// feeds four FMAs.  Bias + ReLU are applied in the epilogue.  Out-of-volume
// taps and ragged channel chunks read zeros, which is SAME padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BY = 16;
constexpr int BX = 16;
constexpr int HY = BY + 2;
constexpr int HX = BX + 2;
constexpr int CK = 8;
constexpr int COT = 32;
constexpr int NT = BY * BX;

__global__ void __launch_bounds__(NT)
conv3x3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y,
                 int Z, int Y, int X, int Cin, int Cout, int relu) {
  // grid.z enumerates (batch, z, c_out chunk); step to this block's volume
  const int n_co = (Cout + COT - 1) / COT;
  const int bz = blockIdx.z / (Z * n_co);
  x += static_cast<int64_t>(bz) * Z * Y * X * Cin;
  y += static_cast<int64_t>(bz) * Z * Y * X * Cout;
  __shared__ float in_s[CK * HY * HX];
  __shared__ __align__(16) float w_s[9 * CK * COT];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * BX + tx;
  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int zc = blockIdx.z % (Z * n_co);
  const int z = zc / n_co;
  const int co0 = (zc % n_co) * COT;

  float acc[COT];
#pragma unroll
  for (int i = 0; i < COT; ++i) acc[i] = 0.f;

  for (int dz = 0; dz < 3; ++dz) {
    const int zi = z + dz - 1;
    if (zi < 0 || zi >= Z) continue;  // uniform across the block
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      // halo tile: global reads run channel-fastest (contiguous in NDHWC)
      for (int i = tid; i < CK * HY * HX; i += NT) {
        const int ci = i % CK;
        const int p = i / CK;
        const int hx = p % HX;
        const int hy = p / HX;
        const int gy = y0 + hy - 1;
        const int gx = x0 + hx - 1;
        const int c = c0 + ci;
        float v = 0.f;
        if (gy >= 0 && gy < Y && gx >= 0 && gx < X && c < Cin)
          v = x[((static_cast<int64_t>(zi) * Y + gy) * X + gx) * Cin + c];
        in_s[ci * HY * HX + p] = v;
      }
      // weight slab w[dz, ky, kx, c0:c0+CK, co0:co0+COT]
      for (int i = tid; i < 9 * CK * COT; i += NT) {
        const int co = i % COT;
        const int r = i / COT;
        const int ci = r % CK;
        const int k = r / CK;
        const int c = c0 + ci;
        float v = 0.f;
        if (c < Cin && co0 + co < Cout)
          v = w[(static_cast<int64_t>(dz * 9 + k) * Cin + c) * Cout + co0 + co];
        w_s[i] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int ky = k / 3;
        const int kx = k % 3;
#pragma unroll
        for (int ci = 0; ci < CK; ++ci) {
          const float v = in_s[ci * HY * HX + (ty + ky) * HX + tx + kx];
          const float4* wr =
              reinterpret_cast<const float4*>(&w_s[(k * CK + ci) * COT]);
#pragma unroll
          for (int q = 0; q < COT / 4; ++q) {
            const float4 ww = wr[q];
            acc[4 * q + 0] = fmaf(v, ww.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
          }
        }
      }
      __syncthreads();
    }
  }

  const int gy = y0 + ty;
  const int gx = x0 + tx;
  if (gy >= Y || gx >= X) return;
  float* out = y + ((static_cast<int64_t>(z) * Y + gy) * X + gx) * Cout + co0;
#pragma unroll
  for (int co = 0; co < COT; ++co) {
    if (co0 + co < Cout) {
      float v = acc[co] + b[co0 + co];
      if (relu) v = fmaxf(v, 0.f);
      out[co] = v;
    }
  }
}

}  // namespace

// B volumes of (Z, Y, X, Cin), contiguous; B * Z * ceil(Cout / 32) must fit
// grid.z (65535): the wrapper splits larger batches.
extern "C" int conv3x3x3_bias_relu_f32(const void* x, const void* w,
                                       const void* b, void* y, int B, int Z,
                                       int Y, int X, int Cin, int Cout,
                                       int relu, void* stream) {
  const int n_co = (Cout + COT - 1) / COT;
  dim3 block(BX, BY);
  dim3 grid((X + BX - 1) / BX, (Y + BY - 1) / BY, B * Z * n_co);
  conv3x3x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), Z, Y, X, Cin,
      Cout, relu);
  return static_cast<int>(cudaGetLastError());
}
