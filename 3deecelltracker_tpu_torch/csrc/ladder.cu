// The conv probe's kernel ladder: three f32 kernels that time the building
// blocks of the backbone's 3x3x3 conv at its hot shape, (24, 204, 84) voxels
// with 32 input channels.
//
// Replaces: scripts/probe_conv_fast.py::pallas_ladder, the Pallas constructs
// A (a pipelined block passthrough, x + 1), B and B2 (an in-kernel channel
// product, einsum("zyxc,co->zyxo"), once on the 4-D block and once after a
// reshape to 2-D: the same function) and C (the conv as nine shifted-view
// products of a z-packed volume, + bias, ReLU).  Entry E of that ladder is
// the backbone conv kernel, csrc/conv3x3x3.cu.
//
// What bounds each on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores):
// - add_one moves 2 x 52.6 MB at the probe shape and does one add per float:
//   bytes, 31.4 us.  One grid-stride kernel of 16-byte loads and stores
//   (float4), then a scalar tail, keeps every transaction full.
// - pointwise_matmul: M = 411,264 voxels, K = N = 32 is 0.84 GFLOP against
//   105 MB, 8 FLOP per byte: bytes, 31.4 us.  w sits in shared memory, each
//   thread owns one voxel and 32 output channels in registers; the x tile is
//   staged through shared memory (row stride c_in + 1, so the per-thread rows
//   fall in different banks) and the output tile too, so that every global
//   read and write is coalesced.
// - conv9view: 2 * M * 9 * 96 * c_out FLOP (22.7 GFLOP at c_out 32, 91 at
//   128) against ~0.1 GB: operations, 0.34 / 1.36 ms in f32.  An implicit
//   GEMM: a block owns 8 x 16 output pixels at one z and 32 output channels
//   (c_out <= 32) or 128 (a partial tile, or several, above that: all of
//   them at the probe's widths); K runs over 8-channel
//   chunks of the 96 packed channels, for each of which the 10 x 18 halo
//   slab of vz and the 9 x 8 x BN weight slab sit in shared memory.  Each
//   thread keeps a PM x PN register tile (4 x 4 at c_out 32, 8 x 8 at 128),
//   so one shared-memory read feeds PN or PM FMAs; bias and ReLU are the
//   epilogue.  The nine views are offsets into the halo slab, never copies.
//   Tensor cores (TF32 wgmma) would change the numerics and are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- A: x + 1 --------------------------------------------------------------

// y = x + 1: float4 loads and stores over the first n4 * 4 floats, scalar
// ones over the rest (all of them when x or y is not 16-byte aligned).
__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int64_t n4, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t i = t; i < n4; i += stride) {
    float4 v = x4[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    y4[i] = v;
  }
  for (int64_t i = n4 * 4 + t; i < n; i += stride) y[i] = x[i] + 1.f;
}

// ---- B: per-voxel channel product -----------------------------------------

constexpr int PW_M = 128;   // voxels per block (one per thread)
constexpr int PW_N = 32;    // output channels per block

__global__ void __launch_bounds__(PW_M)
pointwise_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, int64_t M, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                       // Cin x PW_N
  float* x_s = w_s + Cin * PW_N;           // PW_M x (Cin + 1)
  float* o_s = x_s + PW_M * (Cin + 1);     // PW_M x (PW_N + 1)
  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * PW_M;
  const int n0 = blockIdx.y * PW_N;
  const int rows = static_cast<int>(M - m0 < PW_M ? M - m0 : PW_M);

  for (int i = t; i < Cin * PW_N; i += PW_M) {
    const int c = i / PW_N;
    const int n = n0 + i % PW_N;
    w_s[i] = n < Cout ? w[static_cast<int64_t>(c) * Cout + n] : 0.f;
  }
  // the block's rows are one contiguous run of rows * Cin floats
  const float* xb = x + m0 * Cin;
  for (int i = t; i < rows * Cin; i += PW_M)
    x_s[(i / Cin) * (Cin + 1) + i % Cin] = xb[i];
  __syncthreads();

  float acc[PW_N];
#pragma unroll
  for (int j = 0; j < PW_N; ++j) acc[j] = 0.f;
  if (t < rows) {
    const float* xr = x_s + t * (Cin + 1);
    for (int c = 0; c < Cin; ++c) {
      const float v = xr[c];
      const float4* wr = reinterpret_cast<const float4*>(w_s + c * PW_N);
#pragma unroll
      for (int q = 0; q < PW_N / 4; ++q) {
        const float4 ww = wr[q];
        acc[4 * q + 0] = fmaf(v, ww.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PW_N; ++j) o_s[t * (PW_N + 1) + j] = acc[j];
  __syncthreads();
  const int nw = Cout - n0 < PW_N ? Cout - n0 : PW_N;
  for (int i = t; i < rows * nw; i += PW_M) {
    const int r = i / nw;
    const int j = i % nw;
    y[(m0 + r) * Cout + n0 + j] = o_s[r * (PW_N + 1) + j];
  }
}

// ---- C: the 9-view conv ----------------------------------------------------

constexpr int CV_TX = 16;            // output x per block
constexpr int CV_TY = 8;             // output y per block
constexpr int CV_BM = CV_TX * CV_TY; // output pixels per block
constexpr int CV_HX = CV_TX + 2;
constexpr int CV_HY = CV_TY + 2;
constexpr int CV_KC = 8;             // packed channels per shared-memory stage
constexpr int CV_NT = 256;

// BN output channels per block; each thread owns PM pixels x PN channels.
template <int BN, int PN>
__global__ void __launch_bounds__(CV_NT)
conv9view_kernel(const float* __restrict__ vz, const float* __restrict__ w9,
                 const float* __restrict__ b, float* __restrict__ out, int Z,
                 int Y, int X, int K3, int Cout) {
  constexpr int NG = BN / PN;        // thread groups along the channels
  constexpr int MG = CV_NT / NG;     // thread groups along the pixels
  constexpr int PM = CV_BM / MG;
  static_assert(CV_BM % MG == 0 && PN % 4 == 0, "tile shape");
  __shared__ float in_s[CV_KC * CV_HY * CV_HX];
  __shared__ __align__(16) float w_s[9 * CV_KC * BN];

  const int tid = threadIdx.x;
  const int tn = tid % NG;
  const int tm = tid / NG;
  const int x0 = blockIdx.x * CV_TX;
  const int y0 = blockIdx.y * CV_TY;
  const int n_co = (Cout + BN - 1) / BN;
  const int z = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * BN;
  const int YP = Y + 2;
  const int XP = X + 2;
  const float* vzz = vz + static_cast<int64_t>(z) * YP * XP * K3;

  // this thread's pixels in the tile: p = tm + i * MG
  int poff[PM];
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int p = tm + i * MG;
    poff[i] = (p / CV_TX) * CV_HX + p % CV_TX;
  }

  float acc[PM][PN];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K3; k0 += CV_KC) {
    // halo slab of vz rows y0 .. y0 + 9, columns x0 .. x0 + 17, channel-planar
    for (int i = tid; i < CV_KC * CV_HY * CV_HX; i += CV_NT) {
      const int kc = i % CV_KC;
      const int p = i / CV_KC;
      const int gy = y0 + p / CV_HX;
      const int gx = x0 + p % CV_HX;
      const int k = k0 + kc;
      float v = 0.f;
      if (gy < YP && gx < XP && k < K3)
        v = vzz[(static_cast<int64_t>(gy) * XP + gx) * K3 + k];
      in_s[kc * CV_HY * CV_HX + p] = v;
    }
    // w9[tap, k0:k0+KC, co0:co0+BN]
    for (int i = tid; i < 9 * CV_KC * BN; i += CV_NT) {
      const int n = i % BN;
      const int r = i / BN;
      const int kc = r % CV_KC;
      const int tap = r / CV_KC;
      const int k = k0 + kc;
      float v = 0.f;
      if (k < K3 && co0 + n < Cout)
        v = w9[(static_cast<int64_t>(tap) * K3 + k) * Cout + co0 + n];
      w_s[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * CV_HX + tap % 3;
#pragma unroll
      for (int kc = 0; kc < CV_KC; ++kc) {
        float a[PM];
#pragma unroll
        for (int i = 0; i < PM; ++i)
          a[i] = in_s[kc * CV_HY * CV_HX + poff[i] + toff];
        float bw[PN];
        const float4* wr = reinterpret_cast<const float4*>(
            &w_s[(tap * CV_KC + kc) * BN + tn * PN]);
#pragma unroll
        for (int q = 0; q < PN / 4; ++q) {
          const float4 ww = wr[q];
          bw[4 * q + 0] = ww.x;
          bw[4 * q + 1] = ww.y;
          bw[4 * q + 2] = ww.z;
          bw[4 * q + 3] = ww.w;
        }
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < PN; ++j)
            acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int p = tm + i * MG;
    const int gy = y0 + p / CV_TX;
    const int gx = x0 + p % CV_TX;
    if (gy >= Y || gx >= X) continue;
    float* o = out + ((static_cast<int64_t>(z) * Y + gy) * X + gx) * Cout;
#pragma unroll
    for (int j = 0; j < PN; ++j) {
      const int n = co0 + tn * PN + j;
      if (n < Cout) o[n] = fmaxf(acc[i][j] + b[n], 0.f);
    }
  }
}

template <int BN, int PN>
int launch_conv9view(const float* vz, const float* w9, const float* b,
                     float* y, int Z, int Y, int X, int K3, int Cout,
                     cudaStream_t stream) {
  const int n_co = (Cout + BN - 1) / BN;
  dim3 grid((X + CV_TX - 1) / CV_TX, (Y + CV_TY - 1) / CV_TY, Z * n_co);
  conv9view_kernel<BN, PN><<<grid, CV_NT, 0, stream>>>(vz, w9, b, y, Z, Y,
                                                         X, K3, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = x + 1 over n floats, one launch.
extern "C" int ladder_add_one_f32(const void* x, void* y, long long n,
                                  void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int64_t work = n4 > n - n4 * 4 ? n4 : n - n4 * 4;
  if (work <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const int64_t max_blocks = 132 * 16;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  add_one_kernel<<<static_cast<int>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n4, n);
  return static_cast<int>(cudaGetLastError());
}

// y (M, Cout) = x (M, Cin) @ w (Cin, Cout), all contiguous.
extern "C" int ladder_pointwise_matmul_f32(const void* x, const void* w,
                                           void* y, long long M, int Cin,
                                           int Cout, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(Cin) * PW_N +
                                       PW_M * (Cin + 1) + PW_M * (PW_N + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pointwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (M <= 0 || Cout <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(static_cast<unsigned>((M + PW_M - 1) / PW_M),
            (Cout + PW_N - 1) / PW_N);
  pointwise_kernel<<<grid, PW_M, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), M, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

// y (Z, Y, X, Cout) = relu(sum over the nine (dy, dx) views
// vz[:, dy:dy+Y, dx:dx+X, :] @ w9[dy, dx] + b) for the packed volume
// vz (Z, Y + 2, X + 2, K3) and w9 (3, 3, K3, Cout); Z * ceil(Cout / BN) must
// fit grid.z (65535).
extern "C" int ladder_conv9view_bias_relu_f32(const void* vz, const void* w9,
                                              const void* b, void* y, int Z,
                                              int Y, int X, int K3, int Cout,
                                              void* stream) {
  const float* v = static_cast<const float*>(vz);
  const float* w = static_cast<const float*>(w9);
  const float* bb = static_cast<const float*>(b);
  float* o = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 32) return launch_conv9view<32, 4>(v, w, bb, o, Z, Y, X, K3,
                                                 Cout, s);
  return launch_conv9view<128, 8>(v, w, bb, o, Z, Y, X, K3, Cout, s);
}
