// SAME 3x3x3 convolution + bias (+ReLU) on a batch of channels-last f32
// volumes, for the layers the tensor-core kernel (conv3x3x3_wgmma.cu) does
// not take: widths that are not multiples of 8, on the port's paths only
// the c_in = 1 stems.
//
// Replaces: 3deecelltracker_tpu/ops/pallas_conv.py::conv3x3x3_fused, which
// computes relu(conv_same(x, w) + b) for x (z, y, x, c_in), w DHWIO
// (3, 3, 3, c_in, c_out), b (c_out,), with f32 accumulation, for the layers
// that ops/hopper_conv.py::route sends to "direct": the StarDist backbone's
// 1 -> 32 layer (with ReLU, one (24, 204, 84) volume) and U-Net a's 1 -> 8
// layer (without, a batch of 16 tiles of (16, 160, 160)).
//
// What bounds it on an H100: bytes.  A stem reads 4 B per voxel and writes
// c_out x 4 B, and does 27 x c_out FMAs per voxel: for the backbone's stem
// 54 MB (16 us at 3.35 TB/s) against 0.36 GFMA (11 us at the 67 TFLOP/s f32
// peak), for U-Net a's 236 MB (70 us) against 1.4 GFMA (42 us).  So the
// output store has to stream, and the FMAs must not be drowned in loads.
//
// Design:
// - Exact widths.  The kernel loops over exactly c_in input channels (c_in
//   = 1 is a template case with the channel loop compiled away), and the
//   output tile is COT = 8, 16 or 32 channels wide, the narrowest that holds
//   c_out (wider c_out takes several tiles).  A stem voxel costs 27 x COT
//   FMAs.
// - A block of 256 threads owns a TY (y) x TX (x) pixel tile and a COT
//   channel tile, and marches along z over a z-segment.  The host picks TX
//   = 16 for volumes at most 16 wide (U-Net a's tiles are 16 deep, and its
//   stem's conv sees that as x), else 32; TY = 2048 / (COT / 4) / TX; the
//   host also sizes the segments so the grid fills the card.  The input
//   planes live in a ring of three (TY + 2) x (TX + 2) halo planes in shared
//   memory: each step adds one plane, so every input voxel is read about
//   once per block.  With c_in = 1 that plane is loaded into registers
//   while the step before computes, and stored to its slot after it, so
//   the global load's latency hides behind the FMAs.  When c_in > 1 the
//   ring holds a chunk of up to 8 channels, loaded when needed and
//   refilled per chunk when c_in > 8 (correct at any width; speed there is
//   no goal).
// - The 27 x c_in x COT weights sit in shared memory; each thread reads its
//   4-channel group as a float4, a broadcast to the lanes of other pixels.
// - Thread (pixel lane q, channel group g), g fastest: a column run of P = 8
//   pixels and 4 channels, 32 accumulators.  For each (dz, dx) it loads the
//   column's P + 2 inputs once and uses each for up to three dy taps: 96
//   FMAs per 13 shared-memory loads.  The dz loop is not unrolled, which
//   keeps the registers under the two-blocks-per-SM cap without spills.
// - Coalesced stores: consecutive lanes write consecutive 16-byte pieces of
//   the channels-last output (a warp writes 512 contiguous bytes).  Bias +
//   ReLU are applied after the sum, as conv_same(x, w) + b.  Out-of-volume
//   taps read zeros (SAME padding); out-of-volume z taps are skipped.
// - BF16 is the JAX package's compute_dtype=bfloat16 (layers.py:50-60):
//   x and w are rounded to bf16 as they are loaded (__float2bfloat16_rn,
//   round to nearest even) and the FMAs stay f32, so each product is exact
//   and the sum is an f32 one of the rounded operands; the bias is added
//   unrounded.  The path's c_in = 1 stems under bf16: U-Net a's down0_0
//   (1 -> 8) and the StarDist stems (stem, the Keras pre0_0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int P = 8;      // pixels per thread, a column run
constexpr int KC = 8;     // input channels per ring chunk when c_in > 1
// registers per thread for the prefetched plane: the largest c_in = 1
// plane, 66 x 18 (COT 8, TX 16) or 34 x 34 (COT 8, TX 32) floats
constexpr int PF = 5;

// rows of the pixel tile: 256 / (cot / 4) pixel lanes of P pixels, tx to a
// row
__host__ __device__ constexpr int tile_rows(int cot, int tx) {
  return NT / (cot / 4) * P / tx;
}
__host__ __device__ constexpr int plane_floats(int cot, int tx) {
  return (tile_rows(cot, tx) + 2) * (tx + 2);
}
static_assert(plane_floats(8, 16) <= PF * NT && plane_floats(8, 32) <= PF * NT,
              "a c_in = 1 plane must fit the prefetch registers");

// v, or v rounded to the nearest bf16 (ties to even) when BF16 is set
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int COT, bool ONE, bool BF16>
__global__ void __launch_bounds__(NT, 2)
conv_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y,
                   int Z, int Y, int X, int Cin, int Cout, int tx, int zs,
                   int relu) {
  constexpr int G = COT / 4;            // 4-channel groups
  constexpr int KCM = ONE ? 1 : KC;     // channels a ring plane holds
  const int ty = tile_rows(COT, tx);
  const int hx = tx + 2;
  const int plane = plane_floats(COT, tx);
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                    // [27][KCM][COT]
  float* ring = smem + 27 * KCM * COT;  // [3][KCM][ty + 2][hx]

  // block -> (batch, c_out tile, z segment, y tile, x tile), x fastest
  const int ntx = (X + tx - 1) / tx;
  const int nty = (Y + ty - 1) / ty;
  const int nzs = (Z + zs - 1) / zs;
  const int nco = (Cout + COT - 1) / COT;
  int blk = blockIdx.x;
  const int x0 = (blk % ntx) * tx;
  blk /= ntx;
  const int y0 = (blk % nty) * ty;
  blk /= nty;
  const int z0 = (blk % nzs) * zs;
  blk /= nzs;
  const int co0 = (blk % nco) * COT;
  const int bi = blk / nco;
  const int64_t vox = static_cast<int64_t>(Z) * Y * X;
  x += bi * vox * Cin;
  y += bi * vox * Cout;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int q = tid / G;
  const int col = q % tx;
  const int row0 = (q / tx) * P;
  const int z1 = min(z0 + zs, Z);
  const int nch = ONE ? 1 : (Cin + KC - 1) / KC;
  int tag[3] = {-1, -1, -1};            // (plane, chunk) held by each slot

  // element i of halo plane zi (channel chunk c0, kc channels): (value,
  // index in the slot)
  auto halo = [&](int i, int zi, int c0, int kc, int* at) {
    const int ci = ONE ? 0 : i % kc;
    const int p = ONE ? i : i / kc;
    const int gy = y0 + p / hx - 1;
    const int gx = x0 + p % hx - 1;
    *at = ci * plane + p;
    if (gy < 0 || gy >= Y || gx < 0 || gx >= X) return 0.f;
    return operand<BF16>(
        x[((static_cast<int64_t>(zi) * Y + gy) * X + gx) * Cin + c0 + ci]);
  };

  for (int z = z0; z < z1; ++z) {
    float acc[P][4];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = ch * KCM;
      const int kc = ONE ? 1 : min(KC, Cin - c0);
      // weights of this chunk and c_out tile: w[dz, dy, dx, c0 + ci, co]
      if (z == z0 || nch > 1) {
        for (int i = tid; i < 27 * KCM * COT; i += NT) {
          const int co = i % COT;
          const int ci = (i / COT) % KCM;
          const int tap = i / (COT * KCM);
          float v = 0.f;
          if (ci < kc && co0 + co < Cout)
            v = operand<BF16>(
                w[(static_cast<int64_t>(tap) * Cin + c0 + ci) * Cout + co0 +
                  co]);
          w_s[i] = v;
        }
      }
      // the step's input planes that no earlier step left in their slots
      for (int dz = 0; dz < 3; ++dz) {
        const int zi = z + dz - 1;
        if (zi < 0 || zi >= Z) continue;          // uniform across the block
        const int slot = zi % 3;
        if (tag[slot] == zi * nch + ch) continue;
        tag[slot] = zi * nch + ch;
        float* dst = ring + slot * KCM * plane;
        for (int i = tid; i < kc * plane; i += NT) {
          int at;
          const float v = halo(i, zi, c0, kc, &at);
          dst[at] = v;
        }
      }
      __syncthreads();

      // c_in = 1: the next step's new plane, loaded while this one computes
      const int zn = z + 2;
      const bool ahead = ONE && z + 1 < z1 && zn < Z;
      float pf[PF];
      int pf_at[PF];
      if (ahead) {
#pragma unroll
        for (int j = 0; j < PF; ++j) {
          const int i = tid + j * NT;
          pf_at[j] = -1;
          if (i < plane) pf[j] = halo(i, zn, 0, 1, &pf_at[j]);
        }
      }

#pragma unroll 1
      for (int dz = 0; dz < 3; ++dz) {
        const int zi = z + dz - 1;
        if (zi < 0 || zi >= Z) continue;
        const float* pl = ring + (zi % 3) * KCM * plane + row0 * hx + col;
        for (int ci = 0; ci < kc; ++ci) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float v[P + 2];
#pragma unroll
            for (int r = 0; r < P + 2; ++r) v[r] = pl[ci * plane + r * hx + dx];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const float4 ww = *reinterpret_cast<const float4*>(
                  &w_s[((((dz * 3 + dy) * 3 + dx) * KCM) + ci) * COT + 4 * g]);
#pragma unroll
              for (int k = 0; k < P; ++k) {
                acc[k][0] = fmaf(v[k + dy], ww.x, acc[k][0]);
                acc[k][1] = fmaf(v[k + dy], ww.y, acc[k][1]);
                acc[k][2] = fmaf(v[k + dy], ww.z, acc[k][2]);
                acc[k][3] = fmaf(v[k + dy], ww.w, acc[k][3]);
              }
            }
          }
        }
      }
      __syncthreads();   // before a slot or w_s is overwritten
      if (ahead) {       // slot zn % 3 held plane z - 1, read for the last time
        float* dst = ring + (zn % 3) * plane;
#pragma unroll
        for (int j = 0; j < PF; ++j)
          if (pf_at[j] >= 0) dst[pf_at[j]] = pf[j];
        tag[zn % 3] = zn;
      }
    }

    // epilogue: bias after the sum, ReLU, one float4 per (pixel, group)
    const int co = co0 + 4 * g;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = co + j < Cout ? b[co + j] : 0.f;
    const int gx = x0 + col;
    const bool vec = (Cout % 4 == 0) && co + 4 <= Cout;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int gy = y0 + row0 + k;
      if (gy >= Y || gx >= X) continue;
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = acc[k][j] + bias[j];
        if (relu) r[j] = fmaxf(r[j], 0.f);
      }
      float* out = y + ((static_cast<int64_t>(z) * Y + gy) * X + gx) * Cout +
                   co;
      if (vec) {
        *reinterpret_cast<float4*>(out) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < Cout) out[j] = r[j];
      }
    }
  }
}

bool valid(int cot, int tx) {
  return (cot == 8 || cot == 16 || cot == 32) && (tx == 16 || tx == 32);
}

size_t smem_bytes(int cot, int cin, int tx) {
  const int kcm = cin == 1 ? 1 : KC;
  return sizeof(float) * (27 * kcm * cot + 3 * kcm * plane_floats(cot, tx));
}

template <int COT, bool ONE, bool BF16>
int launch(const float* x, const float* w, const float* b, float* y, int B,
           int Z, int Y, int X, int Cin, int Cout, int tx, int zs, int relu,
           cudaStream_t stream) {
  const int ty = tile_rows(COT, tx);
  const int64_t blocks = static_cast<int64_t>(B) * ((Cout + COT - 1) / COT) *
                         ((Z + zs - 1) / zs) * ((Y + ty - 1) / ty) *
                         ((X + tx - 1) / tx);
  if (blocks <= 0 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(COT, ONE ? 1 : Cin, tx);
  cudaError_t err = cudaFuncSetAttribute(
      conv_direct_kernel<COT, ONE, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_direct_kernel<COT, ONE, BF16><<<static_cast<unsigned>(blocks), NT,
                                        smem, stream>>>(
      x, w, b, y, Z, Y, X, Cin, Cout, tx, zs, relu);
  return static_cast<int>(cudaGetLastError());
}

// the output tile cot (8, 16 or 32) and c_in = 1 as template arguments
template <bool BF16>
int launch_tile(const float* x, const float* w, const float* b, float* y,
                int B, int Z, int Y, int X, int Cin, int Cout, int cot,
                int tx, int zs, int relu, cudaStream_t s) {
  const bool one = Cin == 1;
  if (cot == 8)
    return one ? launch<8, true, BF16>(x, w, b, y, B, Z, Y, X, Cin, Cout, tx,
                                       zs, relu, s)
               : launch<8, false, BF16>(x, w, b, y, B, Z, Y, X, Cin, Cout,
                                        tx, zs, relu, s);
  if (cot == 16)
    return one ? launch<16, true, BF16>(x, w, b, y, B, Z, Y, X, Cin, Cout,
                                        tx, zs, relu, s)
               : launch<16, false, BF16>(x, w, b, y, B, Z, Y, X, Cin, Cout,
                                         tx, zs, relu, s);
  return one ? launch<32, true, BF16>(x, w, b, y, B, Z, Y, X, Cin, Cout, tx,
                                      zs, relu, s)
             : launch<32, false, BF16>(x, w, b, y, B, Z, Y, X, Cin, Cout, tx,
                                       zs, relu, s);
}

}  // namespace

// The dynamic shared memory of one block for c_in channels, output tile cot
// and pixel tile width tx, in bytes; -1 for a tile the kernel does not have.
extern "C" int conv3x3x3_direct_smem_bytes(int cin, int cot, int tx) {
  if (cin < 1 || !valid(cot, tx)) return -1;
  return static_cast<int>(smem_bytes(cot, cin, tx));
}

// B volumes of (Z, Y, X, Cin), contiguous, into (B, Z, Y, X, Cout); cot is
// the output tile (8, 16 or 32), tx the pixel tile's width (16 or 32), zs
// the z-planes a block marches over; bf16 != 0 rounds x and w to bf16 on
// load.
extern "C" int conv3x3x3_direct_f32(const void* x, const void* w,
                                    const void* b, void* y, int B, int Z,
                                    int Y, int X, int Cin, int Cout, int cot,
                                    int tx, int zs, int relu, int bf16,
                                    void* stream) {
  if (Cin < 1 || Cout < 1 || zs < 1 || !valid(cot, tx))
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tile<true>(xp, wp, bp, yp, B, Z, Y, X, Cin, Cout, cot,
                                 tx, zs, relu, s)
              : launch_tile<false>(xp, wp, bp, yp, B, Z, Y, X, Cin, Cout, cot,
                                   tx, zs, relu, s);
}

