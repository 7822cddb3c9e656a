// The bf16 stem: SAME 3x3x3 convolution of a channels-last f32 volume with
// one input channel, its operands rounded to bf16, in the two modes of
// csrc/conv3x3x3_wgmma_bf16.cu: mode 0, y = act(conv(bf16(x), bf16(w)) +
// b) in f32 (act none or ReLU: the StarDist stems under JAX's layers.conv3d
// with compute_dtype=bfloat16); mode 1, the U-Net block, y = bf16_rne(BN(
// act(conv + b))) with BN(v) = (v - mean) * inv + beta (U-Net a's and c's
// down0_0, 1 -> 8, and b's, 1 -> 64), the epilogue's subtraction, product
// and sum without contraction, as the tensor-core kernel's.
//
// Replaces: the bf16 form of 3deecelltracker_tpu/ops/pallas_conv.py::
// conv3x3x3_fused's port for the layers ops/hopper_conv.py::route sends to
// "direct_bf16": the c_in = 1 stems (and any width off the tensor-core
// rule, which takes the simple kernel at the end of this file; none is on
// a path).
//
// What bounds it on an H100: U-Net a's stem (16 tiles of (160, 160, 16))
// reads 26 MB of f32 input and writes 105 MB of bf16 output: 39 us at
// 3.35 TB/s, against 13 us for its 0.36 GFMA at the 67 TFLOP/s f32 peak.
// Variant b's (216 tiles of (96, 96, 8), 1 -> 64) is bound by its 27.5
// GFMA (0.82 ms) before its 2 GB of output (0.61 ms).
//
// Design, a byte-bound stream:
// - A block of 256 threads owns a TY (y) x TX (x) pixel tile and a COT =
//   8, 16 or 32 channel tile, and marches along z over a z-segment; the
//   host plans TX (8, 16 or 32; TY = 256 / (COT / 8) x P / TX) to pad the
//   fewest pixels, then the segments (ops/hopper_conv.py::stem_plan).
//   The input planes live in a ring of three (TY + 2) x (TX + 2) halo
//   planes in shared memory: each step adds one plane, loaded into
//   registers while the step before computes and rounded to bf16 as it is
//   stored to its slot after it, so every input voxel is read once per
//   block and the load's latency hides behind the FMAs.  Each thread's
//   elements of a plane, their offsets and whether they lie in the volume,
//   are worked out once, before the march.
// - The 27 x COT weights, rounded, sit in shared memory; a warp's lanes
//   share one 8-channel group, so each (tap, group) is two float4
//   broadcasts.
// - Thread (group, pixel lane): a column run of P = 4 pixels and 8
//   channels, 32 accumulators; for each (dz, dx) it loads the column's P +
//   2 inputs once and uses each for up to three dy taps.  Each product of
//   two bf16 values is exact, so an FMA is one f32 rounding of the sum.
// - Epilogue, its bias and BatchNorm parameters held in registers for the
//   whole march: mode 1 rounds a pixel's 8 channels to bf16 and stores
//   them as one 16-byte store (consecutive lanes, consecutive pixels);
//   mode 0 stores two float4.  Out-of-volume taps read zeros (SAME
//   padding); out-of-volume z taps are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int P = 4;      // pixels a thread: a column run along y
constexpr int CG = 8;     // channels a thread: one 16-byte bf16 store
// a thread's elements of a halo plane: the largest plane, 130 x 10 floats
// (COT 8, TX 8)
constexpr int PF = 6;
constexpr float LEAKY_ALPHA = 0.3f;
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

// rows of the pixel tile: NT / (cot / 8) pixel lanes of P pixels, tx to a
// row
__host__ __device__ constexpr int tile_rows(int cot, int tx) {
  return NT / (cot / CG) * P / tx;
}
__host__ __device__ constexpr int plane_floats(int cot, int tx) {
  return (tile_rows(cot, tx) + 2) * (tx + 2);
}
static_assert(plane_floats(8, 8) <= PF * NT &&
              plane_floats(8, 16) <= PF * NT &&
              plane_floats(8, 32) <= PF * NT,
              "a plane must fit the prefetch registers");

__device__ __forceinline__ float rn_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Epi {
  const float* bias;
  const float* mean;     // mode 1 only
  const float* inv;
  const float* beta;
  void* y;
  int Cout, mode, act;
};

// the epilogue's parameters of channels c .. c + 7 (zero past Cout)
struct Chan8 {
  float b[CG], m[CG], i[CG], e[CG];
  __device__ __forceinline__ Chan8(const Epi& ep, int c) {
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const bool in = c + j < ep.Cout;
      b[j] = in ? ep.bias[c + j] : 0.f;
      const bool bn = in && ep.mode == 1;
      m[j] = bn ? ep.mean[c + j] : 0.f;
      i[j] = bn ? ep.inv[c + j] : 0.f;
      e[j] = bn ? ep.beta[c + j] : 0.f;
    }
  }
};

// channels c .. c + 7 of pixel `pix` (an index over B * Z * Y * X) from
// their sums, in the mode's epilogue
__device__ __forceinline__ void store8(const Epi& e, const Chan8& p,
                                       const float (&acc)[CG], int64_t pix,
                                       int c) {
  float v[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) {
    float r = acc[j] + p.b[j];
    if (e.act == ACT_RELU) r = fmaxf(r, 0.f);
    else if (e.act == ACT_LEAKY) r = r >= 0.f ? r : __fmul_rn(LEAKY_ALPHA, r);
    if (e.mode == 1)
      r = __fadd_rn(__fmul_rn(__fsub_rn(r, p.m[j]), p.i[j]), p.e[j]);
    v[j] = r;
  }
  const int64_t off = pix * e.Cout + c;
  const bool whole = (e.Cout % CG == 0) && c + CG <= e.Cout;
  if (e.mode == 1) {
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(e.y) + off;
    if (whole) {
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        u[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(y) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
#pragma unroll
      for (int j = 0; j < CG; ++j)
        if (c + j < e.Cout) y[j] = __float2bfloat16_rn(v[j]);
    }
  } else {
    float* y = static_cast<float*>(e.y) + off;
    if (whole) {
      *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(y + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int j = 0; j < CG; ++j)
        if (c + j < e.Cout) y[j] = v[j];
    }
  }
}

template <int COT>
__global__ void __launch_bounds__(NT, 2)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const Epi e, int Z, int Y, int X, int tx, int zs) {
  constexpr int G = COT / CG;           // 8-channel groups
  constexpr int LANES = NT / G;         // pixel lanes a group
  const int ty = tile_rows(COT, tx);
  const int hx = tx + 2;
  const int plane = plane_floats(COT, tx);
  const int Cout = e.Cout;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                    // [27][COT]
  float* ring = smem + 27 * COT;        // [3][ty + 2][hx]

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
  const int64_t yx = static_cast<int64_t>(Y) * X;
  x += bi * Z * yx;

  const int tid = threadIdx.x;
  const int gi = tid / LANES;           // warp-uniform
  const int q = tid % LANES;
  const int col = q % tx;
  const int row0 = (q / tx) * P;
  const int z1 = min(z0 + zs, Z);

  // this thread's elements tid + j NT of a halo plane: their offsets in an
  // input plane, those in the volume (`in`) and those in the halo (`mine`)
  int off[PF];
  uint32_t in = 0, mine = 0;
#pragma unroll
  for (int j = 0; j < PF; ++j) {
    const int i = tid + j * NT;
    const int gy = y0 + i / hx - 1;
    const int gx = x0 + i % hx - 1;
    off[j] = gy * X + gx;
    if (i < plane) mine |= 1u << j;
    if (i < plane && gy >= 0 && gy < Y && gx >= 0 && gx < X) in |= 1u << j;
  }
  auto load = [&](float (&v)[PF], int zi) {
#pragma unroll
    for (int j = 0; j < PF; ++j)
      v[j] = (in >> j) & 1 ? x[zi * yx + off[j]] : 0.f;
  };
  auto put = [&](const float (&v)[PF], int zi) {
    float* dst = ring + (zi % 3) * plane + tid;
#pragma unroll
    for (int j = 0; j < PF; ++j)
      if ((mine >> j) & 1) dst[j * NT] = rn_bf16(v[j]);
  };

  for (int i = tid; i < 27 * COT; i += NT) {
    const int co = co0 + i % COT;
    w_s[i] = co < Cout ? rn_bf16(w[(i / COT) * Cout + co]) : 0.f;
  }
  float pf[PF];
  for (int zi = max(z0 - 1, 0); zi <= min(z0 + 1, Z - 1); ++zi) {
    load(pf, zi);
    put(pf, zi);
  }
  const int c = co0 + CG * gi;
  const Chan8 par(e, c);

  for (int z = z0; z < z1; ++z) {
    __syncthreads();
    const int za = z + 2;                   // the next step's new plane
    const bool ahead = z + 1 < z1 && za < Z;
    if (ahead) load(pf, za);

    float acc[P][CG];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int j = 0; j < CG; ++j) acc[k][j] = 0.f;
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
      const int zi = z + dz - 1;
      if (zi < 0 || zi >= Z) continue;
      const float* pl = ring + (zi % 3) * plane + row0 * hx + col;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[P + 2];
#pragma unroll
        for (int r = 0; r < P + 2; ++r) v[r] = pl[r * hx + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* wp = &w_s[((dz * 3 + dy) * 3 + dx) * COT + CG * gi];
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
          const float ww[CG] = {wa.x, wa.y, wa.z, wa.w,
                                wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int k = 0; k < P; ++k)
#pragma unroll
            for (int j = 0; j < CG; ++j)
              acc[k][j] = fmaf(v[k + dy], ww[j], acc[k][j]);
        }
      }
    }
    __syncthreads();   // every read of slot (z - 1) % 3 is done
    if (ahead) put(pf, za);   // slot za % 3 held plane z - 1

    const int gx = x0 + col;
    if (gx < X && c < Cout) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int gy = y0 + row0 + k;
        if (gy < Y)
          store8(e, par, acc[k],
                 ((bi * static_cast<int64_t>(Z) + z) * Y + gy) * X + gx, c);
      }
    }
  }
}

// any c_in (widths off the tensor-core rule; on no path): one thread per
// (voxel, 8-channel group), operands read and rounded from device memory
__global__ void __launch_bounds__(NT)
simple_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const Epi e, int B, int Z, int Y, int X, int Cin) {
  const int groups = (e.Cout + CG - 1) / CG;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (n >= static_cast<int64_t>(B) * Z * Y * X * groups) return;
  const int c = static_cast<int>(n % groups) * CG;
  const int64_t pix = n / groups;
  const int xx = static_cast<int>(pix % X);
  const int yy = static_cast<int>(pix / X % Y);
  const int zz = static_cast<int>(pix / X / Y % Z);
  const int64_t b = pix / X / Y / Z;
  float acc[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) acc[j] = 0.f;
  for (int tap = 0; tap < 27; ++tap) {
    const int zi = zz + tap / 9 - 1, yi = yy + tap / 3 % 3 - 1,
              xi = xx + tap % 3 - 1;
    if (zi < 0 || zi >= Z || yi < 0 || yi >= Y || xi < 0 || xi >= X)
      continue;
    const float* xp = x + (((b * Z + zi) * Y + yi) * X + xi) * Cin;
    for (int ci = 0; ci < Cin; ++ci) {
      const float xv = rn_bf16(xp[ci]);
      const float* wp = w + (static_cast<int64_t>(tap) * Cin + ci) * e.Cout;
#pragma unroll
      for (int j = 0; j < CG; ++j)
        if (c + j < e.Cout) acc[j] = fmaf(xv, rn_bf16(wp[c + j]), acc[j]);
    }
  }
  store8(e, Chan8(e, c), acc, pix, c);
}

bool valid(int cot, int tx) {
  return (cot == 8 || cot == 16 || cot == 32) &&
         (tx == 8 || tx == 16 || tx == 32);
}

size_t smem_bytes(int cot, int tx) {
  return sizeof(float) * (27 * cot + 3 * plane_floats(cot, tx));
}

template <int COT>
int launch_stem(const float* x, const float* w, const Epi& e, int B, int Z,
                int Y, int X, int tx, int zs, cudaStream_t stream) {
  const int ty = tile_rows(COT, tx);
  const int64_t blocks = static_cast<int64_t>(B) *
                         ((e.Cout + COT - 1) / COT) * ((Z + zs - 1) / zs) *
                         ((Y + ty - 1) / ty) * ((X + tx - 1) / tx);
  if (blocks <= 0 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(Y) * X > 0x7fffffff / 2)
    return cudaErrorInvalidValue;   // plane offsets are 32-bit
  const size_t smem = smem_bytes(COT, tx);
  const cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<COT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_kernel<COT><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      x, w, e, Z, Y, X, tx, zs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory of one stem block for output tile cot and pixel
// tile width tx, in bytes; -1 for a tile the kernel does not have.
extern "C" int conv3x3x3_bf16_smem_bytes(int cot, int tx) {
  return valid(cot, tx) ? static_cast<int>(smem_bytes(cot, tx)) : -1;
}

// B f32 volumes x of (Z, Y, X, Cin), contiguous, into y (B, Z, Y, X, Cout):
// f32 in mode 0, bf16 in mode 1; w the f32 DHWIO weights, b the f32 bias;
// mode 1 also takes BatchNorm's f32 mean, inv and beta per channel (else
// null); act 0 none, 1 ReLU, 2 LeakyReLU (mode 1 only).  Cin == 1 takes
// the stem kernel with output tile cot (8, 16 or 32), pixel tile width tx
// (8, 16 or 32) and zs z-planes a block (ops/hopper_conv.py::stem_plan);
// any other Cin the simple kernel.  Returns cudaGetLastError() after the
// launch.
extern "C" int conv3x3x3_bf16(const void* x, const void* w, const void* b,
                              const void* mean, const void* inv,
                              const void* beta, void* y, int B, int Z, int Y,
                              int X, int Cin, int Cout, int cot, int tx,
                              int zs, int mode, int act, void* stream) {
  if (Cin < 1 || Cout < 1 || zs < 1 || !valid(cot, tx))
    return cudaErrorInvalidValue;
  Epi e;
  e.bias = static_cast<const float*>(b);
  e.mean = static_cast<const float*>(mean);
  e.inv = static_cast<const float*>(inv);
  e.beta = static_cast<const float*>(beta);
  e.y = y;
  e.Cout = Cout;
  e.mode = mode;
  e.act = act;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto s = static_cast<cudaStream_t>(stream);
  if (Cin > 1) {
    const int64_t n = static_cast<int64_t>(B) * Z * Y * X *
                      ((Cout + CG - 1) / CG);
    const int64_t blocks = (n + NT - 1) / NT;
    if (blocks <= 0 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
    simple_kernel<<<static_cast<unsigned>(blocks), NT, 0, s>>>(
        xp, wp, e, B, Z, Y, X, Cin);
    return static_cast<int>(cudaGetLastError());
  }
  if (cot == 8) return launch_stem<8>(xp, wp, e, B, Z, Y, X, tx, zs, s);
  if (cot == 16) return launch_stem<16>(xp, wp, e, B, Z, Y, X, tx, zs, s);
  return launch_stem<32>(xp, wp, e, B, Z, Y, X, tx, zs, s);
}
