// SAME 3x3x3 convolution of bf16 activations on Hopper's tensor cores, one
// bf16 pass, on a batch of channels-last volumes, in two modes:
//
// - the bf16 layer (mode 0): y = act(conv(x, bf16(w)) + b), f32 out, act
//   none or ReLU: JAX's layers.conv3d with compute_dtype=bfloat16
//   (3deecelltracker_tpu/models/layers.py:50-60, XLA's conv with bf16
//   operands and preferred_element_type=f32; no Pallas kernel);
// - the U-Net block (mode 1): y = bf16_rne(BN(act(conv(x, bf16(w)) + b)))
//   with BN(v) = (v - mean) * inv + beta and act none, ReLU or LeakyReLU
//   (alpha 0.3), everything before the rounding in f32: JAX's block
//   conv3d -> act -> batchnorm(train=False) (models/unet3d.py:88-92), whose
//   next conv rounds that output to bf16 again, so storing it rounded hands
//   on exactly what JAX's next layer consumes.  The subtraction, product
//   and sum are __fsub_rn / __fmul_rn / __fadd_rn (no contraction into an
//   FMA), so given equal f32 sums the block equals mode 0 followed by
//   PyTorch's act, layers.batchnorm and .to(torch.bfloat16), bit for bit.
//
// Replaces: the bf16 form of 3deecelltracker_tpu/ops/pallas_conv.py::
// conv3x3x3_fused's port (x (z, y, x, c_in), w DHWIO (3, 3, 3, c_in,
// c_out), b (c_out,)); it takes every layer with c_in % 8 == 0 and c_out %
// 8 == 0 of the legacy U-Net (variants a, b, c) and of the StarDist
// backbone when they run in bf16.  x is bf16 (the wrapper rounds an f32
// input once, to nearest even); each product of two bf16 values is exact
// in f32, so the sum equals an f32 conv of the rounded operands up to
// summation order.
//
// What bounds it on an H100: U-Net a's layers are bound by their bytes (a
// bf16 activation of 8-128 channels read once, one of 8-64 written; at
// 3.35 TB/s), variant b's 64-384-channel layers by the bf16 tensor cores
// (989 TFLOP/s) and, behind them, by the weights each block streams from
// L2 (27 x c_in x NB x 2 bytes a 128-pixel tile).
//
// Design (M = output pixels, N = c_out in tiles of NB = 8..128, K = 27
// taps x c_in):
// - bf16 halos by TMA.  Each 8-channel plane of the input halo is one TMA
//   box of the bf16 5-D tensor map over (c, x, y, z, b), 16 bytes a pixel,
//   TMA's zero fill being the SAME padding (z and b are separate
//   dimensions, so a z-halo never reads the next volume).
// - A from shared memory.  A wgmma's 64 rows are an 8 (y) x 8 (x) pixel
//   tile: core matrix i is halo row i's 8 consecutive x-pixels (8 rows of
//   16 bytes, contiguous), so the descriptor's stride between core
//   matrices is the halo's row pitch, its leading offset the distance to
//   the chunk's second 8-channel plane, and every (dy, dx) tap is the same
//   descriptor started (dy * HX + dx) pixels on.  No thread loads or
//   converts an A fragment.  A half chunk (c_in % 16 == 8) loads no second
//   plane: its leading offset points at a plane of zeros that the block
//   clears once, after the ring, so the missing channels' zero weights
//   meet zeros and add exact zeros whatever the activations hold (Inf or
//   NaN in the loaded plane stays in its own channels, as in the plain
//   conv).
// - Narrow N tiles take MT = 4 (N 8) or 2 (N 16-32) such 8 x 8 tiles a
//   warpgroup, stacked in y (MT accumulators): a wgmma of N 8-32 is too
//   short for its latency, so a stage issues its MT x 9 wgmmas tap by tap,
//   MT independent ones back to back, and each stage's halo serves MT
//   times the pixels (measured: 8 tiles spill, 2 at N 8 and 4 at N 16 are
//   slower).
// - Warp specialization.  Two consumer warpgroups share each stage; a
//   producer warp (warp 8, one lane) keeps a ring of `stages` buffers full
//   behind full/empty mbarriers and never computes.
// - Persistent blocks.  The grid is what fits on the card (per N tile);
//   each block walks pixel tiles, so the producer runs ahead into the next
//   tile while the consumers finish and store this one.  Where a block's
//   whole N tile of weights fits beside the ring (the narrow layers), it
//   is loaded once and stays resident; otherwise each stage brings its 9
//   taps of weights (the wide layers).
// - Tile orientation: 16 (x) x 8 MT (y) pixels a block (the two
//   warpgroups side by side in x), or 8 x 16 MT (one above the other)
//   where that pads fewer pixels (variant b's 8-wide tiles).
// - Numerics.  A stage is one 16-channel chunk at one z-tap: 9 k16 wgmmas
//   (144 products a sum).  The tensor cores truncate when they add into
//   the accumulator, an error biased toward zero that grows with K, so
//   each stage's partial sum starts afresh and is added to `sum` in
//   registers with f32 rounding.  Two warpgroups issue in turn:
//   while one adds its partial, the other's wgmmas keep the tensor cores
//   busy.
// - Epilogue, masked at the ragged y/x edge: mode 0 stores float2 pairs;
//   mode 1 packs bf16 pairs, swaps them across the 4 lanes of a quad so
//   that each lane holds 8 channels of one pixel, and stores 16 bytes.
//
// Weights come rounded to bf16 (round to nearest even) and packed by
// ops/hopper_conv.py::pack_weights_bf16 in the k16 K-major core-matrix
// layout, one stage contiguous.  The building blocks (mbarriers, TMA,
// wgmma, descriptors, the tensor-map encoder) are in hopper_common.cuh.

#include <cuda_bf16.h>

#include "hopper_common.cuh"

namespace {

constexpr int CK = 8;                    // channels a halo plane holds
constexpr int KC = 16;                   // channels a stage holds (k16)
constexpr int WG = 128;
constexpr int CONSUMERS = 2;             // warpgroups that compute
constexpr int THREADS = CONSUMERS * WG + 32;   // + the producer warp
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int MAX_STAGES = 8;
constexpr int SM_SMEM = 233472;          // shared memory of an SM, bytes
constexpr int BLOCK_RESERVED = 1024;     // what the card keeps per block
constexpr float LEAKY_ALPHA = 0.3f;
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

template <int NB>
struct Tile {
  static constexpr int W_BYTES = 9 * KC * NB * 2;   // one stage's weights
  // 8 x 8 pixel tiles a warpgroup (accumulators), and the blocks an SM is
  // meant to hold (which caps the registers)
  static constexpr int MT = NB == 8 ? 4 : (NB <= 32 ? 2 : 1);
  static constexpr int MIN_BLOCKS = NB <= 64 ? 2 : 1;
};

// the block's pixel tile, (8 MT) x 16 or, tall, (16 MT) x 8 (y x x), and
// the bytes of one 8-channel halo plane of it, as TMA writes it and as a
// ring slot holds it (128-byte aligned)
__host__ __device__ constexpr int tile_h(int mt, int tall) {
  return tall ? 16 * mt : 8 * mt;
}
__host__ __device__ constexpr int tile_w(int tall) { return tall ? 8 : 16; }
__host__ __device__ constexpr int plane_box(int mt, int tall) {
  return (tile_h(mt, tall) + 2) * (tile_w(tall) + 2) * CK * 2;
}
__host__ __device__ constexpr int plane_pitch(int mt, int tall) {
  return (plane_box(mt, tall) + 127) / 128 * 128;
}

struct Args {
  const void* wp;
  const float* bias;
  const float* mean;     // mode 1: BatchNorm's mean, inv, beta per channel
  const float* inv;
  const float* beta;
  void* y;
  int Z, Y, X, Cin, Cout;
  int tiles_x, tiles_y, n_tiles;   // pixel tiles of one N tile
  int tall;
  int mode, act;
  int resident, stages;
};

// mbar_wait that gives up with a trap after ~2^28 polls (seconds), so a
// pipeline fault fails the launch instead of hanging the card
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ float block_epilogue(float v, float b, float mean,
                                                float inv, float beta,
                                                int act) {
  v = __fadd_rn(v, b);
  if (act == ACT_RELU) v = fmaxf(v, 0.f);
  else if (act == ACT_LEAKY) v = v >= 0.f ? v : __fmul_rn(LEAKY_ALPHA, v);
  return __fadd_rn(__fmul_rn(__fsub_rn(v, mean), inv), beta);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// the epilogue of one 8 x 8 pixel tile: s[4i + 2h + e] is row 16q + 8h +
// g of its 64, pixel (yb + h, xo), channel n0 + 8i + 2t + e
template <int NB>
__device__ __forceinline__ void store_tile(const Args& a,
                                           const float (&s)[NB / 2],
                                           int64_t row0, int yb, int xo,
                                           int n0, int t) {
  if (a.mode == 0) {
    float* y = static_cast<float*>(a.y);
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      if (n >= a.Cout) continue;   // Cout % 8 == 0: n + 1 < Cout too
      const float b0 = a.bias[n];
      const float b1 = a.bias[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (yb + h >= a.Y || xo >= a.X) continue;
        float v0 = s[4 * i + 2 * h] + b0;
        float v1 = s[4 * i + 2 * h + 1] + b1;
        if (a.act == ACT_RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<float2*>(y + (row0 + h * a.X) * a.Cout + n) =
            make_float2(v0, v1);
      }
    }
    return;
  }
  // mode 1: item j = h * (NB / 8) + i holds pixel row h, channels 8i ..
  // 8i + 7, lane t its pair 2t, 2t + 1
  uint32_t u[NB / 4];
#pragma unroll
  for (int i = 0; i < NB / 8; ++i) {
    const int n = n0 + 8 * i + 2 * t;
    const bool in = n < a.Cout;
    const float b0 = in ? a.bias[n] : 0.f, b1 = in ? a.bias[n + 1] : 0.f;
    const float m0 = in ? a.mean[n] : 0.f, m1 = in ? a.mean[n + 1] : 0.f;
    const float i0 = in ? a.inv[n] : 0.f, i1 = in ? a.inv[n + 1] : 0.f;
    const float e0 = in ? a.beta[n] : 0.f, e1 = in ? a.beta[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      u[h * (NB / 8) + i] = bf16x2_rn(
          block_epilogue(s[4 * i + 2 * h], b0, m0, i0, e0, a.act),
          block_epilogue(s[4 * i + 2 * h + 1], b1, m1, i1, e1, a.act));
  }
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  // four items at a time, transposed across the quad: lane t ends with
  // item base + t's four pairs, one 16-byte store
#pragma unroll
  for (int base = 0; base < NB / 4; base += 4) {
    uint32_t v[4], o[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      v[kk] = base + kk < NB / 4 ? u[(base + kk) % (NB / 4)] : 0u;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      // from lane t ^ rr: its pair of item base + t
      const uint32_t got =
          __shfl_xor_sync(0xffffffffu, pick4(v, t ^ rr), rr);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk == (t ^ rr)) o[kk] = got;
    }
    const int j = base + t;
    if (j >= NB / 4) continue;
    const int h = j / (NB / 8);
    const int n = n0 + 8 * (j % (NB / 8));
    if (n >= a.Cout || yb + h >= a.Y || xo >= a.X) continue;
    *reinterpret_cast<uint4*>(y + (row0 + h * a.X) * a.Cout + n) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, Tile<NB>::MIN_BLOCKS)
conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  constexpr int WB = Tile<NB>::W_BYTES;
  constexpr int MT = Tile<NB>::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_iters = (a.Cin + KC - 1) / KC * 3;   // stage: (chunk, dz)
  const int S = a.stages;
  const int box = plane_box(MT, a.tall);
  const int pitch = plane_pitch(MT, a.tall);
  const int slot_bytes = 2 * pitch + (a.resident ? 0 : WB);
  const bool half = a.Cin % KC != 0;       // the last chunk is a half one
  unsigned char* w_res = smem;
  unsigned char* ring = smem + (a.resident ? n_iters * WB : 0);
  // a half chunk's second k-half: `pitch` bytes of zeros after the ring
  unsigned char* zeros = ring + S * slot_bytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(zeros + (half ? pitch : 0));
  uint64_t* empty = full + S;
  uint64_t* wbar = empty + S;
  const int nc = blockIdx.y;
  const unsigned char* src = static_cast<const unsigned char*>(a.wp) +
                             static_cast<int64_t>(nc) * n_iters * WB;
  const int tw = tile_w(a.tall);
  const int th = tile_h(MT, a.tall);
  const int hx = tw + 2;

  if (half) {
    for (int i = threadIdx.x; i < pitch / 16; i += THREADS)
      reinterpret_cast<uint4*>(zeros)[i] = make_uint4(0u, 0u, 0u, 0u);
    // the wgmmas read the plane through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == PRODUCER_WARP) {
    if (threadIdx.x % 32 != 0) return;
    if (a.resident) {
      mbar_expect_tx(wbar, n_iters * WB);
      bulk_load(w_res, src, n_iters * WB, wbar);
    }
    int k = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      int r = tile;
      const int x0 = (r % a.tiles_x) * tw - 1;
      r /= a.tiles_x;
      const int y0 = (r % a.tiles_y) * th - 1;
      r /= a.tiles_y;
      const int z = r % a.Z;
      const int bz = r / a.Z;
      for (int it = 0; it < n_iters; ++it, ++k) {
        const int s = k % S;
        if (k >= S) wait_or_trap(&empty[s], (k / S - 1) & 1);
        unsigned char* slot = ring + s * slot_bytes;
        const int c0 = (it / 3) * KC;
        const bool two = c0 + CK < a.Cin;    // else a half chunk
        const int zz = z + it % 3 - 1;
        mbar_expect_tx(&full[s],
                       (two ? 2 : 1) * box + (a.resident ? 0 : WB));
        tma_halo(reinterpret_cast<float*>(slot), &xmap, &full[s], c0, x0, y0,
                 zz, bz);
        if (two)
          tma_halo(reinterpret_cast<float*>(slot + pitch), &xmap, &full[s],
                   c0 + CK, x0, y0, zz, bz);
        if (!a.resident)
          bulk_load(slot + 2 * pitch, src + static_cast<int64_t>(it) * WB,
                    WB, &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int q = warp % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // this warpgroup's MT tiles of 8 x 8 pixels: tile j at (oy + 8j, ox)
  const int oy = a.tall ? 8 * MT * wg : 0;
  const int ox = a.tall ? 0 : 8 * wg;
  if (a.resident) wait_or_trap(wbar, 0);

  Acc<NB> part[MT];
  float sum[MT][NB / 2];
  int k = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    int r = tile;
    const int x0 = (r % a.tiles_x) * tw;
    r /= a.tiles_x;
    const int y0 = (r % a.tiles_y) * th;
    r /= a.tiles_y;
    const int z = r % a.Z;
    const int bz = r / a.Z;
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) sum[j][i] = 0.f;

    for (int it = 0; it < n_iters; ++it, ++k) {
      const int s = k % S;
      wait_or_trap(&full[s], (k / S) & 1);
      const unsigned char* slot = ring + s * slot_bytes;
      const unsigned char* w =
          a.resident ? w_res + it * WB : slot + 2 * pitch;
      // A: halo rows 16 hx bytes apart, the chunk's second plane `pitch`
      // on (a half chunk: the plane of zeros); B: k halves 128 bytes
      // apart, n groups 256
      const uint32_t lbo = (it / 3) * KC + CK < a.Cin
                               ? pitch
                               : static_cast<uint32_t>(zeros - slot);
      const uint64_t da =
          smem_desc(slot + (oy * hx + ox) * 16, lbo, hx * 16);
      const uint64_t db = smem_desc(w, 128, 256);
#pragma unroll
      for (int j = 0; j < MT; ++j) fence_acc(part[j]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          wgmma_bf16_ss(part[j], da + (8 * j + tap / 3) * hx + tap % 3,
                        db + tap * (KC * NB * 2 / 16), tap > 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < MT; ++j) fence_acc(part[j]);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) sum[j][i] += part[j].r[i];
    }

#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int yb = y0 + oy + 8 * j + 2 * q;
      const int xo = x0 + ox + g;
      store_tile<NB>(a, sum[j],
                     ((static_cast<int64_t>(bz) * a.Z + z) * a.Y + yb) *
                             a.X + xo,
                     yb, xo, nc * NB, t);
    }
  }
}

struct Plan {
  int resident, stages, smem, min_blocks;
};

template <int NB>
Plan plan(int Cin, int tall) {
  const int n_iters = (Cin + KC - 1) / KC * 3;
  const int wb = Tile<NB>::W_BYTES;
  const int wall = n_iters * wb;
  const int halo = 2 * plane_pitch(Tile<NB>::MT, tall);
  const int zeros = Cin % KC ? plane_pitch(Tile<NB>::MT, tall) : 0;
  const int bars = (2 * MAX_STAGES + 1) * 8;
  const int budget =
      SM_SMEM / Tile<NB>::MIN_BLOCKS - BLOCK_RESERVED - bars - zeros;
  Plan p;
  p.min_blocks = Tile<NB>::MIN_BLOCKS;
  p.resident = wall + 3 * halo <= budget;
  const int slot = halo + (p.resident ? 0 : wb);
  p.stages = (budget - (p.resident ? wall : 0)) / slot;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  p.smem = (p.resident ? wall : 0) + p.stages * slot + zeros +
           (2 * p.stages + 1) * 8;
  return p;
}

template <int NB>
int launch(const CUtensorMap& map, Args a, int B, cudaStream_t stream) {
  const Plan p = plan<NB>(a.Cin, a.tall);
  if (p.stages < 2) return cudaErrorInvalidConfiguration;
  a.resident = p.resident;
  a.stages = p.stages;
  cudaError_t e = cudaFuncSetAttribute(
      conv_bf16_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int occ = 0, dev = 0, n_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, conv_bf16_kernel<NB>, THREADS, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int th = tile_h(Tile<NB>::MT, a.tall), tw = tile_w(a.tall);
  a.tiles_x = (a.X + tw - 1) / tw;
  a.tiles_y = (a.Y + th - 1) / th;
  const int64_t tiles = static_cast<int64_t>(B) * a.Z * a.tiles_y * a.tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  a.n_tiles = static_cast<int>(tiles);
  const int n_chunks = (a.Cout + NB - 1) / NB;
  if (n_chunks > 65535) return cudaErrorInvalidValue;
  int64_t gx = (static_cast<int64_t>(n_sm) * occ + n_chunks - 1) / n_chunks;
  if (gx > tiles) gx = tiles;
  if (gx < 1) gx = 1;
  dim3 grid(static_cast<unsigned>(gx), n_chunks);
  conv_bf16_kernel<NB><<<grid, THREADS, p.smem, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B volumes x of (Z, Y, X, Cin) bf16, contiguous, Cin % 8 == 0, Cout % 8 ==
// 0, into y (B, Z, Y, X, Cout): f32 in mode 0, bf16 in mode 1; wp the
// weights packed for the N tile nb (8, 16, 32, 64 or 128,
// ops/hopper_conv.py::pack_weights_bf16); b the f32 bias; mode 1 also takes
// BatchNorm's f32 mean, inv and beta per channel (else null); act 0 none, 1
// ReLU, 2 LeakyReLU (mode 1 only); tall selects the (16 MT) x 8 tile;
// dims, strides (bytes) and box describe the bf16 5-D (c, x, y, z, b)
// tensor map of one halo plane of that tile (ops/hopper_conv.py::
// tma_halo_args_bf16).  Returns cudaGetLastError() after the launch, -1
// when the tensor map cannot be made, -2 for an unsupported nb.
extern "C" int conv3x3x3_wgmma_bf16(
    const void* x, const void* wp, const void* b, const void* mean,
    const void* inv, const void* beta, void* y, int B, int Z, int Y, int X,
    int Cin, int Cout, int nb, int tall, int mode, int act,
    const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
    void* stream) {
  CUtensorMap map;
  if (!encode_map_5d(&map, x, dims, strides, box,
                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return -1;
  Args a{};
  a.wp = wp;
  a.bias = static_cast<const float*>(b);
  a.mean = static_cast<const float*>(mean);
  a.inv = static_cast<const float*>(inv);
  a.beta = static_cast<const float*>(beta);
  a.y = y;
  a.Z = Z;
  a.Y = Y;
  a.X = X;
  a.Cin = Cin;
  a.Cout = Cout;
  a.tall = tall;
  a.mode = mode;
  a.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8: return launch<8>(map, a, B, s);
    case 16: return launch<16>(map, a, B, s);
    case 32: return launch<32>(map, a, B, s);
    case 64: return launch<64>(map, a, B, s);
    case 128: return launch<128>(map, a, B, s);
    default: return -2;
  }
}

// The pipeline the kernel takes for N tile nb, c_in channels and the tile
// orientation: out[0] resident weights (1) or streamed per stage (0),
// out[1] the ring's stages, out[2] the dynamic shared memory of a block in
// bytes, out[3] the blocks an SM is meant to hold, out[4] the 8 x 8 pixel
// tiles a warpgroup takes.  Returns 0, or -2 for an unsupported nb.
extern "C" int conv3x3x3_wgmma_bf16_plan(int nb, int cin, int tall,
                                         int* out) {
  Plan p;
  int mt;
  switch (nb) {
    case 8: p = plan<8>(cin, tall); mt = Tile<8>::MT; break;
    case 16: p = plan<16>(cin, tall); mt = Tile<16>::MT; break;
    case 32: p = plan<32>(cin, tall); mt = Tile<32>::MT; break;
    case 64: p = plan<64>(cin, tall); mt = Tile<64>::MT; break;
    case 128: p = plan<128>(cin, tall); mt = Tile<128>::MT; break;
    default: return -2;
  }
  out[0] = p.resident;
  out[1] = p.stages;
  out[2] = p.smem;
  out[3] = p.min_blocks;
  out[4] = mt;
  return 0;
}
