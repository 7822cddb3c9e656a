// SAME 3x3x3 convolution + bias (+ReLU) on Hopper's tensor cores: an implicit
// GEMM in three TF32 passes, on a batch of channels-last f32 volumes.
//
// Replaces: 3deecelltracker_tpu/ops/pallas_conv.py::conv3x3x3_fused, which
// computes relu(conv_same(x, w) + b) for x (z, y, x, c_in), w DHWIO
// (3, 3, 3, c_in, c_out), b (c_out,), with f32 accumulation, as 9 (dy, dx)
// dots per tile with the 3 z-taps packed into K.  It takes every 3x3x3 layer
// with c_in % 8 == 0 and c_out % 8 == 0 (all of the StarDist backbone's and
// the legacy U-Net's but the c_in = 1 stems, which stay on csrc/conv3x3x3.cu);
// the U-Net's tile batch is one launch, folded into grid.z.
//
// What bounds it on an H100: the tensor cores.  f32 accuracy costs three TF32
// products per multiply (below), so a layer's least time is 3 x its FLOP at
// 495 TFLOP/s dense TF32 (the backbone at the bench geometry: 3 x 299.2 GFLOP
// per volume = 1.81 ms), against 4.47 ms for its FLOP at the 67 TFLOP/s f32
// CUDA-core peak.  Narrow layers (c_out 8, 16) are bound by their bytes.
//
// Numerics: each operand v is split into hi = tf32(v) (cvt.rna) and
// lo = v - hi; the sum hi*hi + hi*lo + lo*hi keeps ~22 bits of every product
// (the lo*lo term, ~2^-22 relative, is dropped).  The wgmma accumulator
// truncates each sum it adds in, an error biased toward zero that grows with
// K, so it holds one pipeline stage's partial sum (27 wgmmas) only, and the
// partials are added in registers with f32 rounding: results stay within
// f32 summation-order noise of a true f32 conv.  One TF32 pass keeps ~11
// bits, tens of times over the parity budget.  The weights come pre-split
// (hi, lo) from ops/hopper_conv.py; the activations are split in registers.
//
// Design.  GEMM: M = output pixels, N = c_out (a tile of NB = 8..128
// channels per block), K = 27 taps x c_in in steps of 8 channels (wgmma
// m64nNBk8 tf32).  A block owns a 16 (x) by 8 (y) pixel tile at one z of one
// volume: two warpgroups of 64 pixels each (warp w of warpgroup q takes the
// tile's row 4q + w, its lanes x and x + 8).  Thread 0 streams pipeline
// stages through a ring of STAGES buffers behind full/empty mbarriers,
// refilling a buffer as soon as both warpgroups have released it, while the
// next stages, already in flight, are computed on.  A stage is one
// (8-channel chunk, z-tap): the (TY + 2, TX + 2, 8) input halo plane, one
// TMA copy from a 5-D tensor map over the (c, x, y, z, b) batch (TMA's
// out-of-bounds zero fill is the SAME padding, and z and b are separate
// dimensions, so a z-halo never reads the next volume), and the stage's 9
// taps of packed hi/lo weights, one bulk copy.  Not a chunk's whole 3-z
// window: its 27 taps of weights take 221 KB at NB = 128, more than the
// 227 KB of shared memory a block has leaves room for beside the halo.
// Consumers read their A fragment for each of the 9 (dy, dx) taps straight
// from the halo plane at the tap's offset (a shifted window costs nothing),
// split it into hi/lo in registers, and issue three wgmmas per tap
// (A_lo.B_hi, A_hi.B_lo, A_hi.B_hi) with B from shared memory in the
// canonical K-major, no-swizzle core-matrix layout.  Within a K step the 8
// fragment columns map to channels (0, 2, 4, 6, 1, 3, 5, 7), so that a
// thread's two channels of one pixel are one float2 load; the weights are
// packed in the same order.  The epilogue adds the bias, applies the ReLU
// and stores channels-last, masked at the ragged y/x edge and past c_out.
//
// The bf16 form (JAX's compute_dtype=bfloat16) is a kernel of its own,
// csrc/conv3x3x3_wgmma_bf16.cu.
//
// The building blocks (mbarriers, TMA, the hi/lo split, wgmma, the
// tensor-map encoder) are in hopper_common.cuh, shared with csrc/ladder.cu's
// nine-view conv.

#include "hopper_common.cuh"

namespace {

constexpr int TX = 16;                   // output tile: x
constexpr int TY = 8;                    // output tile: y (4 rows a warpgroup)
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int CK = 8;                    // channels per halo plane (k8)
constexpr int THREADS = 256;             // two warpgroups
constexpr int HALO_FLOATS = HY * HX * CK;
constexpr int HALO_BYTES = HALO_FLOATS * 4;      // 5760 = 45 x 128

// the pipeline for N tile NB
template <int NB>
struct Form {
  // channels per stage, and the 8-channel halo planes that hold them
  static constexpr int CKS = CK;
  static constexpr int HALOS = CKS / CK;
  // packed weights of one stage, in bytes: [tap 9][hi, lo][CK * NB] f32
  // (ops/hopper_conv.py)
  static constexpr int W_BYTES = 9 * 2 * CK * NB * 4;
  static constexpr int STAGES = NB >= 128 ? 2 : (NB >= 64 ? 3 : 4);
  // narrow tiles fit two blocks on an SM (<= 128 registers a thread)
  static constexpr int BLOCKS_PER_SM = NB <= 32 ? 2 : 1;
  static constexpr int SMEM =
      STAGES * (W_BYTES + HALOS * HALO_BYTES) + 2 * STAGES * 8;
};

template <int NB>
__global__ void __launch_bounds__(THREADS, (Form<NB>::BLOCKS_PER_SM))
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const void* __restrict__ wp, const float* __restrict__ bias,
                  float* __restrict__ y, int Z, int Y, int X, int Cin,
                  int Cout, int tiles_x, int n_chunks, int relu) {
  using F = Form<NB>;
  constexpr int S = F::STAGES;
  constexpr int WB = F::W_BYTES;
  constexpr int HS = F::HALOS * HALO_FLOATS;     // halo floats of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w_s = smem;
  float* h_s = reinterpret_cast<float*>(smem + S * WB);
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + S * HS);
  uint64_t* empty = full + S;

  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int z = blockIdx.y;
  const int bz = blockIdx.z / n_chunks;
  const int nc = blockIdx.z % n_chunks;
  // stage = (channel chunk, z-tap)
  const int n_iters = (Cin + F::CKS - 1) / F::CKS * 3;
  const unsigned char* src =
      static_cast<const unsigned char*>(wp) +
      static_cast<int64_t>(nc) * n_iters * WB;

  // thread 0 issues stage `it`'s copies into buffer it % S: its halo
  // planes and its weights
  auto load = [&](int it) {
    const int s = it % S;
    const int c0 = (it / 3) * F::CKS;
    const int halos = min(F::HALOS, (Cin - c0) / CK);
    mbar_expect_tx(&full[s], WB + halos * HALO_BYTES);
    for (int hf = 0; hf < halos; ++hf)
      tma_halo(h_s + s * HS + hf * HALO_FLOATS, &xmap, &full[s],
               c0 + hf * CK, x0 - 1, y0 - 1, z + it % 3 - 1, bz);
    bulk_load(w_s + s * WB, src + static_cast<int64_t>(it) * WB, WB,
              &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < S && it < n_iters; ++it) load(it);
  }
  __syncthreads();

  const int row = threadIdx.x / 32;   // 4 * warpgroup + warp: the tile's y
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // the tensor cores truncate when they add into the accumulator, so its
  // error would grow with K in one direction: each stage's partial sum
  // starts afresh in `part` and is added to `sum` with f32 rounding
  Acc<NB> part;
  float sum[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) sum[i] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const float* h = h_s + s * HS;
    // A fragments of the 9 taps: a[0] (pixel g, k t), a[1] (pixel g + 8,
    // k t), a[2] (pixel g, k t + 4), a[3] (pixel g + 8, k t + 4); column
    // k holds channel 2 (k % 4) + k / 4
    uint32_t a_hi[9][4], a_lo[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* p = h + ((row + tap / 3) * HX + g + tap % 3) * CK + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * CK);
      split_tf32(v0.x, a_hi[tap][0], a_lo[tap][0]);
      split_tf32(v1.x, a_hi[tap][1], a_lo[tap][1]);
      split_tf32(v0.y, a_hi[tap][2], a_lo[tap][2]);
      split_tf32(v1.y, a_hi[tap][3], a_lo[tap][3]);
    }
    const float* w = reinterpret_cast<const float*>(w_s + s * WB);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t d_hi = b_desc(w + (2 * tap) * CK * NB);
      const uint64_t d_lo = b_desc(w + (2 * tap + 1) * CK * NB);
      wgmma_tf32(part, a_lo[tap], d_hi, tap > 0);
      wgmma_tf32(part, a_hi[tap], d_lo, 1);
      wgmma_tf32(part, a_hi[tap], d_hi, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(part);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) sum[i] += part.r[i];
    // refill buffer s once both warpgroups have released it
    if (threadIdx.x == 0 && it + S < n_iters) {
      mbar_wait(&empty[s], (it / S) & 1);
      load(it + S);
    }
  }

  // sum[4i + 2h + e] is pixel g + 8h, channel 8i + 2t + e of the tile
  const int yo = y0 + row;
  if (yo >= Y) return;
  const int n0 = nc * NB;
#pragma unroll
  for (int i = 0; i < NB / 8; ++i) {
    const int n = n0 + 8 * i + 2 * t;
    if (n >= Cout) continue;   // Cout is even: n + 1 < Cout too
    const float b0 = bias[n];
    const float b1 = bias[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xo = x0 + g + 8 * h;
      if (xo >= X) continue;
      float v0 = sum[4 * i + 2 * h] + b0;
      float v1 = sum[4 * i + 2 * h + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const int64_t off =
          (((static_cast<int64_t>(bz) * Z + z) * Y + yo) * X + xo) * Cout + n;
      *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
    }
  }
}


template <int NB>
int launch(const CUtensorMap& map, const void* wp, const float* b, float* y,
           int B, int Z, int Y, int X, int Cin, int Cout, int relu,
           cudaStream_t stream) {
  constexpr int SMEM = Form<NB>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (X + TX - 1) / TX;
  const int n_chunks = (Cout + NB - 1) / NB;
  dim3 grid(tiles_x * ((Y + TY - 1) / TY), Z, B * n_chunks);
  conv_wgmma_kernel<NB><<<grid, THREADS, SMEM, stream>>>(
      map, wp, b, y, Z, Y, X, Cin, Cout, tiles_x, n_chunks, relu);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* wp, const void* b, void* y, int B,
             int Z, int Y, int X, int Cin, int Cout, int nb, int relu,
             const uint64_t* dims, const uint64_t* strides,
             const uint32_t* box, void* stream) {
  CUtensorMap map;
  if (!encode_map_5d(&map, x, dims, strides, box)) return -1;
  const float* bb = static_cast<const float*>(b);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8:
      return launch<8>(map, wp, bb, out, B, Z, Y, X, Cin, Cout, relu, s);
    case 16:
      return launch<16>(map, wp, bb, out, B, Z, Y, X, Cin, Cout, relu, s);
    case 32:
      return launch<32>(map, wp, bb, out, B, Z, Y, X, Cin, Cout, relu, s);
    case 64:
      return launch<64>(map, wp, bb, out, B, Z, Y, X, Cin, Cout, relu, s);
    case 128:
      return launch<128>(map, wp, bb, out, B, Z, Y, X, Cin, Cout, relu, s);
    default: return -2;
  }
}

int smem_of(int nb) {
  switch (nb) {
    case 8: return Form<8>::SMEM;
    case 16: return Form<16>::SMEM;
    case 32: return Form<32>::SMEM;
    case 64: return Form<64>::SMEM;
    case 128: return Form<128>::SMEM;
    default: return -2;
  }
}

}  // namespace

// B volumes of (Z, Y, X, Cin), contiguous, Cin % 8 == 0, Cout % 8 == 0; wp
// the packed hi/lo weights for the N tile nb (8, 16, 32, 64 or 128); dims,
// strides (bytes) and box describe the 5-D (c, x, y, z, b) tensor map
// (ops/hopper_conv.py::tma_halo_args).  Z and B * ceil(Cout / nb) must fit
// grid.y and grid.z (65535): the wrapper splits larger batches.  Returns
// cudaGetLastError() after the launch, or -1 when the tensor map cannot be
// made and -2 for an unsupported nb.
extern "C" int conv3x3x3_wgmma_f32(const void* x, const void* wp,
                                   const void* b, void* y, int B, int Z,
                                   int Y, int X, int Cin, int Cout, int nb,
                                   int relu, const uint64_t* dims,
                                   const uint64_t* strides,
                                   const uint32_t* box, void* stream) {
  return dispatch(x, wp, b, y, B, Z, Y, X, Cin, Cout, nb, relu, dims,
                  strides, box, stream);
}

// the dynamic shared memory a block of the N tile nb takes, in bytes (-2
// for an unsupported nb)
extern "C" int conv3x3x3_wgmma_smem_bytes(int nb) { return smem_of(nb); }
