// The conv probe's kernel ladder: three f32 kernels that time the building
// blocks of the backbone's 3x3x3 conv at its hot shape, (24, 204, 84) voxels
// with 32 input channels.
//
// Replaces: scripts/probe_conv_fast.py::pallas_ladder, the Pallas constructs
// A (a pipelined block passthrough, x + 1), B and B2 (an in-kernel channel
// product, einsum("zyxc,co->zyxo"), once on the 4-D block and once after a
// reshape to 2-D: the same function) and C (the conv as nine shifted-view
// products of a z-packed volume, + bias, ReLU).  Entry E of that ladder is
// the backbone conv kernel, csrc/conv3x3x3_wgmma.cu.
//
// What bounds each on an H100 (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores,
// 495 TFLOP/s dense TF32 on the tensor cores), and what the design does:
//
// - add_one moves 2 x 52.6 MB at the probe shape and does one add per float:
//   bytes, 31.4 us.  The stream is twice the size of L2, so the design is
//   about keeping enough bytes in flight and out of L2's way: a grid of the
//   card's resident blocks (occupancy API, asked once per device by the
//   wrapper, ops/ladder.py::add_one_plan) strides over the float4s, each
//   thread issuing ADD_ONE_UNROLL (8) independent 16-byte loads before its
//   stores, all with evict-first hints (__ldcs / __stcs: nothing of the
//   stream is read again).  With 4 loads in flight, or without the hints,
//   it ran slower than PyTorch's own x + 1.  The float4s past the last
//   whole group of 8 run one a thread, the last n % 4 floats on threads 0-2
//   of block 0; x or y off a 16-byte line takes a scalar kernel.

// - pointwise_matmul: M = 411,264 voxels, K = N = 32 is 0.84 GFLOP against
//   105 MB, 8 FLOP per byte: bytes, 31.4 us.  At 8 FLOP a byte the CUDA
//   cores' f32 FMAs keep up with the memory (12.6 us of FMA work at their
//   peak), so the tensor cores would buy nothing; the design is about the
//   stream.  Persistent blocks, one per SM, walk over M in tiles of 256
//   rows.  Thread 0 keeps up to four x tiles in flight (fewer where wide
//   rows fill shared memory), one 2-D TMA copy each behind a full mbarrier;
//   at c_in 32 a row is 128 bytes and the copy swizzles it (128-byte mode),
//   so a warp's float4 reads of 32 rows hit every bank once.  w sits in
//   shared memory for the block's life.  Each thread owns two rows and an
//   N tile's outputs in registers (one broadcast float4 of w feeds 8 FMAs),
//   writes them to a swizzled output tile, and thread 0 stores the tile
//   with a 2-D TMA copy while the next tile is computed (two output
//   buffers; a bulk group per store).  TMA's zero fill and clipping mask
//   the ragged last tile and an M below one tile.  Channel counts off the
//   16-byte rule are padded by the wrapper.  The host side remembers its
//   tensor maps and shared-memory attribute (cached_map_2d, allow_smem):
//   encoding them each call cost more host time than the kernel takes.
//
// - conv9view: 2 * M * 9 * 96 * c_out FLOP (22.7 GFLOP at c_out 32, 91 at
//   128).  f32 accuracy on the tensor cores costs three TF32 products per
//   multiply (hi*hi, hi*lo, lo*hi of hi = tf32(v), lo = v - hi), so its least
//   time is 3 x FLOP at 495 TFLOP/s: 0.138 / 0.551 ms (f32 on the CUDA cores:
//   0.339 / 1.358).  An implicit GEMM, M = output pixels, N = c_out in tiles
//   of NB (8..128), K = the nine views' 3 * c_in each: wgmma m64nNBk8 TF32,
//   A from registers, B (w9, split hi/lo and packed once per weight tensor
//   by ops/ladder.py) from shared memory in the canonical K-major
//   no-swizzle layout, with the fragment column order (0, 2, 4, 6, 1, 3, 5,
//   7) of csrc/conv3x3x3_wgmma.cu.  A block owns a 16 x 8 pixel tile at one
//   z (two warpgroups of 64 pixels).  Its input is x itself: for each
//   8-channel chunk one 5-D TMA copy brings the (3, 10, 18, 8) halo of the
//   three z-planes, TMA's zero fill being the SAME padding, so the z-packed
//   volume vz of the formulation is never formed; a view (dy, dx) and a
//   z-plane dz are offsets into these resident planes.  The halo holds a
//   group of one, two or four chunks (all of c_in 32: 69 KB).  The weights
//   stream through a ring of 4 stages behind full/empty mbarriers, one
//   stage per (view, z-plane): the group's chunks x (hi, lo) x 8 x NB (32
//   KB at NB 128; a view's whole K would not fit twice beside the halo).
//   Stages run view by view, z-plane by z-plane, as the formulation sums.
//   The tensor cores truncate what they add into the accumulator, so a
//   partial sum starts afresh every two stages (24 wgmmas at most, below
//   csrc/conv3x3x3_wgmma.cu's 27) and is added to the total in registers
//   at f32; pairing halves the drains that a stage each would cost.  The
//   group's chunk count is a template argument, and a window's barrier
//   waits and fragment splits all come before its first wgmma, so its
//   wgmmas issue back to back with no control flow between them (with a
//   branch per chunk and a wait between the pair's stages the kernel took
//   15% longer).  Thread 0 refills the pair's buffers once both
//   warpgroups have released them.  Bias and ReLU are the epilogue; stores
//   are channels-last, 32 contiguous bytes a pixel per warp instruction.

#include <type_traits>

#include "hopper_common.cuh"

namespace {

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 2-D tensor map's box at (c, row) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// src into the 2-D tensor map's box at (c, row); out-of-bounds parts are
// not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most one store group still reading shared memory
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- A: x + 1 --------------------------------------------------------------

constexpr int ADD_ONE_THREADS = 256;
constexpr int ADD_ONE_UNROLL = 8;  // float4 loads in flight per thread

__device__ __forceinline__ float4 plus_one(float4 v) {
  v.x += 1.f;
  v.y += 1.f;
  v.z += 1.f;
  v.w += 1.f;
  return v;
}

// y4 = x4 + 1 over n4 float4s: thread t of T takes float4s t, t + T, ...,
// ADD_ONE_UNROLL of them at a time (every load before the first store,
// evict-first) while a whole group fits, then one at a time with default
// loads and stores; then threads 0..tail-1 of block 0 take the floats past
// the float4s (xt, yt).  On the card this loop ran faster than the same
// with the last group predicated in place of the one-at-a-time loop.
__global__ void __launch_bounds__(ADD_ONE_THREADS)
add_one_kernel(const float4* x, float4* y, int64_t n4, const float* xt,
               float* yt, int tail) {
  const int64_t T = static_cast<int64_t>(gridDim.x) * ADD_ONE_THREADS;
  int64_t i = blockIdx.x * static_cast<int64_t>(ADD_ONE_THREADS) +
              threadIdx.x;
  for (; i + (ADD_ONE_UNROLL - 1) * T < n4; i += ADD_ONE_UNROLL * T) {
    float4 v[ADD_ONE_UNROLL];
#pragma unroll
    for (int u = 0; u < ADD_ONE_UNROLL; ++u) v[u] = __ldcs(x + i + u * T);
#pragma unroll
    for (int u = 0; u < ADD_ONE_UNROLL; ++u)
      __stcs(y + i + u * T, plus_one(v[u]));
  }
  for (; i < n4; i += T) y[i] = plus_one(x[i]);
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail)
    yt[threadIdx.x] = xt[threadIdx.x] + 1.f;
}

// y = x + 1 over n floats one at a time, t, t + T, ...: x or y off a
// 16-byte line.
__global__ void __launch_bounds__(ADD_ONE_THREADS)
add_one_scalar_kernel(const float* x, float* y, int64_t n) {
  const int64_t T = static_cast<int64_t>(gridDim.x) * ADD_ONE_THREADS;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(ADD_ONE_THREADS) +
                   threadIdx.x;
       i < n; i += T)
    y[i] = x[i] + 1.f;
}

// ---- B: per-voxel channel product -----------------------------------------

constexpr int PW_THREADS = 128;
constexpr int PW_ROWS = 256;         // rows per tile: two per thread
constexpr int PW_ALIGN = 1024;       // the 128-byte swizzle's period
constexpr int PW_SMEM_MAX = 232448;  // an H100 block's shared memory
constexpr int PW_STAGES = 4;         // x tiles in flight, at most

// byte offset of 16-byte chunk q of row r in a tile of row_bytes-byte rows
// as TMA lays it down: 128-byte rows are swizzled (chunk q of row r at
// chunk q ^ (r % 8)), other widths are not
__device__ __forceinline__ uint32_t tile_off(int r, int q, int row_bytes) {
  const uint32_t off = static_cast<uint32_t>(r * row_bytes + q * 16);
  return row_bytes == 128 ? off ^ ((r & 7) << 4) : off;
}

// rows m of the block's tiles (blockIdx.x, + gridDim.x, ...): y[m, :] =
// x[m, :Cp] @ w (Cp, Cout), Cp % 4 == 0, Cout % 4 == 0, in N tiles of NB
template <int NB>
__global__ void __launch_bounds__(PW_THREADS)
pointwise_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const float* __restrict__ w, int Cp, int Cout, int n_tiles,
                 int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (PW_ALIGN - smem_u32(smem_raw) % PW_ALIGN) % PW_ALIGN;
  const int x_bytes = PW_ROWS * Cp * 4;
  constexpr int O_BYTES = PW_ROWS * NB * 4;
  const int n_nt = (Cout + NB - 1) / NB;
  const int wcols = n_nt * NB;
  unsigned char* x_s = smem;
  unsigned char* o_s = x_s + stages * x_bytes;
  float* w_s = reinterpret_cast<float*>(o_s + 2 * O_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + Cp * wcols);

  const int tid = threadIdx.x;
  const int first = blockIdx.x;
  const int step = gridDim.x;
  const int mine = first < n_tiles ? (n_tiles - first + step - 1) / step : 0;
  // thread 0 issues the x tile of the block's i-th tile into buffer i % S
  auto load = [&](int i) {
    const int s = i % stages;
    mbar_expect_tx(&full[s], x_bytes);
    tma_load_2d(x_s + s * x_bytes, &xmap, &full[s], 0,
                (first + i * step) * PW_ROWS);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < stages && i < mine; ++i) load(i);
  }
  for (int i = tid; i < Cp * wcols; i += PW_THREADS) {
    const int c = i / wcols;
    const int n = i % wcols;
    w_s[i] = n < Cout ? w[static_cast<int64_t>(c) * Cout + n] : 0.f;
  }
  __syncthreads();

  int k = 0;   // output tiles stored so far: buffer k % 2
  for (int i = 0; i < mine; ++i) {
    const int s = i % stages;
    const int m0 = (first + i * step) * PW_ROWS;
    mbar_wait(&full[s], (i / stages) & 1);
    const unsigned char* xt = x_s + s * x_bytes;
    for (int nt = 0; nt < n_nt; ++nt, ++k) {
      unsigned char* ot = o_s + (k & 1) * O_BYTES;
      // the store that last read this buffer, two stores ago, is done
      if (tid == 0) bulk_wait_read_1();
      __syncthreads();
      float acc[2][NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[0][j] = acc[1][j] = 0.f;
      for (int q = 0; q < Cp / 4; ++q) {
        const float4 v0 =
            *reinterpret_cast<const float4*>(xt + tile_off(tid, q, Cp * 4));
        const float4 v1 = *reinterpret_cast<const float4*>(
            xt + tile_off(tid + PW_THREADS, q, Cp * 4));
        const float a0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float a1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4* wr = reinterpret_cast<const float4*>(
              w_s + (4 * q + e) * wcols + nt * NB);
#pragma unroll
          for (int j = 0; j < NB / 4; ++j) {
            const float4 ww = wr[j];   // one address for the warp: broadcast
            acc[0][4 * j + 0] = fmaf(a0[e], ww.x, acc[0][4 * j + 0]);
            acc[0][4 * j + 1] = fmaf(a0[e], ww.y, acc[0][4 * j + 1]);
            acc[0][4 * j + 2] = fmaf(a0[e], ww.z, acc[0][4 * j + 2]);
            acc[0][4 * j + 3] = fmaf(a0[e], ww.w, acc[0][4 * j + 3]);
            acc[1][4 * j + 0] = fmaf(a1[e], ww.x, acc[1][4 * j + 0]);
            acc[1][4 * j + 1] = fmaf(a1[e], ww.y, acc[1][4 * j + 1]);
            acc[1][4 * j + 2] = fmaf(a1[e], ww.z, acc[1][4 * j + 2]);
            acc[1][4 * j + 3] = fmaf(a1[e], ww.w, acc[1][4 * j + 3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NB / 4; ++j)
          *reinterpret_cast<float4*>(
              ot + tile_off(tid + h * PW_THREADS, j, NB * 4)) =
              make_float4(acc[h][4 * j], acc[h][4 * j + 1],
                          acc[h][4 * j + 2], acc[h][4 * j + 3]);
      fence_proxy_async();   // the writes, to the TMA store's proxy
      __syncthreads();       // every thread is done with x_t and o_t
      if (tid == 0) {
        tma_store_2d(&ymap, ot, nt * NB, m0);
        bulk_commit();
        if (nt == n_nt - 1 && i + stages < mine) load(i + stages);
      }
    }
  }
  if (tid == 0) bulk_wait_read_0();   // shared memory outlives the stores
}

// shared memory of pointwise_kernel<NB> with `stages` x buffers, and the
// 1 KB the kernel may spend to align them
template <int NB>
int pw_smem_bytes(int Cp, int Cout, int stages) {
  const int wcols = (Cout + NB - 1) / NB * NB;
  return PW_ALIGN + stages * PW_ROWS * Cp * 4 + 2 * PW_ROWS * NB * 4 +
         Cp * wcols * 4 + stages * 8;
}

// the x tiles in flight: PW_STAGES, fewer where wide rows would overflow
// shared memory (2 at least), and the block's shared memory with them
template <int NB>
int pw_smem_fit(int Cp, int Cout) {
  int stages = PW_STAGES;
  while (stages > 2 && pw_smem_bytes<NB>(Cp, Cout, stages) > PW_SMEM_MAX)
    --stages;
  return stages;
}

// a 2-D f32 tensor map over a contiguous (rows, cols) matrix with a box of
// (box_cols, PW_ROWS), 128-byte swizzled where a box row is 128 bytes
bool encode_map_2d(CUtensorMap* map, const void* p, int cols, long long rows,
                   int box_cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), PW_ROWS};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p),
                dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_map_2d, remembering the last maps made on this host thread: a map
// is a function of its pointer, shape and box alone, and back-to-back calls
// get the same buffers from PyTorch's allocator, so most calls skip
// cuTensorMapEncodeTiled (several microseconds of a call that takes ~45 on
// the card)
bool cached_map_2d(CUtensorMap* map, const void* p, int cols, long long rows,
                   int box_cols) {
  struct Key {
    const void* p;
    int cols;
    long long rows;
    int box_cols;
  };
  constexpr int N = 8;
  thread_local Key keys[N] = {};
  thread_local CUtensorMap maps[N];
  thread_local int next = 0;
  for (int i = 0; i < N; ++i) {
    if (keys[i].p == p && keys[i].cols == cols && keys[i].rows == rows &&
        keys[i].box_cols == box_cols) {
      *map = maps[i];
      return true;
    }
  }
  if (!encode_map_2d(map, p, cols, rows, box_cols)) return false;
  keys[next] = Key{p, cols, rows, box_cols};
  maps[next] = *map;
  next = (next + 1) % N;
  return true;
}

constexpr int DEVICES = 64;

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) on the
// current device, skipped where `allowed` (the kernel's own, per device)
// says a call has set as much already
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&allowed)[DEVICES]) {
  int dev = 0;
  const cudaError_t d = cudaGetDevice(&dev);
  if (d != cudaSuccess) return d;
  if (dev < DEVICES && allowed[dev] >= bytes) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < DEVICES) allowed[dev] = bytes;
  return e;
}

template <int NB>
int launch_pointwise(const void* x, const float* w, void* y, long long M,
                     int Cp, int Cout, int blocks, cudaStream_t stream) {
  const int stages = pw_smem_fit<NB>(Cp, Cout);
  const int smem = pw_smem_bytes<NB>(Cp, Cout, stages);
  if (smem > PW_SMEM_MAX) return -3;
  CUtensorMap xmap, ymap;
  if (!cached_map_2d(&xmap, x, Cp, M, Cp) ||
      !cached_map_2d(&ymap, y, Cout, M, NB))
    return -1;
  static int allowed[DEVICES] = {};
  const cudaError_t e = allow_smem(pointwise_kernel<NB>, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = static_cast<int>((M + PW_ROWS - 1) / PW_ROWS);
  pointwise_kernel<NB><<<blocks, PW_THREADS, smem, stream>>>(
      xmap, ymap, w, Cp, Cout, n_tiles, stages);
  return static_cast<int>(cudaGetLastError());
}

// ---- C: the nine-view conv on the tensor cores -----------------------------

constexpr int C9_TX = 16;                    // output tile: x
constexpr int C9_TY = 8;                     // output tile: y
constexpr int C9_HX = C9_TX + 2;
constexpr int C9_HY = C9_TY + 2;
constexpr int C9_CK = 8;                     // channels per K step (k8)
constexpr int C9_THREADS = 256;              // two warpgroups
constexpr int C9_HALO = 3 * C9_HY * C9_HX * C9_CK;   // a chunk's 3 z-planes
constexpr int C9_VIEW_STAGES = 27;           // (view, z-plane) per group
constexpr int C9_STAGES = 4;                 // the weights' ring

template <int NB>
__host__ __device__ constexpr int c9_blocks_per_sm() {
  return NB <= 32 ? 2 : 1;
}

// floats of one weight stage: the group's chunks x (hi, lo) x (8 k, NB n)
template <int NB>
__host__ __device__ constexpr int c9_stage_floats(int gc) {
  return gc * 2 * C9_CK * NB;
}

template <int NB>
int c9_smem_bytes(int gc) {
  return (C9_STAGES * c9_stage_floats<NB>(gc) + gc * C9_HALO) * 4 +
         (2 * C9_STAGES + 2) * 8;
}

// y (Z, Y, X, Cout) = relu(sum over views (dy, dx) and z-planes dz of the
// view's pixels times w9[dy, dx, dz * Cp : (dz + 1) * Cp] + b), for x
// (Z, Y, X, Cp) read through xmap, in halo groups of GC 8-channel chunks;
// wp holds the packed stages [N tile][group][view][dz]
// (ops/ladder.py::pack_w9_tc)
template <int NB, int GC>
__global__ void __launch_bounds__(C9_THREADS, c9_blocks_per_sm<NB>())
conv9view_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ wp,
                       const float* __restrict__ bias, float* __restrict__ y,
                       int Z, int Y, int X, int Cout, int tiles_x,
                       int n_groups) {
  constexpr int S = C9_STAGES;
  constexpr int WF = c9_stage_floats<NB>(GC);
  extern __shared__ __align__(128) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* h_s = w_s + S * WF;
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + GC * C9_HALO);
  uint64_t* empty = full + S;
  uint64_t* hfull = empty + S;
  uint64_t* hempty = hfull + 1;

  const int x0 = (blockIdx.x % tiles_x) * C9_TX;
  const int y0 = (blockIdx.x / tiles_x) * C9_TY;
  const int z = blockIdx.y;
  const int nt = blockIdx.z;
  const int n_iters = n_groups * C9_VIEW_STAGES;
  const float* src = wp + static_cast<int64_t>(nt) * n_iters * WF;

  // thread 0 issues weight stage `it` into buffer it % S, and group g's
  // halo (one copy per chunk: channels, x, y and the three z-planes)
  auto load_w = [&](int it) {
    const int s = it % S;
    mbar_expect_tx(&full[s], WF * 4);
    bulk_load(w_s + s * WF, src + static_cast<int64_t>(it) * WF, WF * 4,
              &full[s]);
  };
  auto load_halo = [&](int grp) {
    mbar_expect_tx(hfull, GC * C9_HALO * 4);
    for (int j = 0; j < GC; ++j)
      tma_halo(h_s + j * C9_HALO, &xmap, hfull, (grp * GC + j) * C9_CK,
               x0 - 1, y0 - 1, z - 1, 0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C9_THREADS);
    }
    mbar_init(hfull, 1);
    mbar_init(hempty, C9_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_halo(0);
    for (int it = 0; it < S && it < n_iters; ++it) load_w(it);
  }
  __syncthreads();

  const int row = threadIdx.x / 32;   // 4 * warpgroup + warp: the tile's y
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  Acc<NB> part;
  float sum[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) sum[i] = 0.f;

  // one partial sum over stages it .. it + N - 1 (N = 1 or 2, 24 wgmmas
  // at most): the tensor cores truncate what they add into the
  // accumulator, so each partial starts afresh and is added to `sum` at
  // f32.  Both stages' weights are waited for and both stages' fragments
  // split before the first wgmma, so the wgmmas issue back to back with no
  // control flow between them.  Chunk j's fragment: pixels (g, g + 8) of
  // the tile's row, shifted by the view, in z-plane dz; columns (t, t + 4)
  // hold channels (2t, 2t + 1), one float2
  auto window = [&](int it, auto n_tag) {
    constexpr int N = decltype(n_tag)::value;
    uint32_t a_hi[N][GC][4], a_lo[N][GC][4];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int r = (it + q) % C9_VIEW_STAGES;
      mbar_wait(&full[(it + q) % S], ((it + q) / S) & 1);
      const float* h = h_s +
                       (((r % 3) * C9_HY + row + r / 9) * C9_HX + g +
                        (r / 3) % 3) * C9_CK +
                       2 * t;
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        const float* p = h + j * C9_HALO;
        const float2 v0 = *reinterpret_cast<const float2*>(p);
        const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * C9_CK);
        split_tf32(v0.x, a_hi[q][j][0], a_lo[q][j][0]);
        split_tf32(v1.x, a_hi[q][j][1], a_lo[q][j][1]);
        split_tf32(v0.y, a_hi[q][j][2], a_lo[q][j][2]);
        split_tf32(v1.y, a_hi[q][j][3], a_lo[q][j][3]);
      }
    }
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float* w = w_s + ((it + q) % S) * WF;
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        const uint64_t d_hi = b_desc(w + (2 * j) * C9_CK * NB);
        const uint64_t d_lo = b_desc(w + (2 * j + 1) * C9_CK * NB);
        wgmma_tf32(part, a_lo[q][j], d_hi, q > 0 || j > 0);
        wgmma_tf32(part, a_hi[q][j], d_lo, 1);
        wgmma_tf32(part, a_hi[q][j], d_hi, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(part);
#pragma unroll
    for (int q = 0; q < N; ++q) mbar_arrive(&empty[(it + q) % S]);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) sum[i] += part.r[i];
    // refill the window's buffers once both warpgroups have released them
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        if (it + q + S < n_iters) {
          mbar_wait(&empty[(it + q) % S], ((it + q) / S) & 1);
          load_w(it + q + S);
        }
      }
    }
  };

  // per halo group: 13 pairs of (view, z-plane) stages, then its last
  // stage alone, so that no partial spans two groups
  for (int grp = 0; grp < n_groups; ++grp) {
    mbar_wait(hfull, grp & 1);
    const int it0 = grp * C9_VIEW_STAGES;
    for (int p = 0; p < C9_VIEW_STAGES / 2; ++p)
      window(it0 + 2 * p, std::integral_constant<int, 2>());
    window(it0 + C9_VIEW_STAGES - 1, std::integral_constant<int, 1>());
    mbar_arrive(hempty);
    if (threadIdx.x == 0 && grp + 1 < n_groups) {
      mbar_wait(hempty, grp & 1);
      load_halo(grp + 1);
    }
  }

  // sum[4i + 2h + e] is pixel g + 8h, channel 8i + 2t + e of the tile
  const int yo = y0 + row;
  if (yo >= Y) return;
  const int n0 = nt * NB;
#pragma unroll
  for (int i = 0; i < NB / 8; ++i) {
    const int n = n0 + 8 * i + 2 * t;
    if (n >= Cout) continue;
    const bool pair = n + 1 < Cout;
    const float b0 = bias[n];
    const float b1 = pair ? bias[n + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int xo = x0 + g + 8 * hh;
      if (xo >= X) continue;
      const float v0 = fmaxf(sum[4 * i + 2 * hh] + b0, 0.f);
      const float v1 = fmaxf(sum[4 * i + 2 * hh + 1] + b1, 0.f);
      const int64_t off =
          ((static_cast<int64_t>(z) * Y + yo) * X + xo) * Cout + n;
      if (Cout % 2 == 0) {
        *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
      } else {
        y[off] = v0;
        if (pair) y[off + 1] = v1;
      }
    }
  }
}

template <int NB, int GC>
int launch_conv9view(const CUtensorMap& map, const float* wp, const float* b,
                     float* y, int Z, int Y, int X, int Cout, int n_groups,
                     cudaStream_t stream) {
  static int allowed[DEVICES] = {};
  const cudaError_t e = allow_smem(conv9view_wgmma_kernel<NB, GC>,
                                   c9_smem_bytes<NB>(GC), allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (X + C9_TX - 1) / C9_TX;
  dim3 grid(tiles_x * ((Y + C9_TY - 1) / C9_TY), Z, (Cout + NB - 1) / NB);
  conv9view_wgmma_kernel<NB, GC>
      <<<grid, C9_THREADS, c9_smem_bytes<NB>(GC), stream>>>(
          map, wp, b, y, Z, Y, X, Cout, tiles_x, n_groups);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_conv9view(const CUtensorMap& map, const float* wp, const float* b,
                     float* y, int Z, int Y, int X, int Cout, int gc,
                     int n_groups, cudaStream_t stream) {
  switch (gc) {
    case 1:
      return launch_conv9view<NB, 1>(map, wp, b, y, Z, Y, X, Cout, n_groups,
                                     stream);
    case 2:
      return launch_conv9view<NB, 2>(map, wp, b, y, Z, Y, X, Cout, n_groups,
                                     stream);
    case 4:
      return launch_conv9view<NB, 4>(map, wp, b, y, Z, Y, X, Cout, n_groups,
                                     stream);
    default: return -2;
  }
}

}  // namespace

// Blocks of add_one_kernel one SM holds (the occupancy API), or -(CUDA
// error).
extern "C" int ladder_add_one_blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, add_one_kernel, ADD_ONE_THREADS, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// y = x + 1 over n floats, one launch of `blocks` blocks
// (ops/ladder.py::add_one_plan); n4 = n / 4 when x and y are 16-byte
// aligned (the float4 stream), else 0 (every float scalar).
extern "C" int ladder_add_one_f32(const void* x, void* y, long long n,
                                  long long n4, int blocks, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (blocks < 1 || n4 != (aligned ? n / 4 : 0)) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned)
    add_one_kernel<<<blocks, ADD_ONE_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(xf), reinterpret_cast<float4*>(yf),
        n4, xf + 4 * n4, yf + 4 * n4, static_cast<int>(n - 4 * n4));
  else
    add_one_scalar_kernel<<<blocks, ADD_ONE_THREADS, 0, s>>>(xf, yf, n);
  return static_cast<int>(cudaGetLastError());
}

// y (M, Cout) = x (M, Cp) @ w (Cp, Cout), all contiguous and 16-byte
// aligned, Cp % 4 == 0 (at most 64), Cout % 4 == 0; nb the N tile (8, 16 or
// 32), `blocks` the persistent grid (ops/ladder.py::pointwise_plan).
// Returns cudaGetLastError() after the launch, -1 when a tensor map cannot
// be made, -2 for an unsupported nb, -3 when the tiles do not fit in shared
// memory.
extern "C" int ladder_pointwise_matmul_f32(const void* x, const void* w,
                                           void* y, long long M, int Cp,
                                           int Cout, int nb, int blocks,
                                           void* stream) {
  const float* ww = static_cast<const float*>(w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8: return launch_pointwise<8>(x, ww, y, M, Cp, Cout, blocks, s);
    case 16: return launch_pointwise<16>(x, ww, y, M, Cp, Cout, blocks, s);
    case 32: return launch_pointwise<32>(x, ww, y, M, Cp, Cout, blocks, s);
    default: return -2;
  }
}

// the dynamic shared memory a block of pointwise_kernel takes, in bytes
// (-2 for an unsupported nb)
extern "C" int ladder_pointwise_smem_bytes(int Cp, int Cout, int nb) {
  switch (nb) {
    case 8: return pw_smem_bytes<8>(Cp, Cout, pw_smem_fit<8>(Cp, Cout));
    case 16: return pw_smem_bytes<16>(Cp, Cout, pw_smem_fit<16>(Cp, Cout));
    case 32: return pw_smem_bytes<32>(Cp, Cout, pw_smem_fit<32>(Cp, Cout));
    default: return -2;
  }
}

// y (Z, Y, X, Cout) = relu(conv_same(x, w) + b) as the nine views, for x
// (Z, Y, X, Cp) contiguous, Cp % 8 == 0, through the 5-D (c, x, y, z, b)
// tensor map that dims, strides (bytes) and box describe (box: 8 channels,
// the 18 x 10 halo, 3 z-planes); wp the packed hi/lo stages of N tile nb (8,
// 16, 32, 64 or 128) in groups of gc (1, 2 or 4) chunks.  Z and
// ceil(Cout / nb) must fit grid.y and grid.z (65535).  Returns
// cudaGetLastError() after the launch, -1 when the tensor map cannot be
// made and -2 for an unsupported nb or gc.
extern "C" int ladder_conv9view_bias_relu_f32(
    const void* x, const void* wp, const void* b, void* y, int Z, int Y,
    int X, int Cp, int Cout, int nb, int gc, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box, void* stream) {
  if ((gc != 1 && gc != 2 && gc != 4) || (Cp / C9_CK) % gc != 0) return -2;
  CUtensorMap map;
  if (!encode_map_5d(&map, x, dims, strides, box)) return -1;
  const float* w = static_cast<const float*>(wp);
  const float* bb = static_cast<const float*>(b);
  float* o = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ng = Cp / C9_CK / gc;
  switch (nb) {
    case 8:
      return launch_conv9view<8>(map, w, bb, o, Z, Y, X, Cout, gc, ng, s);
    case 16:
      return launch_conv9view<16>(map, w, bb, o, Z, Y, X, Cout, gc, ng, s);
    case 32:
      return launch_conv9view<32>(map, w, bb, o, Z, Y, X, Cout, gc, ng, s);
    case 64:
      return launch_conv9view<64>(map, w, bb, o, Z, Y, X, Cout, gc, ng, s);
    case 128:
      return launch_conv9view<128>(map, w, bb, o, Z, Y, X, Cout, gc, ng, s);
    default: return -2;
  }
}

// the dynamic shared memory a block of the nine-view kernel takes, in bytes
// (-2 for an unsupported nb or gc)
extern "C" int ladder_conv9view_smem_bytes(int nb, int gc) {
  if (gc != 1 && gc != 2 && gc != 4) return -2;
  switch (nb) {
    case 8: return c9_smem_bytes<8>(gc);
    case 16: return c9_smem_bytes<16>(gc);
    case 32: return c9_smem_bytes<32>(gc);
    case 64: return c9_smem_bytes<64>(gc);
    case 128: return c9_smem_bytes<128>(gc);
    default: return -2;
  }
}
