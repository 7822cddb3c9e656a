// The per-slice 2-D minimax watershed flood of an (x, y, z) stack, all of
// its synchronous (Jacobi) rounds in one persistent cooperative launch.
//
// Replaces: 3deecelltracker_tpu/ops/pallas_kernels.py::flood_slices (body
// _flood_kernel), the same flood that ops/watershed.py::watershed_flood runs
// per z inside recalculate_cell_boundaries and watershed_2d.  Every masked
// non-marker voxel takes the label of the marker reachable with the
// smallest (max elevation along the path, path length) in lexicographic
// order; each slice runs rounds until a round changes nothing or the cap.
//
// What bounds it on an H100: the latency of a round more than its bytes.
// The stacks the paths give it (24 slices of 401x168) settle in 1 to a few
// tens of rounds, and only mask & ~marker voxels can ever change (in
// recalculate_cell_boundaries, only the overlap voxels: a few thousand of
// 1.6 M), so a round moves kilobytes; its cost is a chain of L2 round trips
// and a grid-wide barrier.  A launch and a host check per round would cost
// more than the round itself.
//
// Design:
// - One launch per call: a persistent kernel under
//   cudaLaunchCooperativeKernel, the grid the SMs times the resident blocks
//   per SM (occupancy API), and cooperative_groups' grid.sync() between
//   rounds.  A launch the card refuses returns its error; there is no other
//   path.
// - The stack stays in the caller's (x, y, z) layout (z fastest): no
//   transposes.  A tile is a run of TILE consecutive voxels of the flat
//   index.  Phase 1, once per call, lists every tile holding an updatable
//   (mask & ~marker) voxel; the rounds visit only those.
// - State lives only where it can change.  A voxel that is not updatable
//   keeps its initial state for good: (marker, its elevation, 0) for a
//   masked marker, label 0 otherwise, so a round reads it from the inputs
//   (read-only, through the non-coherent cache).  Updatable voxels start at
//   (0, inf, inf), which round 0 takes as given, so nothing is initialised.
// - Round r reads the ping-pong set r % 2 and writes set (r + 1) % 2, at
//   every updatable voxel of a slice whose round r - 1 changed something
//   (every slice in round 0); a slice at its fixed point drops out, and
//   its last round count says which set holds its labels.  The neighbour
//   order x-1, y-1, y+1, x+1 and the strictly-better rule are
//   _flood_kernel's, so the labels are bit-identical, at a cap too.  An
//   in-place (Gauss-Seidel) sweep would converge to a different labelling
//   at exact (cost, hops) ties, so it is not used.
// - Convergence on the device every round: a voxel that moves sets its
//   slice's flag for the round (three flag sets in rotation: read, written,
//   cleared).  After the barrier every block reads the round's flags; the
//   loop ends when no slice changed or at max_iters, and the rounds run go
//   to device memory for the host to read once per call.
// - Mutable state is read with __ldcg (L2, not the SM's L1, which other
//   blocks' writes do not reach).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int TILE = 1024;
constexpr float INF = 3e38f;

struct Scratch {
  int32_t* lab[2];
  float* cost[2];
  float* hops[2];
  int32_t* flags;   // [3][S] change flags, then the tile counter
  int32_t* ran;     // [S] rounds each slice ran
  int32_t* tiles;
};

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// the scratch layout; returns its size in bytes (base may be null)
size_t carve(void* base, int64_t n, int S, Scratch* s) {
  char* p = static_cast<char*>(base);
  size_t off = 0;
  for (int k = 0; k < 2; ++k) {
    s->lab[k] = reinterpret_cast<int32_t*>(p + off);
    off += align256(4 * n);
    s->cost[k] = reinterpret_cast<float*>(p + off);
    off += align256(4 * n);
    s->hops[k] = reinterpret_cast<float*>(p + off);
    off += align256(4 * n);
  }
  s->flags = reinterpret_cast<int32_t*>(p + off);
  off += align256(4 * (3 * static_cast<int64_t>(S) + 1));
  s->ran = reinterpret_cast<int32_t*>(p + off);
  off += align256(4 * static_cast<int64_t>(S));
  s->tiles = reinterpret_cast<int32_t*>(p + off);
  off += align256(4 * ((n + TILE - 1) / TILE));
  return off;
}

__device__ __forceinline__ bool updatable(const uint8_t* mask,
                                          const int32_t* mk, int64_t i) {
  return __ldg(mask + i) && __ldg(mk + i) <= 0;
}

__global__ void __launch_bounds__(NT)
flood_kernel(const float* __restrict__ elev, const int32_t* __restrict__ mk,
             const uint8_t* __restrict__ mask, int32_t* __restrict__ out,
             int32_t* __restrict__ info, Scratch st, int S, int NX, int NY,
             int max_iters) {
  cg::grid_group grid = cg::this_grid();
  const int64_t n = static_cast<int64_t>(NX) * NY * S;
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  const int64_t row = static_cast<int64_t>(NY) * S;
  int32_t* counter = st.flags + 3 * static_cast<int64_t>(S);

  // phase 1: the tiles that hold an updatable voxel
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int any = 0;
    const int64_t end = (t + 1) * TILE < n ? (t + 1) * TILE : n;
    for (int64_t i = t * TILE + threadIdx.x; i < end; i += NT)
      any |= updatable(mask, mk, i);
    if (__syncthreads_or(any) && threadIdx.x == 0)
      st.tiles[atomicAdd(counter, 1)] = static_cast<int32_t>(t);
  }
  grid.sync();
  const int n_act = __ldcg(counter);

  int r = 0;
  while (r < max_iters) {
    const int a = r & 1;
    const int32_t* lab_in = st.lab[a];
    const float* cost_in = st.cost[a];
    const float* hops_in = st.hops[a];
    int32_t* lab_out = st.lab[a ^ 1];
    float* cost_out = st.cost[a ^ 1];
    float* hops_out = st.hops[a ^ 1];
    const int32_t* prev = st.flags + ((r + 2) % 3) * static_cast<int64_t>(S);
    int32_t* cur = st.flags + (r % 3) * static_cast<int64_t>(S);
    int32_t* next = st.flags + ((r + 1) % 3) * static_cast<int64_t>(S);
    // round r + 1's flags, last read in round r - 1 (before the barrier)
    for (int64_t s = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
         s < S; s += static_cast<int64_t>(gridDim.x) * NT)
      next[s] = 0;

    for (int k = blockIdx.x; k < n_act; k += gridDim.x) {
      const int64_t t = __ldcg(st.tiles + k);
      const int64_t end = (t + 1) * TILE < n ? (t + 1) * TILE : n;
      for (int64_t i = t * TILE + threadIdx.x; i < end; i += NT) {
        if (!updatable(mask, mk, i)) continue;
        const int s = static_cast<int>(i % S);
        // a slice whose last round changed nothing is at its fixed point
        if (r > 0 && !__ldcg(prev + s)) continue;
        const int64_t xy = i / S;
        const int yy = static_cast<int>(xy % NY);
        const int xx = static_cast<int>(xy / NY);
        int32_t lab = 0;
        float cost = INF;
        float hops = INF;
        if (r > 0) {
          lab = __ldcg(lab_in + i);
          cost = __ldcg(cost_in + i);
          hops = __ldcg(hops_in + i);
        }
        const float e = __ldg(elev + i);
        int32_t bl = lab;
        float bc = cost;
        float bh = hops;
        int64_t nb[4];
        bool ok[4];
        nb[0] = i - row; ok[0] = xx > 0;          // x - 1
        nb[1] = i - S;   ok[1] = yy > 0;          // y - 1
        nb[2] = i + S;   ok[2] = yy < NY - 1;     // y + 1
        nb[3] = i + row; ok[3] = xx < NX - 1;     // x + 1
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!ok[q] || !__ldg(mask + nb[q])) continue;   // label 0
          const int32_t m = __ldg(mk + nb[q]);
          int32_t nl;
          float nc, nh;
          if (m > 0) {                 // a marker: its initial state
            nl = m;
            nc = __ldg(elev + nb[q]);
            nh = 0.f;
          } else {                     // updatable: label 0 in round 0
            if (r == 0) continue;
            nl = __ldcg(lab_in + nb[q]);
            nc = __ldcg(cost_in + nb[q]);
            nh = __ldcg(hops_in + nb[q]);
          }
          if (nl <= 0) continue;
          const float cc = fmaxf(nc, e);
          const float ch = nh + 1.0f;
          if (cc < bc || (cc == bc && ch < bh)) {
            bl = nl;
            bc = cc;
            bh = ch;
          }
        }
        lab_out[i] = bl;
        cost_out[i] = bc;
        hops_out[i] = bh;
        st.ran[s] = r + 1;
        if (bl != lab || bc != cost || bh != hops) cur[s] = 1;
      }
    }
    grid.sync();
    ++r;
    // every block reads the same flags: the loop ends in every block at once
    int any = 0;
    for (int s = threadIdx.x; s < S; s += NT) any |= __ldcg(cur + s);
    if (!__syncthreads_or(any)) break;
  }

  // the labels: markers and label 0 from the inputs, updatable voxels from
  // the set their slice's last round wrote (label 0 if no round ran)
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * NT) {
    int32_t l = 0;
    if (mask[i]) {
      const int32_t m = mk[i];
      if (m > 0)
        l = m;
      else if (r > 0)
        l = __ldcg(st.lab[__ldcg(st.ran + i % S) & 1] + i);
    }
    out[i] = l;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    info[0] = r;
    info[1] = n_act;
  }
}

}  // namespace

// Bytes of scratch flood_slices_f32 needs for an (NX, NY, S) stack.
extern "C" long long flood_scratch_bytes(int NX, int NY, int S) {
  Scratch s;
  return static_cast<long long>(
      carve(nullptr, static_cast<int64_t>(NX) * NY * S, S, &s));
}

// The flood of a contiguous (NX, NY, S) stack: elev f32, markers int32,
// mask bool (one byte) in, out int32 labels; info int32[2] gets the rounds
// run and the tiles listed.  One cooperative launch.
extern "C" int flood_slices_f32(const void* elev, const void* markers,
                                const void* mask, void* out, void* scratch,
                                void* info, int NX, int NY, int S,
                                int max_iters, void* stream) {
  if (NX < 1 || NY < 1 || S < 1) return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(NX) * NY * S;
  Scratch st;
  carve(scratch, n, S, &st);
  auto strm = static_cast<cudaStream_t>(stream);
  // the flags and the tile counter start at 0
  cudaError_t err = cudaMemsetAsync(
      st.flags, 0, 4 * (3 * static_cast<size_t>(S) + 1), strm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks resident on the whole card, asked once per device
  static int resident_of[64];
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, flood_kernel, NT, 0)) != cudaSuccess)
      return static_cast<int>(err);
    resident_of[dev] = sms * per_sm;
  }
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  const int64_t resident = resident_of[dev];
  const int blocks = static_cast<int>(resident < n_tiles ? resident
                                                         : n_tiles);
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const auto* e = static_cast<const float*>(elev);
  const auto* m = static_cast<const int32_t*>(markers);
  const auto* k = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<int32_t*>(out);
  auto* inf = static_cast<int32_t*>(info);
  void* args[] = {&e, &m, &k, &o, &inf, &st, &S, &NX, &NY, &max_iters};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(flood_kernel),
                                    dim3(blocks), dim3(NT), args, 0, strm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
