// Connected components of a binary (x, y, z) volume, full box connectivity:
// every foreground voxel gets the 1-based C-order flat index of the smallest
// voxel of its component, background 0.
//
// Replaces: 3deecelltracker_tpu/ops/pallas_kernels.py::cc_propagate (body
// _cc_kernel), hook-only min-label propagation to a fixed point, which is the
// math of ops/connected.py::label_components_raw with full connectivity.  Two
// modes:
//   per_slice = 0: 26-connectivity over the whole volume, flat index
//                  (x * Y + y) * Z + z + 1;
//   per_slice = 1: 8-connectivity within each z-slice, slice-local index
//                  x * Y + y + 1 (label_components_raw vmapped over z, as
//                  watershed_2d runs it).
// The answer is the fixed point itself, so it is bit-identical whatever the
// scheduling.
//
// What bounds it on an H100: bytes, the mask read once and the int32 labels
// written once (8.1 MB for the pipeline frame (401, 168, 24), 2.4 us at
// 3.35 TB/s).  At that size the real floor is latency: the launch, a
// grid-wide barrier between phases that depend on each other (~1-2 us
// each), and every chain of dependent L2 round trips on the slowest block's
// path.  The path's masks are sparse (the legacy watersheds' peaks: 153 and
// 459 of 1.6 M voxels), so a pass that visits each voxel costs more than
// the work: 1.6 M voxels at ~30 instructions is ~1.6 us of the card's
// issue rate per pass.  The design counts launches, barriers, round trips
// and passes over the background.
//
// Design: a union-find (the atomic scheme of ECL-CC, Jaiganesh & Burtscher
// 2018) in one persistent cooperative launch (cudaLaunchCooperativeKernel,
// the grid the card's resident blocks or fewer, cooperative_groups'
// grid.sync() between phases), with no scratch: the output is the
// union-find's parent array.
// - Parent encoding.  A voxel's entry holds its parent as the label that
//   parent would carry: 1-based, in the mode's numbering (g + 1 in 3-D,
//   g / Z + 1 per slice, where the parent shares the voxel's z), background
//   0.  A root holds its own label, so once every voxel points straight at
//   its root, the array is the answer: no pass converts it, and a thread
//   that writes its final label writes a valid parent pointer that other
//   threads' finds may still walk through.
// - Order.  Parents always hold smaller flat indices (within a slice the
//   slice-local order is the flat order), unions hook the larger root under
//   the smaller with atomicCAS, which succeeds only on a current root, and
//   finds shorten paths only to ancestors; so every tree stays intact under
//   any interleaving and its root is its component's minimum.
// - Tiles.  The host (ops/hopper_cc.py::tile_plan) cuts the volume into the
//   smallest tiles the resident blocks can take one each: all of z up to
//   64 voxels (the contiguous axis), a near-square patch of (x, y).  A
//   block keeps its tile in shared memory through the whole launch: its
//   mask as 4-voxel words, its local union-find, the list of its
//   foreground voxels (so their work spreads over the block's threads).
//   Volumes too large for that take tiles of TILE_MAX voxels, several a
//   block, and re-read the mask in phases 2 and 3.
// - Phase 1, per tile: the mask with all loads in flight (32-bit words
//   where the rows are 4-byte aligned), the foreground list found a word at
//   a time, the tile's internal forward edges united with shared-memory
//   atomics (per slice: the in-slice offsets only), flattened, and every
//   entry of the tile written (int4 stores where aligned): its tile-local
//   root's label, 0 for background.
// - grid.sync(), then phase 2: each foreground voxel on a tile's forward
//   face unites with its foreground neighbours in other tiles, in global
//   memory (loads through L2 with __ldcg: L1 is not coherent across SMs).
//   The neighbours' mask bytes are all loaded before the first is used,
//   and the voxel's own side is its tile-local root, known from shared
//   memory, so a union costs the neighbour's find and one atomicCAS.
// - grid.sync(), then phase 3: a tile-local root that phase 2 did not hook
//   is still a root and none of its voxels changed; each hooked one walks
//   to its root once and writes the root's label to itself and every
//   voxel under it.  Only a voxel's own entry is written, and only with a
//   pointer to an ancestor, so concurrent walks stay valid.
// Flat indices are int32; the wrapper refuses volumes of 2^31 voxels or
// more.  `phases` (1-3) stops the launch after that phase: the wrapper
// always passes 3, and chip_smoke.py times 1 and 2 to split the kernel's
// time between its phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int TILE_MAX = 4096;   // voxels a tile may hold: the shared arrays
constexpr int WORD_LOADS = TILE_MAX / 4 / NT;  // mask words a thread loads

struct Vol {
  int X, Y, Z;       // the volume
  int TX, TY, TZ;    // the tile box (clipped at the volume's far faces)
  int ntx, nty, ntz; // tiles along each axis
  int per_slice;
  int vec;           // 4-voxel rows: the mask read as words, entries as int4
  int vec16;         // the mask 16-byte aligned: phase 3 reads it as uint4
};

struct Tile {
  int x0, y0, z0, tx, ty, tz, n;
};

__device__ __forceinline__ Tile tile_of(int t, const Vol& v) {
  Tile T;
  const int iz = t % v.ntz;
  const int r = t / v.ntz;
  const int iy = r % v.nty;
  const int ix = r / v.nty;
  T.x0 = ix * v.TX;
  T.y0 = iy * v.TY;
  T.z0 = iz * v.TZ;
  T.tx = min(v.TX, v.X - T.x0);
  T.ty = min(v.TY, v.Y - T.y0);
  T.tz = min(v.TZ, v.Z - T.z0);
  T.n = T.tx * T.ty * T.tz;
  return T;
}

// local index l = (lx * ty + ly) * tz + lz of a tile <-> its coordinates
__device__ __forceinline__ void coords(int l, const Tile& T, int& lx, int& ly,
                                       int& lz) {
  lz = l % T.tz;
  const int q = l / T.tz;
  ly = q % T.ty;
  lx = q / T.ty;
}

// A thread's walk over a tile's local indices start, start + step, ...
// with their coordinates kept by additions, not two divisions a voxel.
struct Walk {
  int l, lx, ly, lz;  // the current index and its coordinates
  int step, sx, sy, sz;

  __device__ __forceinline__ Walk(const Tile& T, int start, int step_)
      : l(start), step(step_) {
    coords(start, T, lx, ly, lz);
    coords(step_, T, sx, sy, sz);  // sz < tz and sy < ty: one carry each
  }

  __device__ __forceinline__ void next(const Tile& T) {
    l += step;
    lz += sz;
    ly += sy;
    lx += sx;
    if (lz >= T.tz) {
      lz -= T.tz;
      ++ly;
    }
    if (ly >= T.ty) {
      ly -= T.ty;
      ++lx;
    }
  }
};

__device__ __forceinline__ int flat(int x, int y, int z, const Vol& v) {
  return (x * v.Y + y) * v.Z + z;
}

// the label voxel g carries as a root: its entry when it points at itself
__device__ __forceinline__ int enc(int g, const Vol& v) {
  return v.per_slice ? g / v.Z + 1 : g + 1;
}

// the same from the voxel's coordinates, with no division
__device__ __forceinline__ int label_at(int x, int y, int z, const Vol& v) {
  return v.per_slice ? x * v.Y + y + 1 : flat(x, y, z, v) + 1;
}

// the voxel an entry of a voxel in slice z points to
__device__ __forceinline__ int dec(int e, int z, const Vol& v) {
  return v.per_slice ? (e - 1) * v.Z + z : e - 1;
}

// ---- shared-memory union-find over a tile's local indices -----------------

__device__ __forceinline__ int local_find(volatile int* lp, int i) {
  while (true) {
    const int p = lp[i];
    if (p == i) return i;
    const int gp = lp[p];
    if (gp == p) return p;
    lp[i] = gp;  // path halving: i is not a root, gp is its ancestor
    i = gp;
  }
}

__device__ __forceinline__ void local_unite(int* lp, int a, int b) {
  volatile int* vp = lp;
  while (true) {
    a = local_find(vp, a);
    b = local_find(vp, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(lp + b, b, a) == b) return;  // only a root is hooked
  }
}

// ---- global union-find over the encoded entries ---------------------------

__device__ __forceinline__ int find_root(int* p, int i, int z, const Vol& v) {
  int cur = dec(__ldcg(p + i), z, v);
  if (cur == i) return i;
  int prev = i;
  while (true) {
    const int e = __ldcg(p + cur);
    const int next = dec(e, z, v);
    if (next == cur) return cur;
    p[prev] = e;  // prev is not a root: point it at its grandparent
    prev = cur;
    cur = next;
  }
}

// Join the trees of ra and rb, each a voxel of its tree (its root, or an
// ancestor that was the root when it was read): the larger root is hooked
// under the smaller side; a hook that fails climbs and tries again.
__device__ __forceinline__ void unite_roots(int* p, int ra, int rb, int z,
                                            const Vol& v) {
  while (ra != rb) {
    if (ra > rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    const int want = enc(rb, v);
    const int old = atomicCAS(p + rb, want, enc(ra, v));
    if (old == want) return;
    rb = dec(old, z, v);  // rb was hooked meanwhile: climb from its parent
  }
}

// ---- the phases ------------------------------------------------------------

// voxel l of a tile's mask held in shared memory, 4 voxels a word
__device__ __forceinline__ bool fg_at(const uint32_t* sm, int l) {
  return (sm[l >> 2] >> (8 * (l & 3))) & 0xffu;
}

// the voxels of a nonzero mask word m4 at local index 4 w, one by one
#define FOR_EACH_FG(m4, w, l)                                       \
  for (uint32_t _m = (m4), _j; _m && (_j = (__ffs(_m) - 1) >> 3,    \
                                      l = 4 * (w) + _j, true);     \
       _m &= ~(0xffu << (8 * _j)))

// The shared state of a block's tile through the launch: its mask, 4
// voxels a word; its local union-find; the list of its foreground voxels,
// so that their work spreads over all threads however they cluster.
struct Shared {
  uint32_t sm[TILE_MAX / 4];
  int lp[TILE_MAX];
  int fg[TILE_MAX];
  int n_fg;
};

// Phase 1: the tile's components in shared memory; every entry of the tile
// gets its tile-local root's label (0 for background).  S ends as the
// tile's mask, its foreground list, and lp at foreground voxels: -2 -
// label at a root, the root's local index elsewhere.
__device__ void label_tile(const uint8_t* __restrict__ mask, int* out,
                           Shared& S, const Tile& T, const Vol& v) {
  uint32_t* sm = S.sm;
  int* lp = S.lp;
  const int nw = (T.n + 3) >> 2;
  if (threadIdx.x == 0) S.n_fg = 0;
  if (v.vec) {  // all loads in flight before the first store
    uint32_t m[WORD_LOADS];
    Walk w(T, 4 * threadIdx.x, 4 * NT);
#pragma unroll
    for (int k = 0; k < WORD_LOADS; ++k, w.next(T))
      m[k] = w.l < T.n ? __ldg(reinterpret_cast<const uint32_t*>(
                             mask + flat(T.x0 + w.lx, T.y0 + w.ly,
                                         T.z0 + w.lz, v)))
                       : 0u;
#pragma unroll
    for (int k = 0; k < WORD_LOADS; ++k)
      if (threadIdx.x + k * NT < nw) sm[threadIdx.x + k * NT] = m[k];
  } else {
    for (int i = threadIdx.x; i < nw; i += NT) sm[i] = 0u;
    __syncthreads();
    uint8_t* sb = reinterpret_cast<uint8_t*>(sm);
    for (Walk w(T, threadIdx.x, NT); w.l < T.n; w.next(T))
      sb[w.l] = __ldg(mask + flat(T.x0 + w.lx, T.y0 + w.ly, T.z0 + w.lz, v))
                    ? 1
                    : 0;
  }
  __syncthreads();
  // the foreground, found a word (4 voxels) at a time
  int l;
  for (int i = threadIdx.x; i < nw; i += NT) {
    FOR_EACH_FG(sm[i], i, l) {
      lp[l] = l;
      S.fg[atomicAdd(&S.n_fg, 1)] = l;
    }
  }
  __syncthreads();
  const int n_fg = S.n_fg;

  // the forward half of the neighbourhood inside the tile
  const int sy = T.tz;
  const int sx = T.ty * T.tz;
  for (int k = threadIdx.x; k < n_fg; k += NT) {
    const int l = S.fg[k];
    int lx, ly, lz;
    coords(l, T, lx, ly, lz);
    if (v.per_slice) {
      // (0, +1), (+1, -1..+1) in (x, y)
      if (ly + 1 < T.ty && fg_at(sm, l + sy)) local_unite(lp, l, l + sy);
      if (lx + 1 < T.tx) {
        for (int dy = -1; dy <= 1; ++dy) {
          if (ly + dy < 0 || ly + dy >= T.ty) continue;
          const int j = l + sx + dy * sy;
          if (fg_at(sm, j)) local_unite(lp, l, j);
        }
      }
      continue;
    }
    for (int dx = 0; dx <= 1; ++dx) {
      if (lx + dx >= T.tx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        if (dx == 0 && dy < 0) continue;
        if (ly + dy < 0 || ly + dy >= T.ty) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          if (dx == 0 && dy == 0 && dz <= 0) continue;
          if (lz + dz < 0 || lz + dz >= T.tz) continue;
          const int j = l + dx * sx + dy * sy + dz;
          if (fg_at(sm, j)) local_unite(lp, l, j);
        }
      }
    }
  }
  __syncthreads();

  // flatten: every voxel points at its root, then every root trades its
  // index for -2 - its label
  volatile int* vp = lp;
  for (int k = threadIdx.x; k < n_fg; k += NT) {
    const int l = S.fg[k];
    int r = vp[l];
    if (r == l) continue;
    while (vp[r] != r) r = vp[r];
    vp[l] = r;  // an ancestor: concurrent walks stay valid
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_fg; k += NT) {
    const int l = S.fg[k];
    if (lp[l] != l) continue;
    int lx, ly, lz;
    coords(l, T, lx, ly, lz);
    lp[l] = -2 - label_at(T.x0 + lx, T.y0 + ly, T.z0 + lz, v);
  }
  __syncthreads();
  auto entry = [&](int l) -> int {
    if (!fg_at(sm, l)) return 0;
    const int p = lp[l];
    return -2 - (p < 0 ? p : lp[p]);
  };
  if (v.vec) {
    Walk w(T, 4 * threadIdx.x, 4 * NT);
    for (int i = threadIdx.x; i < nw; i += NT, w.next(T))
      *reinterpret_cast<int4*>(
          out + flat(T.x0 + w.lx, T.y0 + w.ly, T.z0 + w.lz, v)) =
          sm[i] ? make_int4(entry(4 * i), entry(4 * i + 1), entry(4 * i + 2),
                            entry(4 * i + 3))
                : make_int4(0, 0, 0, 0);
  } else {
    for (Walk w(T, threadIdx.x, NT); w.l < T.n; w.next(T))
      out[flat(T.x0 + w.lx, T.y0 + w.ly, T.z0 + w.lz, v)] = entry(w.l);
  }
}

// The forward half of the neighbourhood, (dx, dy, dz) packed 2 bits each
// (+1): the 13 lexicographically positive offsets in 3-D, then the 4 in a
// slice's (x, y) plane.
__constant__ uint8_t kForward[17] = {
    0x16, 0x18, 0x19, 0x1a, 0x20, 0x21, 0x22, 0x24, 0x25,
    0x26, 0x28, 0x29, 0x2a, 0x19, 0x21, 0x25, 0x29};

// Phase 2 at foreground voxel (lx, ly, lz) of tile T: its unions with
// forward neighbours in other tiles (none unless it lies on a forward
// face: x + 1 past the tile, y + 1 past it, y - 1 before it (with x + 1),
// and in 3-D z + 1 past it or z - 1 before it).  The neighbours' mask
// bytes are all asked for before the first is used: one L2 round trip,
// not one per neighbour.
__device__ __forceinline__ void unite_across(const uint8_t* __restrict__ mask,
                                             int* out, const Tile& T,
                                             const Vol& v, int lx, int ly,
                                             int lz, int ra) {
  const int x = T.x0 + lx, y = T.y0 + ly, z = T.z0 + lz;
  const bool face =
      (lx == T.tx - 1 && x + 1 < v.X) || (ly == T.ty - 1 && y + 1 < v.Y) ||
      (ly == 0 && y > 0 && x + 1 < v.X) ||
      (!v.per_slice &&
       ((lz == T.tz - 1 && z + 1 < v.Z) || (lz == 0 && z > 0)));
  if (!face) return;
  const int first = v.per_slice ? 13 : 0;
  const int count = v.per_slice ? 4 : 13;
  int nb[13];
  uint8_t fg[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    nb[k] = -1;
    fg[k] = 0;
    if (k >= count) continue;
    const int o = kForward[first + k];
    const int dx = (o >> 4) - 1, dy = ((o >> 2) & 3) - 1, dz = (o & 3) - 1;
    const int xx = x + dx, yy = y + dy, zz = z + dz;
    if (xx >= v.X || yy < 0 || yy >= v.Y || zz < 0 || zz >= v.Z) continue;
    if (lx + dx < T.tx && ly + dy >= 0 && ly + dy < T.ty && lz + dz >= 0 &&
        lz + dz < T.tz)
      continue;  // phase 1 united it
    nb[k] = flat(xx, yy, zz, v);
    fg[k] = __ldg(mask + nb[k]);
  }
  const int g = flat(x, y, z, v);
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    if (nb[k] < 0 || !fg[k]) continue;
    if (ra < 0) ra = find_root(out, g, z, v);
    unite_roots(out, ra, find_root(out, nb[k], z, v), z, v);
  }
}

// Phase 3 at foreground voxel i: its entry -> its root's label.
__device__ __forceinline__ void point_at_root(int* out, int i, const Vol& v) {
  const int z = v.per_slice ? i % v.Z : 0;
  int cur = dec(__ldcg(out + i), z, v);
  if (cur == i) return;  // a root
  int ce = __ldcg(out + cur);
  int next = dec(ce, z, v);
  if (next == cur) return;  // its parent is the root
  do {
    cur = next;
    ce = __ldcg(out + cur);
    next = dec(ce, z, v);
  } while (next != cur);
  out[i] = ce;  // the root's own entry: its label
}

// Phase 3 for a block that owns one tile, from its phase-1 state in shared
// memory: a voxel's root is its tile-local root's.  A local root that phase
// 2 did not hook is still a root, and none of its voxels' entries changed:
// nothing to write.  Each hooked local root walks to its root once, takes
// the root's label as its code and is marked 2 in the tile's mask (a bool
// mask holds 0 and 1); then that label goes to every voxel under it.
__device__ void finish_tile(int* out, Shared& S, const Tile& T,
                            const Vol& v) {
  uint8_t* sb = reinterpret_cast<uint8_t*>(S.sm);
  int* lp = S.lp;
  for (int k = threadIdx.x; k < S.n_fg; k += NT) {
    const int l = S.fg[k];
    if (lp[l] >= 0) continue;  // not a local root
    int lx, ly, lz;
    coords(l, T, lx, ly, lz);
    const int z = T.z0 + lz;
    const int g = flat(T.x0 + lx, T.y0 + ly, z, v);
    int cur = dec(__ldcg(out + g), z, v);
    if (cur == g) continue;  // not hooked
    int next;
    while ((next = dec(__ldcg(out + cur), z, v)) != cur) cur = next;
    const int root = __ldcg(out + cur);
    out[g] = root;
    lp[l] = -2 - root;
    sb[l] = 2;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < S.n_fg; k += NT) {
    const int l = S.fg[k];
    const int r = lp[l];
    if (r < 0 || sb[r] != 2) continue;  // a local root, or not hooked
    int lx, ly, lz;
    coords(l, T, lx, ly, lz);
    out[flat(T.x0 + lx, T.y0 + ly, T.z0 + lz, v)] = -2 - lp[r];
  }
}

__global__ void __launch_bounds__(NT)
cc_kernel(const uint8_t* __restrict__ mask, int* out, Vol v, int phases) {
  __shared__ Shared S;
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = v.ntx * v.nty * v.ntz;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    label_tile(mask, out, S, tile_of(t, v), v);
    __syncthreads();  // S is the next tile's
  }
  if (phases < 2) return;
  grid.sync();
  const bool one_tile = n_tiles <= static_cast<int>(gridDim.x);
  if (one_tile) {
    // the block's tile is still in shared memory, with each foreground
    // voxel's tile-local root: a's side of a union needs no lookup
    const Tile T = tile_of(blockIdx.x, v);
    for (int k = threadIdx.x; k < S.n_fg; k += NT) {
      const int l = S.fg[k];
      int lx, ly, lz;
      coords(l, T, lx, ly, lz);
      const int code = S.lp[l] < 0 ? S.lp[l] : S.lp[S.lp[l]];
      unite_across(mask, out, T, v, lx, ly, lz,
                   dec(-2 - code, T.z0 + lz, v));
    }
  } else {
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile T = tile_of(t, v);
      for (Walk w(T, threadIdx.x, NT); w.l < T.n; w.next(T))
        if (__ldg(mask + flat(T.x0 + w.lx, T.y0 + w.ly, T.z0 + w.lz, v)))
          unite_across(mask, out, T, v, w.lx, w.ly, w.lz, -1);
    }
  }
  if (phases < 3) return;
  grid.sync();
  if (one_tile) {
    finish_tile(out, S, tile_of(blockIdx.x, v), v);
    return;
  }
  // several tiles a block: the foreground from the mask, 16 voxels a load
  // where it is 16-byte aligned
  const int n = v.X * v.Y * v.Z;
  const int stride = gridDim.x * NT;
  const int first = blockIdx.x * NT + threadIdx.x;
  int done = 0;
  if (v.vec16) {
    const int n16 = n >> 4;
    for (int q = first; q < n16; q += stride) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask) + q);
      if (!(m.x | m.y | m.z | m.w)) continue;
      const uint32_t words[4] = {m.x, m.y, m.z, m.w};
      int i;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        FOR_EACH_FG(words[k], 4 * q + k, i) point_at_root(out, i, v);
    }
    done = 16 * n16;
  }
  for (int i = done + first; i < n; i += stride)
    if (__ldg(mask + i)) point_at_root(out, i, v);
}

}  // namespace

// Blocks of cc_kernel one SM holds (the occupancy API), or -(CUDA error).
extern "C" int cc_blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_kernel, NT, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// The labels of a contiguous (X, Y, Z) uint8 mask into out (int32, the same
// shape, 16-byte aligned), in tiles of (TX, TY, TZ) (at most TILE_MAX
// voxels) on a cooperative grid of `blocks` (at most the card's resident
// blocks: cc_blocks_per_sm() x SMs; at most one a tile), one launch.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for bad sizes.
extern "C" int cc_label_u8(const void* mask, void* out, int X, int Y, int Z,
                           int TX, int TY, int TZ, int per_slice, int blocks,
                           int phases, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || TX < 1 || TY < 1 || TZ < 1 ||
      static_cast<int64_t>(TX) * TY * TZ > TILE_MAX || blocks < 1 ||
      phases < 1 || phases > 3 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  Vol v;
  v.X = X;
  v.Y = Y;
  v.Z = Z;
  v.TX = TX;
  v.TY = TY;
  v.TZ = TZ;
  v.ntx = (X + TX - 1) / TX;
  v.nty = (Y + TY - 1) / TY;
  v.ntz = (Z + TZ - 1) / TZ;
  const int64_t n_tiles = static_cast<int64_t>(v.ntx) * v.nty * v.ntz;
  if (blocks > n_tiles) blocks = static_cast<int>(n_tiles);  // each a tile
  v.per_slice = per_slice;
  // every tile row starts on a 4-voxel boundary and holds a multiple of 4
  v.vec = Z % 4 == 0 && (TZ >= Z || TZ % 4 == 0) &&
          reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  v.vec16 = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<int*>(out);
  void* args[] = {&m, &o, &v, &phases};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cc_kernel), dim3(blocks), dim3(NT), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
