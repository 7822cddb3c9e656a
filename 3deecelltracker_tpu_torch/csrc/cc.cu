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
// What bounds it on an H100: memory traffic and, for long thin components,
// the depth of the label trees.  Min-propagation (the Pallas kernel's design,
// and the JAX loop) needs one round per voxel of a component's diameter: a
// snake through a 401x168 slice takes tens of thousands of rounds.  A
// union-find needs none: one pass links every foreground edge, one pass
// flattens the trees.  Each pass reads the 1-byte mask and the 4-byte parent
// array once plus the 13 (or 4) forward neighbours, mostly from L1/L2: for
// the pipeline frame (401, 168, 24), 1.6 M voxels, that is ~10 MB per pass.
//
// Design: the atomic union-find of ECL-CC (Jaiganesh & Burtscher 2018) on the
// voxel grid.  parent[i] = i for foreground voxels; one thread per voxel
// unites it with each foreground neighbour of larger flat index (the forward
// half of the neighbourhood).  A union hooks the larger root under the
// smaller with atomicCAS, which succeeds only on a current root, so parents
// always point to smaller indices within the component and the root of every
// tree is its component's minimum.  find() shortens the path it walks
// (intermediate pointer jumping; only non-roots are written, and only with
// ancestors, so the benign races keep every tree intact).  Loads that can see
// other threads' writes go through L2 (__ldcg): L1 is not coherent across SMs.
// A final pass writes each voxel's root as the output label.  No iteration
// cap and no host round trip: the three kernels run back to back on the
// stream.  Flat indices are int32; the wrapper refuses volumes of 2^31 voxels
// or more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(int* parent, int i) {
  int cur = __ldcg(parent + i);
  if (cur != i) {
    int prev = i;
    int next;
    while (cur > (next = __ldcg(parent + cur))) {
      parent[prev] = next;  // prev is not a root: only roots are CAS targets
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  int ra = find_root(parent, a);
  int rb = find_root(parent, b);
  while (ra != rb) {
    if (ra < rb) {
      const int old = atomicCAS(parent + rb, rb, ra);
      if (old == rb) return;
      rb = old;  // rb was hooked meanwhile: climb from its new parent
    } else {
      const int old = atomicCAS(parent + ra, ra, rb);
      if (old == ra) return;
      ra = old;
    }
  }
}

__global__ void cc_init_kernel(const uint8_t* __restrict__ mask,
                               int* __restrict__ parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = mask[i] ? i : -1;
}

__global__ void cc_merge_kernel(const uint8_t* __restrict__ mask,
                                int* parent, int X, int Y, int Z,
                                int per_slice) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = X * Y * Z;
  if (i >= n || !mask[i]) return;
  const int z = i % Z;
  const int y = (i / Z) % Y;
  const int x = i / (Y * Z);
  if (per_slice) {
    // forward half of the in-slice 8-neighbourhood: (0,+1), (+1,-1..+1)
    if (y + 1 < Y && mask[i + Z]) unite(parent, i, i + Z);
    if (x + 1 < X) {
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= Y) continue;
        const int j = i + (Y + dy) * Z;
        if (mask[j]) unite(parent, i, j);
      }
    }
    return;
  }
  // forward half of the 26-neighbourhood: every offset whose flat index is
  // larger, i.e. lexicographically positive (dx, dy, dz)
  for (int dx = 0; dx <= 1; ++dx) {
    const int xx = x + dx;
    if (xx >= X) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      if (dx == 0 && dy < 0) continue;
      const int yy = y + dy;
      if (yy < 0 || yy >= Y) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        if (dx == 0 && dy == 0 && dz <= 0) continue;
        const int zz = z + dz;
        if (zz < 0 || zz >= Z) continue;
        const int j = (xx * Y + yy) * Z + zz;
        if (mask[j]) unite(parent, i, j);
      }
    }
  }
}

__global__ void cc_finish_kernel(const uint8_t* __restrict__ mask,
                                 int* parent, int32_t* __restrict__ out,
                                 int n, int Z, int per_slice) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!mask[i]) {
    out[i] = 0;
    return;
  }
  const int root = find_root(parent, i);
  // a slice's voxels share z, so root = local * Z + z with the same z
  out[i] = per_slice ? root / Z + 1 : root + 1;
}

}  // namespace

extern "C" int cc_label_u8(const void* mask, void* parent, void* out, int X,
                           int Y, int Z, int per_slice, void* stream) {
  const int n = X * Y * Z;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* p = static_cast<int*>(parent);
  cc_init_kernel<<<blocks, kThreads, 0, s>>>(m, p, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_merge_kernel<<<blocks, kThreads, 0, s>>>(m, p, X, Y, Z, per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_finish_kernel<<<blocks, kThreads, 0, s>>>(
      m, p, static_cast<int32_t*>(out), n, Z, per_slice);
  return static_cast<int>(cudaGetLastError());
}
