// One synchronous (Jacobi) round of the per-slice 2-D minimax watershed
// flood, over a stack of slices laid out (z, x, y) contiguous.
//
// Replaces: 3deecelltracker_tpu/ops/pallas_kernels.py::flood_slices (body
// _flood_kernel), the same flood that ops/watershed.py::watershed_flood runs
// per z inside recalculate_cell_boundaries.  Every masked non-marker voxel
// takes the label of the marker reachable with the smallest (max elevation
// along the path, path length) in lexicographic order.
//
// What bounds it on an H100: memory traffic per round, times the number of
// rounds.  A round reads each voxel's label/cost/hops, elevation and update
// flag (its 4 neighbours' state mostly from L1/L2) and writes 12 bytes: for
// the bench stack (24 slices of 401x168, 1.6 M voxels) that is ~47 MB moved
// per round, ~14 us at the HBM's 3.35 TB/s, and the two ping-pong state sets
// (~39 MB) nearly fit the 50 MB L2.  At that size the per-round launch and
// the host's convergence check cost as much as the traffic.
//
// Design: one thread per voxel reads ONLY the previous round's buffers and
// writes the next (ping-pong in global memory), visiting neighbours in the
// order x-1, y-1, y+1, x+1 and updating only on a strictly better
// (cost, hops): this is _flood_kernel's round exactly.  An in-place
// (Gauss-Seidel) sweep would converge to a different labelling at exact
// (cost, hops) ties, so it is not used.  A voxel whose label, cost or hops
// changed stores 1 into its slice's change flag; the host reads the flags
// only every few rounds, which is safe because a converged state is a fixed
// point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void flood_round_kernel(const float* __restrict__ elev,
                                   const uint8_t* __restrict__ upd,
                                   const int32_t* __restrict__ lab_in,
                                   const float* __restrict__ cost_in,
                                   const float* __restrict__ hops_in,
                                   int32_t* __restrict__ lab_out,
                                   float* __restrict__ cost_out,
                                   float* __restrict__ hops_out,
                                   int32_t* __restrict__ changed, int S,
                                   int NX, int NY) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t total = static_cast<int64_t>(S) * NX * NY;
  if (idx >= total) return;
  const int yy = static_cast<int>(idx % NY);
  const int64_t r = idx / NY;
  const int xx = static_cast<int>(r % NX);
  const int s = static_cast<int>(r / NX);

  const int32_t lab = lab_in[idx];
  const float cost = cost_in[idx];
  const float hops = hops_in[idx];
  if (!upd[idx]) {
    lab_out[idx] = lab;
    cost_out[idx] = cost;
    hops_out[idx] = hops;
    return;
  }
  const float e = elev[idx];
  int32_t bl = lab;
  float bc = cost;
  float bh = hops;
  int64_t nb[4];
  bool ok[4];
  nb[0] = idx - NY; ok[0] = xx > 0;        // x - 1
  nb[1] = idx - 1;  ok[1] = yy > 0;        // y - 1
  nb[2] = idx + 1;  ok[2] = yy < NY - 1;   // y + 1
  nb[3] = idx + NY; ok[3] = xx < NX - 1;   // x + 1
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!ok[k]) continue;
    const int32_t nl = lab_in[nb[k]];
    if (nl <= 0) continue;
    const float cc = fmaxf(cost_in[nb[k]], e);
    const float ch = hops_in[nb[k]] + 1.0f;
    if (cc < bc || (cc == bc && ch < bh)) {
      bl = nl;
      bc = cc;
      bh = ch;
    }
  }
  lab_out[idx] = bl;
  cost_out[idx] = bc;
  hops_out[idx] = bh;
  if (bl != lab || bc != cost || bh != hops) changed[s] = 1;
}

}  // namespace

extern "C" int flood_round_f32(const void* elev, const void* upd,
                               const void* lab_in, const void* cost_in,
                               const void* hops_in, void* lab_out,
                               void* cost_out, void* hops_out, void* changed,
                               int S, int NX, int NY, void* stream) {
  const int64_t total = static_cast<int64_t>(S) * NX * NY;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  flood_round_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(elev), static_cast<const uint8_t*>(upd),
      static_cast<const int32_t*>(lab_in), static_cast<const float*>(cost_in),
      static_cast<const float*>(hops_in), static_cast<int32_t*>(lab_out),
      static_cast<float*>(cost_out), static_cast<float*>(hops_out),
      static_cast<int32_t*>(changed), S, NX, NY);
  return static_cast<int>(cudaGetLastError());
}
