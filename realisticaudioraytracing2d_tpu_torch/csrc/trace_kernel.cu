// Rays x walls sweeps for Hopper (sm_90a): nearest wall and occlusion
// minimum of a batch of rays against a whole wall table.
//
// Replaces two TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/trace_kernel.py):
//   _nearest_kernel (K1, through nearest_hit_pallas): the minimum distance
//     and the index of the nearest wall of each ray, -1 on a miss;
//   _occlusion_kernel (K2, through occlusion_min_pallas): the minimum
//     distance alone, for the shadow rays of next-event estimation.
// Both are one template, wall_sweep_kernel<kWantIndex>. They serve the
// plain trace (ops/trace.py::trace(use_kernels=True)), whose two
// [rays, walls] passes they replace without ever writing the [R, W]
// distance matrix to device memory; the rest of that bounce stays tensor
// code. The semantics are those of ops/geometry.py::pairwise_ray_segment_t
// followed by nearest_hit / min, in the same IEEE operation order (wall_exact
// of trace_common.cuh, --fmad=false), so distances and indices equal the
// plain version's bit for bit: a minimum does not depend on the order it is
// taken in. The TPU layout (rays [Rp, 8] padded to tiles of 512, walls
// [8, Wp] on lanes) is not carried over.
//
// Design:
//  * One thread per ray, its origin and direction in registers.
//  * The wall table is [5, W] (ax, ay, v2x, v2y, cc). A block stages it
//    through shared memory in tiles of kTileWalls walls (one float4 of
//    geometry and cc per wall), so any wall count works: the 5,280-wall
//    limit of the whole-table kernels does not apply.
//  * A tile is swept by scan_nearest of trace_common.cuh: a division-free
//    filter over 32 walls at a time, bounded by the running minimum, then
//    the exact test (two IEEE divides) on the few walls it leaves, lowest
//    index first; tiles in ascending order, and a later tile replaces the
//    index only with a strictly smaller distance, so the lowest index wins
//    among equal distances (the plain version's argmin rule). Padding
//    walls (a == b) are parallel to every ray and never hit.
//  * K2 returns the full minimum and cannot stop at the first blocker: its
//    caller compares the minimum with the listener distance less a slack.
//
// What bounds it: N rays x W walls tests of 13 FP32 operations (two
// divides) plus 3 per ray, against 16 bytes in and 4-8 out per ray and the
// table once. At the published peaks (67 TFLOP/s, 3.35 TB/s) the bytes set
// the bound up to ~37 walls (SmollRoom's 24) and the operations beyond
// (the 10,008-wall city). Every thread of a warp reads the same wall from
// shared memory (a broadcast); the filter's ~18 executed instructions per
// wall set the pace, and without multiply-add contraction (--fmad=false)
// half of the FP32 peak is out of reach by construction.

#include "trace_common.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kTileWalls = 1024;   // 1024 walls x 20 B = 20 KB
constexpr int kGeoFields = 5;      // AX, AY, V2X, V2Y, CC of WallField

template <bool kWantIndex>
__global__ void __launch_bounds__(kSweepThreads) wall_sweep_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    int n_rays, const float* __restrict__ walls, int n_walls,
    float* __restrict__ tmin, int* __restrict__ idx) {
  __shared__ float4 s_walls[kGeoFields * kTileWalls / 4];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n_rays;
  float ox = 0.0f, oy = 0.0f, dx = 1.0f, dy = 0.0f;
  if (live) {
    ox = origins[2 * ray];
    oy = origins[2 * ray + 1];
    dx = dirs[2 * ray];
    dy = dirs[2 * ray + 1];
  }
  const Probe q = make_probe(ox, oy, dx, dy);
  float closest = kInf;
  int hit = 0;   // argmin of an all-kInf row is 0, turned into -1 below
  for (int base = 0; base < n_walls; base += kTileWalls) {
    const int n_tile = min(kTileWalls, n_walls - base);
    __syncthreads();   // the previous tile is no longer read
    const WallTable tile = load_wall_table(
        walls, n_walls, base, n_tile, 0, reinterpret_cast<float*>(s_walls));
    __syncthreads();
    if (live) {
      const float before = closest;
      int best = 0x7fffffff;
      scan_nearest(tile, 0, n_tile, q, closest, best);
      if (kWantIndex && closest < before) hit = base + best;
    }
  }
  if (live) {
    tmin[ray] = closest;
    if (kWantIndex) idx[ray] = closest >= kInf ? -1 : hit;
  }
}

}  // namespace

extern "C" {

// tmin[N] (f32) = the least wall_exact of ray n = (origins[n], dirs[n]) over
// the n_walls walls of walls [5, W] (ax, ay, v2x, v2y, cc), kInf on a
// miss; if idx is not null (K1) also idx[N] (i32), the lowest index of a
// wall at that distance, -1 on a miss; with idx null it is K2. origins and
// dirs are [N, 2] f32, all pointers device memory. Returns a cudaError_t
// code (0 = launched).
int art_wall_sweep(const float* origins, const float* dirs, int n_rays,
                   const float* walls, int n_walls, float* tmin, int* idx,
                   void* stream) {
  if (n_rays < 1 || n_walls < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = (n_rays + kSweepThreads - 1) / kSweepThreads;
  if (idx != nullptr)
    wall_sweep_kernel<true><<<grid, kSweepThreads, 0, s>>>(
        origins, dirs, n_rays, walls, n_walls, tmin, idx);
  else
    wall_sweep_kernel<false><<<grid, kSweepThreads, 0, s>>>(
        origins, dirs, n_rays, walls, n_walls, tmin, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
