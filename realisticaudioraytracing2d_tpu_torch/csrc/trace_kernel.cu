// Rays x walls sweeps for Hopper (sm_90a): nearest wall and occlusion
// minimum of a batch of rays against a whole wall table.
//
// Replaces two TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/trace_kernel.py):
//   _nearest_kernel (K1, through nearest_hit_pallas): the minimum distance
//     and the index of the nearest wall of each ray, -1 on a miss;
//   _occlusion_kernel (K2, through occlusion_min_pallas): the minimum
//     distance alone, for the shadow rays of next-event estimation.
// They serve the plain trace (ops/trace.py::trace(use_kernels=True)), whose
// two [rays, walls] passes they replace without ever writing the [R, W]
// distance matrix to device memory, and diffraction's visibility sweeps
// (ops/diffraction.py). The semantics are those of ops/geometry.py::
// pairwise_ray_segment_t followed by nearest_hit / min, in the same IEEE
// operation order (wall_exact of trace_common.cuh, --fmad=false), so
// distances and indices equal the plain version's bit for bit: a minimum
// does not depend on the order it is taken in. The TPU layout (rays [Rp, 8]
// padded to tiles of 512, walls [8, Wp] on lanes) is not carried over.
//
// Two things no caller reads are skipped on both routes: a ray whose
// `alive` byte is 0 returns (kInf, -1) without a sweep, and a ray with a
// `limit` starts its running minimum there, so walls at or past it are
// filtered out early, and returns kInf where the minimum is not below it
// (the exact minimum where it is). Without either, K1 and K2 are the TPU
// kernels' functions.
//
// Two routes, chosen by the wrapper by the wall count
// (ops/cuda/trace_kernel.py::BOX_WALK_MIN_WALLS):
//
// wall_sweep_kernel<kWantIndex> (brute force, small scenes):
//  * One thread per ray, its origin and direction in registers.
//  * The wall table is [5, W] (ax, ay, v2x, v2y, cc). A block stages it
//    through shared memory in tiles of kTileWalls walls (one float4 of
//    geometry and cc per wall), so any wall count works.
//  * A tile is swept by scan_nearest of trace_common.cuh: a division-free
//    filter over 32 walls at a time, bounded by the running minimum, then
//    the exact test (two IEEE divides) on the few walls it leaves, lowest
//    index first; tiles in ascending order, and a later tile replaces the
//    index only with a strictly smaller distance, so the lowest index wins
//    among equal distances (the plain version's argmin rule). Padding
//    walls (a == b) are parallel to every ray and never hit.
//
// box_sweep_kernel<kWantIndex> (the box walk, large scenes):
//  * The Morton-sorted wall table and cluster boxes of ops/cuda/
//    accel_kernel.py::prepare (cached per scene: the geo plane [Wp, 4], cc,
//    the cluster and super boxes, and ids [Wp], the caller's index of each
//    sorted wall), walked by K8's warp-coherent walk (box_walk.cuh): the
//    rays' votes skip the boxes none of a warp's rays can hit nearer than
//    its running minimum.
//  * The wrapper sorts the rays once per call along a Morton curve of their
//    origins (ops/accel.py::morton_ray_keys; masked rays get the largest
//    key, so whole warps and blocks of them exit at once); slot s reads its
//    ray through the permutation and writes the result to the ray's own
//    place. Without the sort, a warp's rays after a diffuse bounce sit all
//    over the scene and its votes descend into the union of their boxes.
//    The L shadow rays of one origin share its key and stay neighbours.
//  * The tie rule: the sorted table's order is not the caller's, so the
//    scan (OriginalIdScan) compares (t, ids[i]) and keeps the lowest
//    original index among equal distances, whatever the visit order: the
//    plain version's argmin. K2 keeps the minimum alone.
//
// What bounds them: instruction rate. The work counted (three u64: wall
// tests, sweeps, slab tests, as K8 counts them) is what each unmasked ray
// needs: brute force, every wall of the table; the box walk, the walls of
// the clusters whose boxes the ray's own slab tests passed against its
// running minimum, 16 FP32 operations per slab test. A wall test is 13
// FP32 operations (two divides) plus 3 per sweep; the filter's ~18
// executed instructions per wall set the pace, and without multiply-add
// contraction (--fmad=false) half of the FP32 peak is out of reach by
// construction. Every thread of a warp reads the same wall (shared-memory
// broadcast on the brute route, a 16-byte L2 load on the box walk).

#include "box_walk.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kTileWalls = 1024;   // 1024 walls x 20 B = 20 KB
constexpr int kGeoFields = 5;      // AX, AY, V2X, V2Y, CC of WallField
constexpr size_t kStaticSmemBytes = 48 * 1024;

// The rays of one call: origins and directions [n, 2], and per ray an
// optional alive byte (0: return (kInf, -1) unswept) and an optional limit.
struct SweepRays {
  const float* origins;
  const float* dirs;
  int n;
  const unsigned char* alive;
  const float* limit;
};

// What a sweep hands back for a ray whose running minimum, started at
// min(limit, kInf), ended at `closest` (`hit` the index kept with it).
template <bool kWantIndex>
__device__ __forceinline__ void store_sweep(float* tmin, int* idx, int ray,
                                            float closest, float limit,
                                            int hit) {
  const float t = closest < limit ? closest : kInf;
  tmin[ray] = t;
  if (kWantIndex) idx[ray] = t < kInf ? hit : -1;
}

template <bool kWantIndex, int kLanes>
__global__ void __launch_bounds__(kSweepThreads) wall_sweep_kernel(
    SweepRays rays, const float* __restrict__ walls, int n_walls,
    float* __restrict__ tmin, int* __restrict__ idx,
    unsigned long long* __restrict__ work_out) {
  __shared__ float4 s_walls[kGeoFields * kTileWalls / 4];
  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const bool in_range = ray < rays.n;
  const bool live = in_range && (rays.alive == nullptr || rays.alive[ray]);
  float ox = 0.0f, oy = 0.0f, dx = 1.0f, dy = 0.0f, limit = kInf;
  if (live) {
    ox = rays.origins[2 * ray];
    oy = rays.origins[2 * ray + 1];
    dx = rays.dirs[2 * ray];
    dy = rays.dirs[2 * ray + 1];
    if (rays.limit != nullptr) limit = rays.limit[ray];
  }
  const Probe q = make_probe(ox, oy, dx, dy);
  float closest = fminf(limit, kInf);
  int hit = 0x7fffffff;
  if (__syncthreads_or(live)) {  // a block of masked rays sweeps nothing
    for (int base = 0; base < n_walls; base += kTileWalls) {
      const int n_tile = min(kTileWalls, n_walls - base);
      __syncthreads();   // the previous tile is no longer read
      const WallTable tile = load_wall_table(
          walls, n_walls, base, n_tile, 0, reinterpret_cast<float*>(s_walls));
      __syncthreads();
      if (live) {
        int lo = 0, count = n_tile;  // a lane of a group: its part
        if constexpr (kLanes > 1) {
          const LaneGroup<kLanes> group = LaneGroup<kLanes>::mine(n_tile);
          lo = group.lo;
          count = group.count;
        }
        const float before = closest;
        int best = 0x7fffffff;
        scan_nearest(tile, lo, count, q, closest, best);
        if (kWantIndex && closest < before) hit = base + best;
      }
    }
  }
  bool lead = true;
  if constexpr (kLanes > 1) {
    const LaneGroup<kLanes> group = LaneGroup<kLanes>::mine(1);
    if (live) group.min_hit(closest, hit);
    lead = group.lead();
  }
  if (in_range && lead)
    store_sweep<kWantIndex>(tmin, idx, ray, closest, limit, hit);
  if (work_out != nullptr) {
    Work work;
    if (live && lead) {
      work.tests = n_walls;
      work.sweeps = 1;
    }
    add_work(work, work_out);
  }
}

// scan_nearest on the sorted table under the caller's tie rule: among equal
// distances the lowest original index ids[i] (kWantIndex, K1), or the
// minimum alone (K2). The same filter and exact test in the same order.
template <bool kWantIndex>
struct OriginalIdScan {
  const int* ids;

  __device__ __forceinline__ void operator()(const WallTable& w, int lo,
                                             int count, const Probe& q,
                                             float& closest,
                                             int& best) const {
    for (int base = lo; base < lo + count; base += 32) {
      unsigned m = wall_candidates(w, base, min(32, lo + count - base), q);
      while (m) {
        const int i = base + __ffs(m) - 1;
        m &= m - 1;
        const float4 g = w.geo[i];
        const float cc = w.cc[i];
        if (!wall_in_reach(g, cc, q, closest * kSlackHi)) continue;
        const float t = wall_exact(g, cc, q);
        if (kWantIndex) {
          if (t < closest || (t == closest && __ldg(ids + i) < best)) {
            closest = t;
            best = __ldg(ids + i);
          }
        } else if (t < closest) {
          closest = t;
        }
      }
    }
  }
};

// The box walk: slot = blockIdx.x * 256 + threadIdx.x sweeps ray perm[slot].
// Shared memory: the super boxes [S] (16 B), the block's visit order and
// its sort keys (4 B each).
template <bool kWantIndex>
__global__ void __launch_bounds__(kAccelThreads) box_sweep_kernel(
    SweepRays rays, const long long* __restrict__ perm,
    const float4* __restrict__ geo, const float* __restrict__ cc,
    const int* __restrict__ ids, int n_walls,
    const float4* __restrict__ aabb, const float4* __restrict__ saabb,
    int n_clusters, int group, int cluster_size, float* __restrict__ tmin,
    int* __restrict__ idx, unsigned long long* __restrict__ work_out) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = slot < rays.n;
  const int ray = in_range ? static_cast<int>(perm[slot]) : 0;
  const bool live = in_range && (rays.alive == nullptr || rays.alive[ray]);
  if (in_range && !live)
    store_sweep<kWantIndex>(tmin, idx, ray, kInf, kInf, 0);
  extern __shared__ float4 s_sup[];
  Work work;
  if (__syncthreads_or(live)) {  // the sorted tail: all masked
    const int n_super = n_clusters / group;
    int* s_order = reinterpret_cast<int*>(s_sup + n_super);
    unsigned* s_keys = reinterpret_cast<unsigned*>(s_order + n_super);
    for (int i = threadIdx.x; i < n_super; i += blockDim.x)
      s_sup[i] = saabb[i];
    const Boxes bx{aabb, s_sup, s_order, n_super, group, cluster_size};
    float ox = 0.0f, oy = 0.0f, dx = 1.0f, dy = 0.0f, limit = kInf;
    if (live) {
      ox = rays.origins[2 * ray];
      oy = rays.origins[2 * ray + 1];
      dx = rays.dirs[2 * ray];
      dy = rays.dirs[2 * ray + 1];
      if (rays.limit != nullptr) limit = rays.limit[ray];
    }
    order_super_boxes(bx, live, ox, oy, s_order, s_keys);
    const WallTable table{geo, cc, nullptr, n_walls};
    int hit;
    const float closest = nearest<true>(
        table, bx, live, make_probe(ox, oy, dx, dy), hit, work,
        fminf(limit, kInf), OriginalIdScan<kWantIndex>{ids});
    if (live) store_sweep<kWantIndex>(tmin, idx, ray, closest, limit, hit);
  }
  if (work_out != nullptr) add_work(work, work_out);
}

// keys[n] = ops/accel.py::morton_ray_keys of origin n within bounds (lo x,
// lo y, span x, span y), kDeadKey where alive[n] is 0: the order the box
// walk sweeps its rays in (one torch.sort of the keys between the launches).
__global__ void __launch_bounds__(kSweepThreads) ray_keys_kernel(
    const float* __restrict__ origins, int n,
    const unsigned char* __restrict__ alive, const float* __restrict__ bounds,
    long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  keys[i] = alive == nullptr || alive[i]
                ? morton_ray_key(origins[2 * i], origins[2 * i + 1], bounds)
                : kDeadKey;
}

size_t box_smem_bytes(int n_clusters, int group) {
  return 24 * static_cast<size_t>(n_clusters / group);
}

}  // namespace

extern "C" {

// Brute force: tmin[N] (f32) = the least wall_exact of ray n = (origins[n],
// dirs[n]) over the n_walls walls of walls [5, W] (ax, ay, v2x, v2y, cc),
// kInf on a miss; if idx is not null (K1) also idx[N] (i32), the lowest
// index of a wall at that distance, -1 on a miss; with idx null it is K2.
// alive [N] (u8) and limit [N] (f32) may be null: a ray whose alive byte
// is 0 gives (kInf, -1) unswept; with a limit a ray gives its minimum where
// it is below limit[n] and kInf elsewhere. work, if not null, three device
// u64 (wall tests, sweeps, slab tests) it adds to. origins and dirs are
// [N, 2] f32, all pointers device memory. Returns a cudaError_t code (0 =
// launched).
int art_wall_sweep(const float* origins, const float* dirs, int n_rays,
                   const unsigned char* alive, const float* limit,
                   const float* walls, int n_walls, float* tmin, int* idx,
                   unsigned long long* work, int lanes, void* stream) {
  if (n_rays < 1 || n_walls < 1 || (lanes != 1 && lanes != kLaneGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const SweepRays rays{origins, dirs, n_rays, alive, limit};
  const long long threads = static_cast<long long>(n_rays) * lanes;
  const int grid =
      static_cast<int>((threads + kSweepThreads - 1) / kSweepThreads);
  const auto launch = [&](auto kernel, int* out_idx) {
    kernel<<<grid, kSweepThreads, 0, s>>>(rays, walls, n_walls, tmin, out_idx,
                                          work);
  };
  if (idx != nullptr)
    lanes == 1 ? launch(wall_sweep_kernel<true, 1>, idx)
               : launch(wall_sweep_kernel<true, kLaneGroup>, idx);
  else
    lanes == 1 ? launch(wall_sweep_kernel<false, 1>, nullptr)
               : launch(wall_sweep_kernel<false, kLaneGroup>, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// keys [N] (i64): ops/accel.py::morton_ray_keys of origins [N, 2] within
// bounds [4] (lo x, lo y, span x, span y), 0xFFFFFFFF where alive [N] (u8,
// may be null) is 0. Returns a cudaError_t code.
int art_ray_keys(const float* origins, int n, const unsigned char* alive,
                 const float* bounds, long long* keys, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  ray_keys_kernel<<<(n + kSweepThreads - 1) / kSweepThreads, kSweepThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(origins, n, alive,
                                                            bounds, keys);
  return static_cast<int>(cudaGetLastError());
}

// The box walk: the same results as art_wall_sweep on the caller's table,
// from its Morton-sorted form: geo [W, 4] (ax, ay, v2x, v2y) and cc [W] of
// the sorted walls, ids [W] (i32) the caller's index of each, aabb [C, 4]
// the boxes of the C = W / cluster_size clusters, saabb [C / group, 4] the
// super boxes (ops/cuda/accel_kernel.py::prepare). perm [N] (i64) is the
// order the rays are swept in (a permutation of 0 .. N - 1: the rays
// sorted by ops/accel.py::morton_ray_keys); results land at the rays' own
// indices. Returns a cudaError_t code.
int art_box_sweep(const float* origins, const float* dirs, int n_rays,
                  const unsigned char* alive, const float* limit,
                  const long long* perm, const float* geo, const float* cc,
                  const int* ids, int n_walls, const float* aabb,
                  const float* saabb, int n_clusters, int group,
                  int cluster_size, float* tmin, int* idx,
                  unsigned long long* work, void* stream) {
  if (n_rays < 1 || perm == nullptr || n_clusters < 1 || group < 1 ||
      cluster_size < 1 || n_clusters % group != 0 ||
      static_cast<long long>(n_clusters) * cluster_size != n_walls)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = box_smem_bytes(n_clusters, group);
  if (smem > kStaticSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const SweepRays rays{origins, dirs, n_rays, alive, limit};
  const int grid = (n_rays + kAccelThreads - 1) / kAccelThreads;
  const auto* g4 = reinterpret_cast<const float4*>(geo);
  const auto* a4 = reinterpret_cast<const float4*>(aabb);
  const auto* s4 = reinterpret_cast<const float4*>(saabb);
  if (idx != nullptr)
    box_sweep_kernel<true><<<grid, kAccelThreads, smem, s>>>(
        rays, perm, g4, cc, ids, n_walls, a4, s4, n_clusters, group,
        cluster_size, tmin, idx, work);
  else
    box_sweep_kernel<false><<<grid, kAccelThreads, smem, s>>>(
        rays, perm, g4, cc, ids, n_walls, a4, s4, n_clusters, group,
        cluster_size, tmin, nullptr, work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
