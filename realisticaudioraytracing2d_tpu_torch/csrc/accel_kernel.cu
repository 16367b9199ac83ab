// Cluster-early-out kernels for large scenes on Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py):
//   _make_accel_kernel (K7, through trace_frames_ir_accel): emission, every
//     bounce and the IR binning of F frames in one launch, K <= 8 bands;
//   _make_accel_bounce_kernel (K8, through trace_frames_ir_accel_sorted):
//     one bounce of every ray of F frames per launch, the ray state in
//     global memory; between launches the host re-sorts the rays along a
//     Morton curve of their positions and gives each block a near-to-far
//     order of super boxes (ops/accel.py). K = 1.
// Both sweep a Morton-sorted wall table (ops/accel.py::cluster_scene)
// through a two-level hierarchy of boxes: a ray slab-tests a super box
// against its running closest hit, descends into the super box's
// clusters only on a hit, slab-tests each cluster, and runs the wall
// tests of a cluster only on a hit. The physics after the nearest-wall
// search is trace_common.cuh, shared with K3/K4/K9 (bounce_kernel.cu).
// The TPU layout (the tile-wide any-lane guard, the transposed [8, Wp]
// table, the one-hot MXU gather, the SMEM box tables) is not carried over.
//
// Design:
//  * One thread per ray. The early-out is per thread: each ray skips the
//    boxes it cannot hit on its own, like a BVH traversal with small
//    leaves (16 or 32 walls per cluster, ops/accel.py::accel_layout).
//  * The wall table ([11 + K - 1, Wp] struct of arrays, the bounce
//    kernel's layout plus one absorption row per extra band) stays in
//    global memory: 1.76 MB at 40,008 walls, 4.4 MB at 100,016, too large
//    for shared memory and resident in the 50 MB L2. The cluster and super
//    boxes (16 B each, at most ~4,100 clusters: ~66 KB) and the listeners
//    go to shared memory, and K8's per-block visit order beside them.
//  * The slab test is the JAX package's (_slab_inv clamps |d| at 1e-12;
//    padding boxes are inverted and never hit; 1e-3 slack). It only skips
//    work: the nearest hit keeps the lowest wall index among equal
//    distances whatever the visit order (t < closest, or t == closest and
//    a lower index), which is the ascending strict-'<' scan of K4 on the
//    same sorted table, and an occlusion sweep stops at the first blocker
//    it meets, so early_out on or off gives the same bits, and K7 (K = 1)
//    and K8 on a sorted scene give K4's.
//  * Random numbers: Philox-4x32-10, counter (ray, frame, bounce, 0), as
//    K4. K8 carries each ray's original (frame, ray) id through the
//    re-sorts and draws by it, so sorting never changes a ray's numbers:
//    K8 equals K4 bit for bit on a sorted scene (JAX's K8 pairs host
//    uniforms with tile positions and is only statistically equal).
//  * Bands (K7): up to 8 energies per ray in registers; the NEE and energy
//    cutoffs use the loudest band, as the plain trace does.
//  * IR: the u64 fixed-point [L, T, K] accumulator and per-call scale of
//    the bounce kernel; K8 accumulates over its B launches and converts
//    once at the end (art_fixed_to_float).
//  * Blocks whose rays are all dead return at once (K8: dead rays sort to
//    the tail).
//
// What bounds it: FP32 operations, as for K4, but counted on the walls a
// ray really tests: 13 per wall test, 3 per sweep, and 16 per slab test
// (4 subtractions, 4 multiplies, 7 min/max, 1 add; comparisons are not
// counted, as in wall_t). The optional work counter (three u64: wall
// tests, wall sweeps, slab tests) sums them per launch. Divergence within
// a warp (threads that descend into different boxes) and the scattered
// global loads of the wall table are what this simple design leaves on
// the table; wall tiles in shared memory, a persistent grid and
// warp-coherent traversal are later work.

#include "trace_common.cuh"

namespace {

constexpr int kAccelThreads = 256;
constexpr int kMaxBands = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB per block on sm_90

struct Boxes {
  const float4* cl;   // [C] cluster boxes (xmin, ymin, xmax, ymax)
  const float4* sup;  // [S] super boxes, S = C / group
  const int* order;   // [S] visit order of the super boxes, or nullptr
  int n_super, group, cluster_size;
};

// Slab reciprocal that never makes inf * 0 (bounce_kernel.py::_slab_inv).
__device__ __forceinline__ float slab_inv(float d) {
  const float mag = fmaxf(fabsf(d), 1e-12f);
  return (d >= 0.0f ? 1.0f : -1.0f) * (1.0f / mag);
}

// Can the ray o + t d, t in [EPS, tmax], meet box b? (bounce_kernel.py::
// _cluster_passes.slab_hit: inverted padding boxes never; 1e-3 slack.)
__device__ __forceinline__ bool slab_hit(float4 b, float ox, float oy,
                                         float ix, float iy, float tmax) {
  const float tx0 = (b.x - ox) * ix, tx1 = (b.z - ox) * ix;
  const float ty0 = (b.y - oy) * iy, ty1 = (b.w - oy) * iy;
  const float tnear = fmaxf(fminf(tx0, tx1), fminf(ty0, ty1));
  const float tfar = fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1));
  return b.z >= b.x && tfar >= kEps && tnear <= fminf(tfar, tmax) + 1e-3f;
}

// Call visit(first_wall) for each cluster the ray can meet before tmax()
// (re-read at every box, so a tightening closest prunes at once), super
// boxes first. visit returns false to end the walk. Without kEarlyOut
// every cluster is visited and no box is tested.
template <bool kEarlyOut, class TMax, class Visit>
__device__ __forceinline__ void walk(const Boxes& bx, float ox, float oy,
                                     float dx, float dy, TMax tmax,
                                     Visit visit, Work& work) {
  const float ix = slab_inv(dx), iy = slab_inv(dy);
  for (int s = 0; s < bx.n_super; ++s) {
    const int ss = bx.order != nullptr ? bx.order[s] : s;
    if (kEarlyOut) {
      ++work.slabs;
      if (!slab_hit(bx.sup[ss], ox, oy, ix, iy, tmax())) continue;
    }
    for (int g = 0; g < bx.group; ++g) {
      const int cc = ss * bx.group + g;
      if (kEarlyOut && bx.group > 1) {  // group 1: the super box is it
        ++work.slabs;
        if (!slab_hit(bx.cl[cc], ox, oy, ix, iy, tmax())) continue;
      }
      if (!visit(cc * bx.cluster_size)) return;
    }
  }
}

// Nearest wall: the lowest index among the smallest distances, -1 in
// `hit` for a miss.
template <bool kEarlyOut>
__device__ __forceinline__ float nearest(const float* w, int n,
                                         const Boxes& bx, float ox,
                                         float oy, float dx, float dy,
                                         int& hit, Work& work) {
  float closest = kInf;
  int best = 0x7fffffff;
  const int cs = bx.cluster_size;
  walk<kEarlyOut>(
      bx, ox, oy, dx, dy, [&] { return closest; },
      [&](int lo) {
        for (int i = lo; i < lo + cs; ++i) {
          const float t = wall_t(w, n, i, ox, oy, dx, dy);
          if (t < closest || (t == closest && i < best)) {
            closest = t;
            best = i;
          }
        }
        work.tests += cs;
        return true;
      },
      work);
  ++work.sweeps;
  hit = closest < kInf ? best : -1;
  return closest;
}

// Occlusion: does any wall cut the shadow ray before `limit`? Boxes are
// tested against `dist`, the listener's distance.
template <bool kEarlyOut>
__device__ __forceinline__ bool occluded(const float* w, int n,
                                         const Boxes& bx, float sx, float sy,
                                         float vdx, float vdy, float dist,
                                         float limit, Work& work) {
  bool blocked = false;
  const int cs = bx.cluster_size;
  walk<kEarlyOut>(
      bx, sx, sy, vdx, vdy, [&] { return dist; },
      [&](int lo) {
        for (int i = lo; i < lo + cs; ++i) {
          ++work.tests;
          if (wall_t(w, n, i, sx, sy, vdx, vdy) < limit) {
            blocked = true;
            return false;
          }
        }
        return true;
      },
      work);
  ++work.sweeps;
  return blocked;
}

// Shared memory of a block: cluster boxes, super boxes, then (K8) the
// block's visit order and the listeners.
__device__ __forceinline__ Boxes load_boxes(const float4* aabb,
                                            const float4* saabb,
                                            const int* order, int n_clusters,
                                            int group, int cluster_size,
                                            const float* listeners,
                                            int n_listeners, float4* smem,
                                            const float** s_lis) {
  const int n_super = n_clusters / group;
  float4* s_cl = smem;
  float4* s_sup = s_cl + n_clusters;
  int* s_order = reinterpret_cast<int*>(s_sup + n_super);
  float* lis = reinterpret_cast<float*>(s_order + (order ? n_super : 0));
  for (int i = threadIdx.x; i < n_clusters; i += blockDim.x)
    s_cl[i] = aabb[i];
  for (int i = threadIdx.x; i < n_super; i += blockDim.x) {
    s_sup[i] = saabb[i];
    if (order) s_order[i] = order[i];
  }
  for (int i = threadIdx.x; i < 2 * n_listeners; i += blockDim.x)
    lis[i] = listeners[i];
  __syncthreads();
  *s_lis = lis;
  return Boxes{s_cl, s_sup, order ? s_order : nullptr, n_super, group,
               cluster_size};
}

size_t smem_bytes(int n_clusters, int group, bool with_order,
                  int n_listeners) {
  const size_t n_super = n_clusters / group;
  return 16 * (static_cast<size_t>(n_clusters) + n_super) +
         (with_order ? 4 * n_super : 0) + 8 * static_cast<size_t>(n_listeners);
}

// K7: grid (ceil(R / 256), F); thread = (ray, frame), all bounces.
template <int kMaxK, bool kEarlyOut>
__global__ void __launch_bounds__(kAccelThreads) accel_frames_kernel(
    const float* __restrict__ walls, int n_walls, int n_bands,
    const float4* __restrict__ aabb, const float4* __restrict__ saabb,
    int n_clusters, int group, int cluster_size,
    const float* __restrict__ listeners, int n_listeners,
    const float* __restrict__ scal, float sr, uint32_t key0, uint32_t key1,
    int n_rays, int max_bounces, int ir_length,
    const double* __restrict__ scale, unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ work_out) {
  extern __shared__ float4 smem[];
  const float* s_lis;
  const Boxes bx = load_boxes(aabb, saabb, nullptr, n_clusters, group,
                              cluster_size, listeners, n_listeners, smem,
                              &s_lis);
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const int frame = blockIdx.y;
  Work work;
  if (ray < n_rays) {
    const Listeners lis{s_lis, n_listeners, scal[2] * scal[2], scal[3]};
    const Sink sink{acc, ir_length, n_bands, sr, *scale};
    auto occl = [&](float sx, float sy, float vdx, float vdy, float dist,
                    float limit) {
      return occluded<kEarlyOut>(walls, n_walls, bx, sx, sy, vdx, vdy, dist,
                                 limit, work);
    };
    Ray<kMaxK> r = emit_ray<kMaxK>(
        ray, n_rays,
        philox_uniforms(ray, frame, max_bounces, 0, key0, key1).u0, scal[0],
        scal[1], scal[3], scal[4]);
    for (int b = 0; b < max_bounces; ++b) {
      int hit;
      const float closest = nearest<kEarlyOut>(walls, n_walls, bx, r.px,
                                               r.py, r.dx, r.dy, hit, work);
      if (!finish_bounce<kMaxK>(r, closest, hit, walls, n_walls, lis, sink,
                                occl, [&] {
                                  return philox_uniforms(ray, frame, b, 0,
                                                         key0, key1);
                                }))
        break;
    }
  }
  if (work_out != nullptr) add_work(work, work_out);
}

// K8: one bounce of slot = blockIdx.x * 256 + threadIdx.x of the [F * R]
// ray state (state [8, N] f32, istate [2, N] i32 = id, depth; depth -1 =
// dead). Bounce 0 emits ray id = slot. order [n_blocks, S].
template <bool kEarlyOut>
__global__ void __launch_bounds__(kAccelThreads) accel_bounce_kernel(
    const float* __restrict__ walls, int n_walls,
    const float4* __restrict__ aabb, const float4* __restrict__ saabb,
    const int* __restrict__ order, int n_clusters, int group,
    int cluster_size, const float* __restrict__ listeners, int n_listeners,
    const float* __restrict__ scal, float sr, uint32_t key0, uint32_t key1,
    int n_rays, int n_slots, int max_bounces, int bounce, int ir_length,
    const double* __restrict__ scale, float* __restrict__ state,
    int* __restrict__ istate, unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ work_out) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  int id = slot, dep = 0;
  if (bounce > 0 && slot < n_slots) {
    id = istate[slot];
    dep = istate[n_slots + slot];
  }
  const bool live = slot < n_slots && dep >= 0;
  if (!__syncthreads_or(live)) return;  // the sorted tail: all dead

  extern __shared__ float4 smem[];
  const float* s_lis;
  const int n_super = n_clusters / group;
  const Boxes bx = load_boxes(
      aabb, saabb, order + static_cast<size_t>(blockIdx.x) * n_super,
      n_clusters, group, cluster_size, listeners, n_listeners, smem, &s_lis);
  Work work;
  if (live) {
    const int ray = id % n_rays, frame = id / n_rays;
    const Listeners lis{s_lis, n_listeners, scal[2] * scal[2], scal[3]};
    const Sink sink{acc, ir_length, 1, sr, *scale};
    Ray<1> r;
    if (bounce == 0) {
      r = emit_ray<1>(
          ray, n_rays,
          philox_uniforms(ray, frame, max_bounces, 0, key0, key1).u0,
          scal[0], scal[1], scal[3], scal[4]);
    } else {
      const float* s = state + slot;
      r.px = s[0];
      r.py = s[n_slots];
      r.dx = s[2 * static_cast<size_t>(n_slots)];
      r.dy = s[3 * static_cast<size_t>(n_slots)];
      r.en[0] = s[4 * static_cast<size_t>(n_slots)];
      r.tm = s[5 * static_cast<size_t>(n_slots)];
      r.ds = s[6 * static_cast<size_t>(n_slots)];
      r.sp = s[7 * static_cast<size_t>(n_slots)];
      r.dep = dep;
    }
    int hit;
    const float closest = nearest<kEarlyOut>(walls, n_walls, bx, r.px, r.py,
                                             r.dx, r.dy, hit, work);
    const bool alive = finish_bounce<1>(
        r, closest, hit, walls, n_walls, lis, sink,
        [&](float sx, float sy, float vdx, float vdy, float dist,
            float limit) {
          return occluded<kEarlyOut>(walls, n_walls, bx, sx, sy, vdx, vdy,
                                     dist, limit, work);
        },
        [&] { return philox_uniforms(ray, frame, bounce, 0, key0, key1); });
    float* s = state + slot;
    s[0] = r.px;
    s[n_slots] = r.py;
    s[2 * static_cast<size_t>(n_slots)] = r.dx;
    s[3 * static_cast<size_t>(n_slots)] = r.dy;
    s[4 * static_cast<size_t>(n_slots)] = r.en[0];
    s[5 * static_cast<size_t>(n_slots)] = r.tm;
    s[6 * static_cast<size_t>(n_slots)] = r.ds;
    s[7 * static_cast<size_t>(n_slots)] = r.sp;
    istate[slot] = id;
    istate[n_slots + slot] = alive ? r.dep : -1;
  }
  if (work_out != nullptr) add_work(work, work_out);
}

bool boxes_ok(int n_walls, int n_clusters, int group, int cluster_size,
              int n_listeners) {
  return n_clusters >= 1 && group >= 1 && cluster_size >= 1 &&
         n_clusters % group == 0 &&
         static_cast<long long>(n_clusters) * cluster_size == n_walls &&
         n_listeners >= 1 && n_listeners <= kMaxListeners;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kMaxK, bool kEarlyOut>
cudaError_t launch_frames(const float* walls, int n_walls, int n_bands,
                          const float* aabb, const float* saabb,
                          int n_clusters, int group, int cluster_size,
                          const float* listeners, int n_listeners,
                          const float* scal, float sr, uint32_t key0,
                          uint32_t key1, int n_rays, int max_bounces,
                          int n_frames, int ir_length, const double* scale,
                          unsigned long long* acc, float* out,
                          unsigned long long* work, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_clusters, group, false, n_listeners);
  cudaError_t err = allow_smem(accel_frames_kernel<kMaxK, kEarlyOut>, smem);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(n_listeners) * ir_length * n_bands;
  err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * n, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rays + kAccelThreads - 1) / kAccelThreads, n_frames);
  accel_frames_kernel<kMaxK, kEarlyOut><<<grid, kAccelThreads, smem, stream>>>(
      walls, n_walls, n_bands, reinterpret_cast<const float4*>(aabb),
      reinterpret_cast<const float4*>(saabb), n_clusters, group,
      cluster_size, listeners, n_listeners, scal, sr, key0, key1, n_rays,
      max_bounces, ir_length, scale, acc, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fixed_to_float(acc, scale, out, n, n, stream);
}

template <bool kEarlyOut>
cudaError_t launch_bounce(const float* walls, int n_walls, const float* aabb,
                          const float* saabb, const int* order,
                          int n_clusters, int group, int cluster_size,
                          const float* listeners, int n_listeners,
                          const float* scal, float sr, uint32_t key0,
                          uint32_t key1, int n_rays, int n_slots,
                          int max_bounces, int bounce, int ir_length,
                          const double* scale, float* state, int* istate,
                          unsigned long long* acc, unsigned long long* work,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(n_clusters, group, true, n_listeners);
  const cudaError_t err = allow_smem(accel_bounce_kernel<kEarlyOut>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_slots + kAccelThreads - 1) / kAccelThreads);
  accel_bounce_kernel<kEarlyOut><<<grid, kAccelThreads, smem, stream>>>(
      walls, n_walls, reinterpret_cast<const float4*>(aabb),
      reinterpret_cast<const float4*>(saabb), order, n_clusters, group,
      cluster_size, listeners, n_listeners, scal, sr, key0, key1, n_rays,
      n_slots, max_bounces, bounce, ir_length, scale, state, istate, acc,
      work);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: the frame-summed IR out[L, T, K] (f32) of n_frames frames of n_rays
// rays, drawn in the kernel under (key0, key1). walls [10 + K, W] (see
// WallField; W = n_clusters * cluster_size, Morton-sorted), aabb [C, 4],
// saabb [C / group, 4], listeners [L, 2], scal [5] = (source x, source y,
// listener radius, speed of sound, input gain), all device f32; scale one
// device double, acc [L, T, K] u64 scratch; work, if not null, three
// device u64 (wall tests, wall sweeps, slab tests). 1 <= K <= 8. Returns
// a cudaError_t code (0 = launched).
int art_accel_frames(const float* walls, int n_walls, int n_bands,
                     const float* aabb, const float* saabb, int n_clusters,
                     int group, int cluster_size, const float* listeners,
                     int n_listeners, const float* scal, float sr,
                     unsigned int key0, unsigned int key1, int n_rays,
                     int max_bounces, int n_frames, int ir_length,
                     const double* scale, unsigned long long* acc, float* out,
                     int early_out, unsigned long long* work, void* stream) {
  if (!boxes_ok(n_walls, n_clusters, group, cluster_size, n_listeners) ||
      n_bands < 1 || n_bands > kMaxBands || n_rays < 1 || n_frames < 1 ||
      n_frames > 65535 || max_bounces < 1 || ir_length < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define ART_FRAMES(K, E)                                                     \
  launch_frames<K, E>(walls, n_walls, n_bands, aabb, saabb, n_clusters,      \
                      group, cluster_size, listeners, n_listeners, scal, sr, \
                      key0, key1, n_rays, max_bounces, n_frames, ir_length,  \
                      scale, acc, out, work, s)
  cudaError_t err;
  if (n_bands == 1)
    err = early_out ? ART_FRAMES(1, true) : ART_FRAMES(1, false);
  else
    err = early_out ? ART_FRAMES(kMaxBands, true)
                    : ART_FRAMES(kMaxBands, false);
#undef ART_FRAMES
  return static_cast<int>(err);
}

// K8: one bounce (0 .. max_bounces - 1) of the n_slots = F * R rays whose
// state is state [8, n_slots] f32 (px py dx dy energy time distance
// speed) and istate [2, n_slots] i32 (id = frame * R + ray, depth; depth
// -1 = dead), updated in place; bounce 0 emits ray id = slot and reads no
// state. order [order_rows, C / group] i32: each block's visit order of the
// super boxes, one row per block of 256 rays; order_rows must be
// ceil(n_slots / 256), the grid. Hits add to acc [L, T] u64 (zeroed by the
// caller before bounce 0; art_fixed_to_float converts it after the last).
// Other arguments as art_accel_frames, K = 1.
int art_accel_bounce(const float* walls, int n_walls, const float* aabb,
                     const float* saabb, const int* order, int order_rows,
                     int n_clusters, int group, int cluster_size,
                     const float* listeners, int n_listeners,
                     const float* scal, float sr, unsigned int key0,
                     unsigned int key1, int n_rays, int n_slots,
                     int max_bounces, int bounce, int ir_length,
                     const double* scale, float* state, int* istate,
                     unsigned long long* acc, int early_out,
                     unsigned long long* work, void* stream) {
  if (!boxes_ok(n_walls, n_clusters, group, cluster_size, n_listeners) ||
      n_rays < 1 || n_slots < n_rays || n_slots % n_rays != 0 ||
      order_rows != (n_slots + kAccelThreads - 1) / kAccelThreads ||
      max_bounces < 1 || bounce < 0 || bounce >= max_bounces ||
      ir_length < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define ART_BOUNCE(E)                                                        \
  launch_bounce<E>(walls, n_walls, aabb, saabb, order, n_clusters, group,    \
                   cluster_size, listeners, n_listeners, scal, sr, key0,     \
                   key1, n_rays, n_slots, max_bounces, bounce, ir_length,    \
                   scale, state, istate, acc, work, s)
  const cudaError_t err = early_out ? ART_BOUNCE(true) : ART_BOUNCE(false);
#undef ART_BOUNCE
  return static_cast<int>(err);
}

// out[i] = acc[i] / scale[0] for the n values of one accumulator.
int art_fixed_to_float(const unsigned long long* acc, const double* scale,
                       float* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fixed_to_float(
      acc, scale, out, static_cast<size_t>(n), static_cast<size_t>(n),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
