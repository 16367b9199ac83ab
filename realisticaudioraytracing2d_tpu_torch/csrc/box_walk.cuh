// The warp-coherent walk over the cluster tables of a Morton-sorted wall
// table (ops/accel.py::cluster_scene): shared by the cluster kernels
// (accel_kernel.cu: K7, K8) and the box-walk route of the wall sweeps
// (trace_kernel.cu: K1, K2).
//
// A ray slab-tests each super box against its running closest hit,
// descends into the super box's clusters only on a hit, slab-tests each
// cluster box, and scans a cluster's walls only on a hit; the 32 rays of a
// warp take these steps together (__any_sync) and skip a box only if no
// lane's own test passed, so what a lane computes depends on its own tests
// alone. Each block visits the super boxes near to far from the centroid of
// its live rays (order_super_boxes). Between walks the rays are sorted by
// the Morton key of their positions (morton_ray_key), so a warp's rays are
// neighbours. The slab test is the JAX package's (_slab_inv clamps |d| at
// 1e-12; inverted padding boxes never hit; 1e-3 slack): it only skips
// work, and the scans keep a total order among equal distances, so the
// result does not depend on the visit order.

#pragma once

#include "trace_common.cuh"

namespace {

constexpr int kAccelThreads = 256;
constexpr int kAccelWarps = kAccelThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr long long kDeadKey = 0xFFFFFFFFll;  // a dead ray sorts last

struct Boxes {
  const float4* cl;   // [C] cluster boxes (xmin, ymin, xmax, ymax), global
  const float4* sup;  // [S] super boxes, S = C / group, shared memory
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

// The wall scan of K7/K8: scan_nearest, the lowest index of the sorted
// table among equal distances.
struct TableIndexScan {
  __device__ __forceinline__ void operator()(const WallTable& w, int lo,
                                             int count, const Probe& q,
                                             float& closest,
                                             int& best) const {
    scan_nearest(w, lo, count, q, closest, best);
  }
};

// Nearest wall of each lane's ray: the smallest distance under `closest`
// (kInf: any), and `hit` the index `scan` keeps among equal distances, -1
// for a miss (a caller that starts under kInf reads only the distance).
// Every lane of the warp must call it (`live` false for a lane without a
// ray): the warp walks the boxes together and skips a box only if no
// lane's own slab test passed. The work counted is the lane's own: every
// super box, the cluster boxes of the super boxes it passed, the walls of
// the clusters it passed. Without kEarlyOut every cluster is visited and no
// box is tested.
template <bool kEarlyOut, class Scan = TableIndexScan>
__device__ __forceinline__ float nearest(const WallTable& w, const Boxes& bx,
                                         bool live, const Probe& q, int& hit,
                                         Work& work, float closest = kInf,
                                         const Scan& scan = Scan{}) {
  int best = 0x7fffffff;
  const float ix = slab_inv(q.dx), iy = slab_inv(q.dy);
  const int cs = bx.cluster_size;
  for (int s = 0; s < bx.n_super; ++s) {
    const int ss = bx.order != nullptr ? bx.order[s] : s;
    bool in_super = live;
    if (kEarlyOut) {
      in_super = live && slab_hit(bx.sup[ss], q.ox, q.oy, ix, iy, closest);
      if (!__any_sync(kFullMask, in_super)) continue;
    }
    for (int g = 0; g < bx.group; ++g) {
      const int c = ss * bx.group + g;
      bool in_cluster = in_super;
      if (kEarlyOut && bx.group > 1) {  // group 1: the super box is it
        in_cluster = in_super &&
                     slab_hit(__ldg(bx.cl + c), q.ox, q.oy, ix, iy, closest);
        work.slabs += in_super;
        if (!__any_sync(kFullMask, in_cluster)) continue;
      }
      if (in_cluster) {
        scan(w, c * cs, cs, q, closest, best);
        work.tests += cs;
      }
    }
  }
  if (live) {
    if (kEarlyOut) work.slabs += bx.n_super;
    ++work.sweeps;
  }
  hit = closest < kInf ? best : -1;
  return closest;
}

// Spread the low 10 bits of x to every third bit (ops/accel.py::_part1by2).
__device__ __forceinline__ unsigned part1by2(unsigned x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

// clip((p - lo) / span * 1023, 0, 1023) truncated, in float32 and in the
// operation order of ops/accel.py::_quantize.
__device__ __forceinline__ unsigned quantize10(float p, float lo,
                                               float span) {
  const float q = fminf(fmaxf((p - lo) / span * 1023.0f, 0.0f), 1023.0f);
  return static_cast<unsigned>(static_cast<int>(q));
}

// Sort key of a live ray at (px, py): ops/accel.py::morton_ray_keys bit for
// bit. bounds = (lo x, lo y, span x, span y) of the scene's boxes.
__device__ __forceinline__ long long morton_ray_key(float px, float py,
                                                    const float* bounds) {
  return static_cast<long long>(
      part1by2(quantize10(px, bounds[0], bounds[2])) |
      (part1by2(quantize10(py, bounds[1], bounds[3])) << 1));
}

// The block's near-to-far order of the super boxes into s_order: the
// centroid of the block's live rays (a block reduction over (x, y, 1)),
// the squared distance of each box's centre from it, and each box's rank
// among them (ties by index; the distances are compared by their bit
// patterns, a total order that sorts a NaN last, so the result is always
// a permutation). Every thread of the block (kAccelThreads) calls it; it
// ends with a barrier. ops/accel.py::block_rank_order mirrors it.
__device__ __forceinline__ void order_super_boxes(const Boxes& bx, bool live,
                                                  float px, float py,
                                                  int* s_order,
                                                  unsigned* s_keys) {
  __shared__ float s_part[kAccelWarps][3];
  float sx = live ? px : 0.0f, sy = live ? py : 0.0f;
  float sn = live ? 1.0f : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_down_sync(kFullMask, sx, off);
    sy += __shfl_down_sync(kFullMask, sy, off);
    sn += __shfl_down_sync(kFullMask, sn, off);
  }
  if ((threadIdx.x & 31) == 0) {
    s_part[threadIdx.x >> 5][0] = sx;
    s_part[threadIdx.x >> 5][1] = sy;
    s_part[threadIdx.x >> 5][2] = sn;
  }
  __syncthreads();  // also: the super boxes are in shared memory
  sx = sy = sn = 0.0f;
  for (int i = 0; i < kAccelWarps; ++i) {
    sx += s_part[i][0];
    sy += s_part[i][1];
    sn += s_part[i][2];
  }
  const float cx = sx / fmaxf(sn, 1.0f), cy = sy / fmaxf(sn, 1.0f);
  for (int i = threadIdx.x; i < bx.n_super; i += blockDim.x) {
    const float4 b = bx.sup[i];
    const float ex = cx - 0.5f * (b.x + b.z), ey = cy - 0.5f * (b.y + b.w);
    s_keys[i] = __float_as_uint(ex * ex + ey * ey);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bx.n_super; i += blockDim.x) {
    const unsigned mine = s_keys[i];
    int rank = 0;
    for (int j = 0; j < bx.n_super; ++j) {
      const unsigned other = s_keys[j];
      rank += other < mine || (other == mine && j < i);
    }
    s_order[rank] = i;
  }
  __syncthreads();
}

}  // namespace
