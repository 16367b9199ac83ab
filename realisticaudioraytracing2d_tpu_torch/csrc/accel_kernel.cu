// Cluster-early-out kernel for large scenes on Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py):
//   _make_accel_kernel (K7, through trace_frames_ir_accel): emission, every
//     bounce and the IR binning of F frames, any K bands;
//   _make_accel_bounce_kernel (K8, through trace_frames_ir_accel_sorted):
//     one bounce of every ray of F frames per launch, K = 1.
// Both are one kernel here, accel_bounce_kernel<kMaxK, kEarlyOut,
// kDirective>: one bounce of every ray of F frames per launch, the ray
// state in global memory; between launches the rays are re-sorted along a
// Morton curve of their positions (one sort of keys the kernel wrote; the
// next launch reads its rays through the permutation), and each block
// visits the super boxes near to far from its rays. K8 is its kMaxK = 1
// instantiation; K7 its banded ones (kMaxK = 8, and kWideK for any K), and
// K7 at K = 1 launches K8's. The kernel sweeps a Morton-sorted wall table
// (ops/accel.py::cluster_scene) through a two-level hierarchy of boxes: a
// ray slab-tests a super box against its running closest hit, descends
// into the super box's clusters only on a hit, slab-tests each cluster,
// and runs the wall tests of a cluster only on a hit; the 32 rays of a
// warp take these steps together (the walk is box_walk.cuh, shared with
// the box walk of the wall sweeps K1/K2). The physics after the
// nearest-wall search is trace_common.cuh, shared with K3/K4/K9
// (bounce_kernel.cu).
// The TPU layout (the tile-wide any-lane guard, the transposed [8, Wp]
// table, the one-hot MXU gather, the SMEM box tables) is not carried over.
//
// Design:
//  * One thread per ray; a warp's 32 rays walk the boxes together. The
//    rays are re-sorted along a Morton curve of their positions between
//    bounces, so a warp's rays are neighbours and want mostly the same
//    boxes (without it, after the first diffuse bounce a warp's rays sit
//    all over the scene and its votes descend into the union of their
//    boxes: 6x the time at the same shape, PERF.md). In the nearest-wall
//    sweep
//    every lane slab-tests a super box against its own running closest
//    hit, and the warp descends if any lane passed (__any_sync); it then
//    slab-tests each cluster box the same way and enters a cluster if any
//    lane passed that. Inside, all entering lanes read the same wall at
//    the same time, one 16-byte load of its geometry from the global table
//    that the hardware broadcasts, and only lanes whose own slab tests
//    passed run the wall tests (predication); each keeps its own closest
//    hit. What a lane computes depends on its own tests alone; the votes
//    only let a warp skip what none of its lanes wants. An occlusion sweep
//    is called from inside the bounce, where a warp's lanes have diverged
//    (dead rays, rays inside walls, quiet listeners), so it walks the
//    boxes per lane.
//  * Wall tests: scan_nearest / scan_blocker of trace_common.cuh, a
//    division-free filter over a cluster's 16 or 32 walls, then, on the
//    few walls it leaves, a division-free reach test and the exact test
//    with its two IEEE divides.
//  * The wall table stays in global memory (1.76 MB at 40,008 walls, 4.4
//    MB at 100,016, resident in the 50 MB L2): the wrapper's rows [11 + K
//    - 1, Wp] for cc and the attributes, and a geo plane [Wp, 4] (ax, ay,
//    v2x, v2y) for the 16-byte loads. The cluster boxes (16 B each) stay
//    in global memory too: a warp reads one box at a time, the same for
//    all lanes. Only the super boxes (a few hundred), the block's visit
//    order and the listeners are in shared memory, a few KB per block.
//  * The bookkeeping between bounces is in the kernel. A launch reads
//    slot s's ray through the permutation of the last sort (state_in[:,
//    perm[s]]) and writes it to slot s of a second buffer, so nothing is
//    gathered between launches; it writes each ray's next Morton key
//    (ops/accel.py::morton_ray_keys bit for bit: the same float32
//    quantization in the same order; a dead ray gets the largest key), so
//    the host only sorts the keys; and each block orders the super boxes
//    near to far from the centroid of its live rays itself (a block
//    reduction, then a rank count in shared memory). The order only
//    changes how soon a lane's closest hit tightens, never the result.
//  * Bands (K7): a ray's K energies ride with it in an energy buffer
//    beside the state. The register bucket (K <= 8) keeps them ray-major,
//    [N, Kp] (Kp = K rounded up to 4): a row is read through the
//    permutation as K / 4 16-byte loads, where band-major would cost K
//    scattered 4-byte loads, and stored to the ray's new row after the
//    bounce. Past 8 the wide kernel (kWideK, any K) keeps them band-major,
//    [K, N]: it copies a ray's bands once and works on them in place, the
//    buffer taking the place of a scratch, and a warp's in-place updates
//    coalesce (each layout timed against the other, and a 32-band register
//    bucket, which spilled and lost to the wide kernel: PERF.md). The
//    wrapper runs frames whose buffers would exceed its cap in
//    passes of B launches (id0: the pass's first ray id). The NEE and
//    energy cutoffs use the loudest band, as the plain trace does; the
//    absorption of bands 1.. is read from the global table, for the hit
//    wall only.
//  * The slab test is the JAX package's (_slab_inv clamps |d| at 1e-12;
//    padding boxes are inverted and never hit; 1e-3 slack). It only skips
//    work: the nearest hit keeps the lowest wall index among equal
//    distances whatever the visit order (t < closest, or t == closest and
//    a lower index), which is the ascending scan of K4 on the same sorted
//    table, and an occlusion sweep stops at the first blocker it meets,
//    so early_out on or off gives the same bits, and K7 and K8 on a
//    sorted scene give K4's at every K.
//  * Random numbers: Philox-4x32-10, counter (ray, frame, bounce, entry),
//    as K4 (entry 0) and K9: a batch of large scenes (a sweep, a mixdown)
//    launches one entry at a time with its global entry id, so entry e
//    draws what entry e of K9 draws. Each ray carries its original (frame,
//    ray) id through the re-sorts and draws by it, so sorting never
//    changes a ray's numbers: the kernel equals K4 bit for bit on a sorted
//    scene (JAX's K8 pairs host uniforms with tile positions and is only
//    statistically equal). Frame f of a launch draws frame frame_offset +
//    f, as K4's frame_offset (a shard of a frame-sharded run): the offset
//    is its own argument, added to the counter's frame word only, so the
//    int32 id a ray carries stays the launch's own (an offset folded into
//    the id would overflow it at 16,383 frames of 131,072 rays), and K8
//    keeps its ids from 0.
//  * Listeners: a table sized from the launch in shared memory beside the
//    super boxes (8 B a listener); a caller whose listeners do not fit
//    launches them in blocks over the same random numbers (the wrapper).
//  * Directive sources and microphones: a template flag
//    (trace_common.cuh), the microphone table [L, C_m] in shared memory
//    beside the listeners; the emission at bounce 0 is weighted by ray id
//    = slot, reading the source row from global memory (shared memory is
//    written after emission), so the gain rides with the ray's energy
//    through every re-sort; the JAX K8 pre-weights emission on the host
//    because its sort permutes state columns.
//  * IR: the u64 fixed-point [L, T, K] accumulator and per-call scale of
//    the bounce kernel, accumulated over a call's launches and converted
//    once at the end (art_fixed_to_float).
//  * Blocks whose rays are all dead return at once (dead rays sort to the
//    tail), after writing their rays' keys and depths.
//
// What bounds it: instruction rate. The work the bound counts is what
// each ray needs under its own early out: 13 FP32 operations per wall
// test of a cluster whose box the ray's own slab test passed, 3 per
// sweep, and 16 per slab test (4 subtractions, 4 multiplies, 7 min/max, 1
// add; comparisons are not counted, as in the wall test): every super
// box, and the cluster boxes of the super boxes the ray passed. The
// optional work counter (three u64: wall tests, wall sweeps, slab tests)
// sums exactly that per launch, whatever the warp executed. A warp
// executes the union of its lanes' boxes, so the executed work exceeds
// the counted work by the spread of a warp's rays: the re-sort makes
// their positions neighbours, but after a diffuse bounce their directions
// point everywhere, and a warp descends into every box around it. Every
// lane also slab-tests every super box. The banded instantiations add K
// products per hit and bounce and K u64 atomics per hit, which the bound
// does not count. The divides no longer count (an ablation that replaces
// them moves nothing) and neither do the atomics. Measured shares:
// PERF.md.

#include <algorithm>

#include "box_walk.cuh"

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB per block on sm_90
// K7's largest register bucket of a ray's band energies (by_bucket)
constexpr int kAccelLargestBucket = 8;

// Occlusion: does any wall cut the shadow ray before `limit`? Boxes are
// tested against `dist`, the listener's distance; the walk is this lane's
// own and ends at the first blocker it meets.
template <bool kEarlyOut>
__device__ __forceinline__ bool occluded(const WallTable& w, const Boxes& bx,
                                         float sx, float sy, float vdx,
                                         float vdy, float dist, float limit,
                                         Work& work) {
  const Probe q = make_probe(sx, sy, vdx, vdy);
  const float ix = slab_inv(vdx), iy = slab_inv(vdy);
  const int cs = bx.cluster_size;
  ++work.sweeps;
  for (int s = 0; s < bx.n_super; ++s) {
    const int ss = bx.order != nullptr ? bx.order[s] : s;
    if (kEarlyOut) {
      ++work.slabs;
      if (!slab_hit(bx.sup[ss], sx, sy, ix, iy, dist)) continue;
    }
    for (int g = 0; g < bx.group; ++g) {
      const int c = ss * bx.group + g;
      if (kEarlyOut && bx.group > 1) {
        ++work.slabs;
        if (!slab_hit(__ldg(bx.cl + c), sx, sy, ix, iy, dist)) continue;
      }
      const int blocker = scan_blocker(w, c * cs, cs, q, limit);
      work.tests += blocker < 0 ? cs : blocker - c * cs + 1;
      if (blocker >= 0) return true;
    }
  }
  return false;
}

// Shared memory of a block: super boxes, the block's visit order and its
// sort keys, the listeners, then (directive) the microphone table [L,
// n_mic] and the source row [n_src].
__device__ __forceinline__ Boxes load_boxes(const float4* aabb,
                                            const float4* saabb,
                                            int n_clusters, int group,
                                            int cluster_size,
                                            const float* listeners,
                                            int n_listeners, float4* smem,
                                            int** s_order, unsigned** s_keys,
                                            const float** s_lis,
                                            const float* mic_c, int n_mic,
                                            const float* src_c, int n_src,
                                            const float** s_mic,
                                            const float** s_src) {
  const int n_super = n_clusters / group;
  float4* s_sup = smem;
  int* order = reinterpret_cast<int*>(s_sup + n_super);
  unsigned* keys = reinterpret_cast<unsigned*>(order + n_super);
  float* lis = reinterpret_cast<float*>(keys + n_super);
  for (int i = threadIdx.x; i < n_super; i += blockDim.x)
    s_sup[i] = saabb[i];
  for (int i = threadIdx.x; i < 2 * n_listeners; i += blockDim.x)
    lis[i] = listeners[i];
  if (s_mic != nullptr) {
    float* mic = lis + 2 * n_listeners;
    stage(mic_c, n_listeners * n_mic, mic);
    stage(src_c, n_src, mic + n_listeners * n_mic);
    *s_mic = mic;
    *s_src = mic + n_listeners * n_mic;
  }
  *s_order = order;
  *s_keys = keys;
  *s_lis = lis;
  return Boxes{aabb, s_sup, order, n_super, group, cluster_size};
}

size_t smem_bytes(int n_clusters, int group, int n_listeners, int n_mic,
                  int n_src) {
  const size_t n_super = n_clusters / group;
  return 24 * n_super +
         4 * (2 * static_cast<size_t>(n_listeners) +
              static_cast<size_t>(n_listeners) * n_mic + n_src);
}

// The global wall table as the kernels read it: geo [Wp, 4], and cc and
// the attribute rows inside the wrapper's rows [11 + K - 1, Wp].
__device__ __forceinline__ WallTable global_table(const float* rows,
                                                  const float4* geo, int n) {
  const float* attr = rows + static_cast<size_t>(NX) * n;
  return {geo, rows + static_cast<size_t>(CC) * n, attr, n, attr};
}

// A ray's band energies in registers from its row of a ray-major energy
// buffer (kp = K rounded up to 4 floats a row, 16-byte aligned): K / 4
// 16-byte loads; the bands past nk read 0.
template <int kMaxK>
__device__ __forceinline__ void load_bands(float (&en)[kMaxK],
                                           const float* row, int nk) {
#pragma unroll
  for (int q = 0; q < kMaxK / 4; ++q) {
    const float4 v = 4 * q < nk ? reinterpret_cast<const float4*>(row)[q]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    en[4 * q] = v.x;
    en[4 * q + 1] = v.y;
    en[4 * q + 2] = v.z;
    en[4 * q + 3] = v.w;
  }
}

// The registers' band energies back to a row (load_bands' layout).
template <int kMaxK>
__device__ __forceinline__ void store_bands(const float (&en)[kMaxK],
                                            float* row, int nk) {
#pragma unroll
  for (int q = 0; q < kMaxK / 4; ++q)
    if (4 * q < nk)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(en[4 * q], en[4 * q + 1], en[4 * q + 2], en[4 * q + 3]);
}

// K7 and K8: one bounce of the ray in slot = blockIdx.x * 256 +
// threadIdx.x of the ray state of n_slots rays (state [8, N] f32, istate
// [2, N] i32 = id, depth; depth -1 = dead). Bounce 0 emits ray id = id0 +
// slot; a later bounce reads the ray at perm[slot] of state_in /
// istate_in. Either writes the ray to `slot` of state_out / istate_out
// and its next sort key to keys_out. Ray id = frame * n_rays + ray draws
// the Philox numbers of frame frame_offset + frame. K = 1 (K8) keeps the
// energy in state row 4 and ids from 0. K > 1 (K7) keeps a ray's n_bands
// energies in the energy buffers en_in / en_out: the register bucket
// (kMaxK = 8) in ray-major rows of kp = K rounded up to 4 floats (slot s
// at en[s * kp]), which it loads from en_in's row perm[slot] and stores
// to en_out's row slot; the wide kernel (kMaxK == kWideK, any K)
// band-major (band k of slot s at en[k * N + s]), which it copies to
// en_out once and works on in place.
template <int kMaxK, bool kEarlyOut, bool kDirective>
__global__ void __launch_bounds__(kAccelThreads) accel_bounce_kernel(
    const float* __restrict__ walls, const float4* __restrict__ geo,
    int n_walls, int n_bands, const float4* __restrict__ aabb,
    const float4* __restrict__ saabb, int n_clusters, int group,
    int cluster_size, const float* __restrict__ listeners, int n_listeners,
    const float* __restrict__ src_c, int n_src,
    const float* __restrict__ mic_c, int n_mic,
    const float* __restrict__ scal, const float* __restrict__ bounds,
    float sr, uint32_t key0, uint32_t key1, uint32_t entry,
    uint32_t frame_offset, int n_rays, int id0, int n_slots, int max_bounces,
    int bounce, int ir_length, const double* __restrict__ scale,
    const long long* __restrict__ perm,
    const float* __restrict__ state_in, const int* __restrict__ istate_in,
    float* __restrict__ state_out, int* __restrict__ istate_out,
    const float* __restrict__ en_in, float* __restrict__ en_out,
    long long* __restrict__ keys_out, unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ work_out) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = slot < n_slots;
  const size_t n = static_cast<size_t>(n_slots);
  size_t from = slot;
  int id = slot, dep = 0;
  if constexpr (kMaxK != 1) id += id0;
  if (bounce > 0 && in_range) {
    from = static_cast<size_t>(perm[slot]);
    id = istate_in[from];
    dep = istate_in[n + from];
  }
  const bool live = in_range && dep >= 0;
  if (in_range && !live) {  // a dead ray keeps its id and sorts last
    istate_out[slot] = id;
    istate_out[n + slot] = -1;
    keys_out[slot] = kDeadKey;
  }
  if (!__syncthreads_or(live)) return;  // the sorted tail: all dead

  extern __shared__ float4 smem[];
  const float* s_lis;
  int* s_order;
  unsigned* s_keys;
  const float* s_mic = nullptr;
  const float* s_src = nullptr;
  const Boxes bx = load_boxes(aabb, saabb, n_clusters, group, cluster_size,
                              listeners, n_listeners, smem, &s_order,
                              &s_keys, &s_lis, mic_c, n_mic, src_c, n_src,
                              kDirective ? &s_mic : nullptr,
                              kDirective ? &s_src : nullptr);
  const WallTable table = global_table(walls, geo, n_walls);
  const int ray = id % n_rays;
  const uint32_t frame = static_cast<uint32_t>(id / n_rays) + frame_offset;
  const int nk = kMaxK == 1 ? 1 : n_bands;
  Ray<kMaxK> r;
  if constexpr (kMaxK == kWideK) {
    // the energies live in slot's row of en_out; a lane without a live
    // ray touches no row
    const WideBands wide{en_out + slot, n};
    r = Ray<kWideK>{0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f, {nullptr, 1},
                    0};
    if (live && bounce == 0) {
      r = emit_ray<kWideK, kDirective>(
          ray, n_rays,
          philox_uniforms(ray, frame, max_bounces, entry, key0, key1).u0,
          scal[0], scal[1], scal[3], scal[4], src_c, n_src, wide, nk);
    } else if (live) {
      const float* s = state_in + from;
      r.px = s[0];
      r.py = s[n];
      r.dx = s[2 * n];
      r.dy = s[3 * n];
      r.tm = s[5 * n];
      r.ds = s[6 * n];
      r.sp = s[7 * n];
      r.dep = dep;
      for (int k = 0; k < nk; ++k) wide[k] = en_in[k * n + from];
      r.en = wide;
    }
  } else if (bounce == 0 || !live) {
    // the source row from global memory: shared memory is not ready yet
    r = emit_ray<kMaxK, kDirective>(
        ray, n_rays,
        philox_uniforms(ray, frame, max_bounces, entry, key0, key1).u0,
        scal[0], scal[1], scal[3], scal[4], src_c, n_src);
  } else {
    const float* s = state_in + from;
    r.px = s[0];
    r.py = s[n];
    r.dx = s[2 * n];
    r.dy = s[3 * n];
    if constexpr (kMaxK == 1)
      r.en[0] = s[4 * n];
    else
      load_bands(r.en, en_in + from * ((nk + 3) & ~3), nk);
    r.tm = s[5 * n];
    r.ds = s[6 * n];
    r.sp = s[7 * n];
    r.dep = dep;
  }
  order_super_boxes(bx, live, r.px, r.py, s_order, s_keys);

  Work work;
  int hit;
  const float closest = nearest<kEarlyOut>(
      table, bx, live, make_probe(r.px, r.py, r.dx, r.dy), hit, work);
  if (live) {
    const Listeners lis{s_lis, n_listeners, scal[2] * scal[2], scal[3],
                        s_mic, n_mic};
    const Sink sink{acc, ir_length, nk, sr, *scale};
    const bool alive = finish_bounce<kMaxK, kDirective>(
        r, closest, hit, table, lis, sink,
        [&](float sx, float sy, float vdx, float vdy, float dist,
            float limit) {
          return occluded<kEarlyOut>(table, bx, sx, sy, vdx, vdy, dist, limit,
                                     work);
        },
        [&] {
          return philox_uniforms(ray, frame, bounce, entry, key0, key1);
        });
    float* s = state_out + slot;
    s[0] = r.px;
    s[n] = r.py;
    s[2 * n] = r.dx;
    s[3 * n] = r.dy;
    if constexpr (kMaxK == 1)
      s[4 * n] = r.en[0];
    else if constexpr (kMaxK != kWideK)
      if (alive) store_bands(r.en, en_out + slot * ((nk + 3) & ~3), nk);
    s[5 * n] = r.tm;
    s[6 * n] = r.ds;
    s[7 * n] = r.sp;
    istate_out[slot] = id;
    istate_out[n + slot] = alive ? r.dep : -1;
    keys_out[slot] = alive ? morton_ray_key(r.px, r.py, bounds) : kDeadKey;
  }
  if (work_out != nullptr) add_work(work, work_out);
}

// Both patterns or neither, each of an odd count.
bool patterns_ok(const float* src_c, int n_src, const float* mic_c,
                 int n_mic) {
  if (src_c == nullptr && mic_c == nullptr) return true;
  return src_c != nullptr && mic_c != nullptr && n_src >= 1 &&
         n_src % 2 == 1 && n_mic >= 1 && n_mic % 2 == 1;
}

bool boxes_ok(int n_walls, int n_clusters, int group, int cluster_size,
              int n_listeners) {
  return n_clusters >= 1 && group >= 1 && cluster_size >= 1 &&
         n_clusters % group == 0 &&
         static_cast<long long>(n_clusters) * cluster_size == n_walls &&
         n_listeners >= 1;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The arguments of one launch of accel_bounce_kernel (art_accel_bounce).
struct BounceArgs {
  const float* walls;
  const float* geo;
  int n_walls, n_bands;
  const float* aabb;
  const float* saabb;
  int n_clusters, group, cluster_size;
  const float* listeners;
  int n_listeners;
  const float* src_c;
  int n_src;
  const float* mic_c;
  int n_mic;
  const float* scal;
  const float* bounds;
  float sr;
  uint32_t key0, key1, entry, frame_offset;
  int n_rays, id0, n_slots, max_bounces, bounce, ir_length;
  const double* scale;
  const long long* perm;
  const float* state_in;
  const int* istate_in;
  float* state_out;
  int* istate_out;
  const float* en_in;
  float* en_out;
  long long* keys_out;
  unsigned long long* acc;
  unsigned long long* work;
};

// One launch of `kernel` (an instantiation of accel_bounce_kernel: all
// share one signature).
template <class Kernel>
cudaError_t launch_bounce(Kernel kernel, const BounceArgs& a,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(a.n_clusters, a.group, a.n_listeners,
                                 a.n_mic, a.n_src);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_slots + kAccelThreads - 1) / kAccelThreads);
  kernel<<<grid, kAccelThreads, smem, stream>>>(
      a.walls, reinterpret_cast<const float4*>(a.geo), a.n_walls, a.n_bands,
      reinterpret_cast<const float4*>(a.aabb),
      reinterpret_cast<const float4*>(a.saabb), a.n_clusters, a.group,
      a.cluster_size, a.listeners, a.n_listeners, a.src_c, a.n_src, a.mic_c,
      a.n_mic, a.scal, a.bounds, a.sr, a.key0, a.key1, a.entry,
      a.frame_offset, a.n_rays, a.id0, a.n_slots, a.max_bounces, a.bounce,
      a.ir_length, a.scale, a.perm, a.state_in, a.istate_in, a.state_out,
      a.istate_out, a.en_in, a.en_out, a.keys_out, a.acc, a.work);
  return cudaGetLastError();
}

// Call f(accel_bounce_kernel<K, E, D>) for the instantiation a launch of
// n_bands, early_out and directive takes (by_bucket: 1, 8, or the wide
// kernel past 8 bands).
template <class F>
cudaError_t with_kernel(int n_bands, bool early_out, bool directive, F f) {
  return by_bucket<kAccelLargestBucket>(n_bands, [&](auto bucket) {
    constexpr int K = decltype(bucket)::value;
    if (early_out)
      return directive ? f(accel_bounce_kernel<K, true, true>)
                       : f(accel_bounce_kernel<K, true, false>);
    return directive ? f(accel_bounce_kernel<K, false, true>)
                     : f(accel_bounce_kernel<K, false, false>);
  });
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// K7 and K8: one bounce (0 .. max_bounces - 1) of n_slots rays, the
// frames [id0 / n_rays, (id0 + n_slots) / n_rays) of n_rays rays each. A
// ray's state is a column of state [8, n_slots] f32 (px py dx dy energy
// time distance speed) and istate [2, n_slots] i32 (id = frame * R + ray,
// depth; depth -1 = dead). Bounce 0 emits ray id = id0 + slot and reads
// nothing; a later bounce reads slot's ray at column perm[slot] (i64
// [n_slots], the order of the last sort) of state_in / istate_in. Every
// bounce writes the ray to column `slot` of state_out / istate_out (other
// buffers than the inputs) and its next sort key to keys_out [n_slots]
// i64: the Morton code of its new position within bounds [4] = (lo x, lo
// y, span x, span y), or 0xFFFFFFFF if it died (ops/accel.py::
// morton_ray_keys). K = n_bands: K = 1 keeps the energy in state row 4
// (id0 = 0: K8, whose frames move by frame_offset alone); K > 1 keeps the
// energies in en_in (read, bounce > 0) and en_out (written), two other
// buffers of n_slots * kp floats, kp = K rounded up to 4: up to 8 bands
// ray-major, slot s's row of kp at s * kp (16-byte aligned buffers), past
// 8 band-major, band k of slot s at k * n_slots + s. Hits
// add to acc [L, T, K] u64 (zeroed by the caller before the first bounce
// of a call; art_fixed_to_float converts it after the last). walls [10 +
// K, W] (see WallField; W = n_clusters * cluster_size, Morton-sorted), geo
// [W, 4] = (ax, ay, v2x, v2y) of the same walls, aabb [C, 4], saabb [C /
// group, 4], listeners [L, 2] (any L whose table fits beside the super
// boxes in shared memory), scal [5] = (source x, source y, listener
// radius, speed of sound, input gain), all device f32; scale one device
// double; work, if not null, three device u64 (wall tests, wall sweeps,
// slab tests). Philox counter (ray, frame_offset + frame, bounce, entry)
// under (key0, key1), frame = id / n_rays; the pass's last frame word,
// frame_offset + (id0 + n_slots) / n_rays - 1, must fit 32 bits (a
// launch past it is refused, never wrapped). src_c [n_src] and mic_c [L,
// n_mic] (device f32, n odd) are the source and microphone patterns of a
// directive trace, both null for omni. Returns a cudaError_t code (0 =
// launched).
int art_accel_bounce(const float* walls, const float* geo, int n_walls,
                     int n_bands, const float* aabb, const float* saabb,
                     int n_clusters, int group, int cluster_size,
                     const float* listeners, int n_listeners,
                     const float* src_c, int n_src, const float* mic_c,
                     int n_mic, const float* scal, const float* bounds,
                     float sr, unsigned int key0, unsigned int key1,
                     unsigned int entry, unsigned int frame_offset,
                     int n_rays, int id0, int n_slots, int max_bounces,
                     int bounce, int ir_length,
                     const double* scale, const long long* perm,
                     const float* state_in, const int* istate_in,
                     float* state_out, int* istate_out, const float* en_in,
                     float* en_out, long long* keys_out,
                     unsigned long long* acc, int early_out,
                     unsigned long long* work, void* stream) {
  const bool banded = n_bands > 1;
  const bool bands_ok =
      !banded ||
      (en_out != nullptr && en_out != en_in &&
       (bounce == 0 || en_in != nullptr) &&
       (n_bands > kAccelLargestBucket ||
        (aligned16(en_in) && aligned16(en_out))));
  if (!boxes_ok(n_walls, n_clusters, group, cluster_size, n_listeners) ||
      n_bands < 1 || !bands_ok || n_rays < 1 || n_slots < n_rays ||
      n_slots % n_rays != 0 || id0 < 0 || id0 % n_rays != 0 ||
      (!banded && id0 != 0) ||
      static_cast<long long>(id0) + n_slots > 0x7fffffffll ||
      frame_offset + (static_cast<unsigned long long>(id0) + n_slots) /
              n_rays > 0x100000000ull ||
      max_bounces < 1 || bounce < 0 || bounce >= max_bounces ||
      ir_length < 1 || state_out == nullptr || istate_out == nullptr ||
      keys_out == nullptr || state_out == state_in ||
      (bounce > 0 && (perm == nullptr || state_in == nullptr ||
                      istate_in == nullptr)) ||
      !patterns_ok(src_c, n_src, mic_c, n_mic))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool directive = src_c != nullptr;
  if (!directive) n_src = n_mic = 0;
  const BounceArgs a{walls, geo, n_walls, n_bands, aabb, saabb, n_clusters,
                     group, cluster_size, listeners, n_listeners, src_c,
                     n_src, mic_c, n_mic, scal, bounds, sr, key0, key1,
                     entry, frame_offset, n_rays, id0, n_slots, max_bounces,
                     bounce, ir_length, scale, perm, state_in, istate_in,
                     state_out, istate_out, en_in, en_out, keys_out, acc,
                     work};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_kernel(
      n_bands, early_out, directive,
      [&](auto kernel) { return launch_bounce(kernel, a, s); }));
}

// The registers and local (stack) bytes per thread of the instantiation
// of accel_bounce_kernel a launch of n_bands bands takes, into out[2]
// (cudaFuncGetAttributes). Returns a cudaError_t code.
int art_accel_attributes(int n_bands, int early_out, int directive,
                         int* out) {
  if (n_bands < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = with_kernel(
      n_bands, early_out, directive,
      [&](auto kernel) { return cudaFuncGetAttributes(&a, kernel); });
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
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
