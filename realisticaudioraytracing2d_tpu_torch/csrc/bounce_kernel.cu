// Monte-Carlo bounce kernel for Hopper (sm_90a): whole frames, batched
// over rooms or sources, binned into the IR or handed out as hit rows.
//
// Replaces five TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py):
//   _make_frame_hist_kernel (K3, through trace_frame_ir_whole: uniforms
//     drawn on the host),
//   _make_mega_kernel (K4, through trace_frames_ir_mega: all frames in one
//     launch, random numbers drawn on the device), and
//   _make_rooms_mega_kernel (K9, through trace_rooms_ir_mega: K4 over a
//     batch of E entries, rooms of a sweep or sources of a mixdown, each
//     with its own wall table or one shared table, listeners, source,
//     gain, radius, speed of sound and fixed-point scale),
//   _make_bounce_hist_kernel (K6, through trace_frame_ir_fused: one frame,
//     binned in the kernel): K3's or K4's launch at one frame, and
//   _bounce_kernel (K5, through trace_fused_rows: one frame's raw hit rows,
//     one listener, one band): frame_rows_kernel, below.
// The first three compute the same thing (emission, every bounce of
// _bounce_step and the IR binning of _hist_listener, K bands and L
// listeners) and differ only in where the uniforms come from and in the
// batch axis, so they are one template, frames_ir_kernel<kHostUniforms,
// kDirective, kMaxK, kLanes>, whose grid z axis is the batch entry: K3 and
// K4 are its E = 1 case. kDirective adds the source
// and microphone patterns (_fourier_gain, _src_gain and the mic rows of
// pack_listeners in the JAX kernels): per entry a source row [C_s] and a
// microphone table [L, C_m], so each source of a mixdown carries its own
// aim. The semantics are those of the plain
// oracle ops/trace.py::_bounce + ops/ir.py::scatter_hits of this package;
// the TPU layout (rays on lanes, one-hot MXU gather, two-level bf16
// histogram, K9's [Rg, Wp, 8] blocks and its seed plan) is not carried
// over. The ray physics (emission, the bounce after the nearest-wall
// search, Philox, the deposit) is trace_common.cuh, shared with the
// cluster kernels K7/K8 of accel_kernel.cu.
//
// Design:
//  * kLanes = G neighbouring threads per (ray, frame, entry), G = 1 where
//    the grid fills the card; its state (pos, dir, energy, time, distance,
//    speed, depth) lives in registers. Grid (ceil(R * G / 256), F, E):
//    entries on z keep F and E each under the 65,535 limit of those axes.
//    (A block that carried its tile of rays through all frames of its
//    entry, loading the table once, measured the same on the 1,024-room
//    sweep: a 28-wall table is 1.2 KB.)
//  * Lane groups, for small grids: the stream's 15,000 rays are 59 blocks
//    of 256 for 132 SMs, and each ray's bounces are one serial chain of
//    scans, so the device time is that chain's latency on half the card.
//    With G = kLaneGroup = 4 (the wrapper takes it while R * F * E * 4
//    threads stay under 16 warps per SM), the G lanes of a group hold the
//    same ray: each scans its own contiguous 1 / G of the walls
//    (scan_nearest, scan_blocker), and the group combines the results
//    with shuffles over its own lanes (LaneGroup of trace_common.cuh): the
//    nearest wall lexicographically, smaller distance first and then lower
//    index, the occlusion sweep by the lowest blocker index, which is
//    exactly what one ascending scan of the whole table gives. The rest of
//    the bounce (emission, Philox or the host uniforms, finish_bounce, the
//    patterns) runs on all G lanes, which hold the same state and draw the
//    same numbers, so they take the same branches and stay converged for
//    the shuffles; only a group's lead lane deposits (GroupSink) and
//    counts work. G = 4 gives the G = 1 bits and work counts; G = 1 is
//    the kernel before lane groups (LaneGroup<1> compiles to its code).
//  * Each block packs its entry's wall table into shared memory as a
//    WallTable (trace_common.cuh): the geometry of a wall as one float4
//    (ax, ay, v2x, v2y), cc, and six attribute rows (nx, ny, abs, scat,
//    trans, ior): 44 B per wall at any band count, plus its listener
//    table (8 B a listener, sized from the launch) and, when directive,
//    its entry's pattern rows (C_s + L * C_m floats). The tables are
//    [E or 1, 10 + K, W] and [E, L, 2]; a wall stride of 0 shares one
//    scene among all entries (the mixdown) without copying it. The
//    attribute gather is an indexed shared-memory load. The 227 KB a
//    block can use caps a scene at kMaxWalls = 5280 walls beside 16
//    listeners; larger scenes go to the cluster kernels K7/K8
//    (accel_kernel.cu). Listeners that do not fit beside a table run in
//    blocks, one launch each (the wrapper), over the same random numbers
//    and scale: ray physics never reads the listener table, so the blocks
//    give the whole launch's bits.
//  * Bands: the absorption of bands 1 .. K-1 (rows 11 .. of the wrapper's
//    table) is read from global memory, for the hit wall only, once per
//    bounce (5,280 walls x 31 bands = 655 KB, resident in L2), so the
//    shared table and kMaxWalls do not depend on K. A ray's K energies
//    live in registers for K <= 32 (the buckets 1, 8, 32 of
//    trace_common.cuh::by_bucket: the launch takes the smallest that holds
//    K and loops to K); past that in a device scratch laid out band-major
//    by thread (kWideK), the launch running its (entry, frame) planes in
//    chunks whose energies fit the scratch. The omni K = 1 instantiations
//    compile to the code they had before bands (the same registers).
//  * Nearest wall and occlusion: scan_nearest / scan_blocker of
//    trace_common.cuh. A division-free filter over 32 walls at a time
//    leaves a mask of the few walls the ray's line can cross, and only
//    those go on, lowest index first, to a second division-free step
//    (is the wall within reach?) and then to the exact test with its two
//    IEEE divides, so the lowest index wins among equal distances (the
//    oracle's argmin) and an occlusion sweep stops at the first blocker.
//  * 64 registers a thread at K = 1 (omni, G = 1), so four blocks of 256
//    share an SM; more in the larger buckets and lane groups (PERF.md).
//    (Asking the compiler for two or four resident blocks through
//    __launch_bounds__ measured the same on the 1,024-room sweep.)
//    Padding walls are degenerate (a == b, so v2 == 0): dotp == 0 marks
//    them parallel to every ray and they never hit, as in the oracle.
//  * Arithmetic is IEEE: '/', sqrtf, sincosf, asinf, no fast math, and the
//    build passes --fmad=false so no multiply-add is contracted. The
//    diffuse direction keeps the oracle's form, asin then rotate.
//  * IR binning: each valid hit adds llrint(e * S_e) per band into an
//    unsigned 64-bit [E, L, T, K] accumulator with atomicAdd in global memory (a
//    72,000-bin f32 IR is 288 KB, more than a block's shared memory).
//    Integer addition is associative, so the same inputs give a
//    bit-identical IR whatever order the atomics land in, at any E. S_e is
//    a power of two per entry, chosen on the device by the wrapper from
//    that entry's worst-case bin sum, so no bin can overflow and a room
//    whose listener sits near its source does not coarsen the others (see
//    ops/cuda/bounce_kernel.py::fixed_point_scales). A second small kernel
//    divides each entry by its own S_e into the f32 IR.
//  * Random numbers (K4, K9): Philox-4x32-10, key = two 32-bit words from
//    the wrapper, counter = (ray, frame, bounce, entry_offset + e). One
//    call gives a bounce's three uniforms; counter bounce B gives the
//    emission jitter. Streams of different (ray, frame, entry) are
//    disjoint by construction, and K4's stream is entry 0 of K9's. Top 24
//    bits times 2^-24, as the TPU kernels' _draw_uniforms. ops/rng.py::
//    philox_uniforms computes the same numbers on the host.
//  * An optional counter (work != nullptr, three u64: wall tests, wall
//    sweeps, slab tests) sums the wall tests a sweep stands for (every
//    wall of a nearest sweep, the walls up to the first blocker of an
//    occlusion sweep, whether the filter or the exact test settled them)
//    and the sweeps they belong to (one warp-reduced atomic per warp and
//    counter; this kernel makes no slab tests), so a bound can be computed
//    from this run's data.
//
//  * K5, frame_rows_kernel<kDirective, kLanes>: trace_ray's loop of all
//    B bounces with a RowSink (trace_common.cuh) in place of the IR sink,
//    host uniforms, one listener, one band, in K3's lane groups. The JAX
//    kernel and the port's first design ran one launch per bounce with the
//    ray state [8, R] + depth [R] in device memory between launches; here
//    the state stays in registers and the table is loaded once per block.
//    A bounce's column of the rows [B, 8, R] is written once per element
//    (the hits as they land, zeros in the rest at the end of the bounce),
//    and a ray that dies writes zeros into the columns of the bounces it
//    does not reach, so no memset runs. In a lane group the lead lane
//    stores the rows, as it deposits into the IR.
//
// What bounds it: instruction rate in the wall pass. The work is
// O(R * W * B * (1 + L)) intersection tests of 13 FP32 operations each
// (two of them divides), plus 3 per sweep for the ray's own cross product
// (oy * dx - ox * dy); one nearest-wall sweep per live bounce plus one
// occlusion sweep per listener, which stops at the first blocking wall.
// The bytes it must move (wall tables in, the f32 IR out) are far fewer.
// The filter spends ~18 instructions on a wall, a survivor some 15 more
// and ~40 for its divides, without multiply-add contraction, so the FP32
// peak is out of reach by construction. A warp pays a whole scan when one
// of its lanes needs it (the occlusion sweep of the rays that are outside
// walls and loud enough, the bounces of the rays that still live), and the
// rest of a bounce (Philox, sincosf, asinf, a dozen IEEE divides and square
// roots, the double-precision deposit) is a fifth of the instructions; the
// deposits' atomics are an eighth of the sweep's time. At a small grid
// (the stream's one frame of 15,000 rays) the bound is not the issue rate
// but the latency of each ray's serial chain of bounces on the few SMs
// its blocks occupy; lane groups split the chain's scans over G lanes and
// spread the grid over the card. K5 adds its rows, 32 B per ray and bounce
// (33.5 MB at 131,072 x 8), which with its host uniforms (4 B per ray and
// 12 per ray and bounce) make its bound bytes. Measured shares: PERF.md.

#include <algorithm>

#include "trace_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // 227 KB per block on sm_90
constexpr int kAttrRows = kWallFields - 5;  // NX .. IOR
// The largest register bucket of a ray's band energies (by_bucket): past
// it the scratch, which measured 1.12-2.0x slower at 32 bands (PERF.md).
constexpr int kLargestBucket = 32;
// The largest wall table that leaves room for 16 listeners beside it (the
// routing limit: larger scenes go to the cluster kernels). A launch sizes
// its listener table from its listener count; a caller whose listeners do
// not fit beside the walls launches them in blocks (the wrapper).
constexpr int kMaxWalls = (kMaxSmemBytes - 2 * 16 * 4) / (kWallFields * 4);

// One ray of one frame of one entry, all its bounces; its hits go to
// `hits`, a Sink (the IR: K3, K4, K6, K9) or a RowSink (K5's rows).
template <bool kHostUniforms, bool kDirective, int kMaxK, int kLanes,
          class SinkT>
__device__ __forceinline__ Work trace_ray(
    const WallTable& walls, const float* s_lis, int n_listeners,
    const float* s_src, int n_src, const float* s_mic, int n_mic,
    const float* scal, const float* emit, const float* u, uint32_t key0,
    uint32_t key1, uint32_t entry_id, int ray, int frame, int n_frames,
    int entry, int n_rays, int max_bounces, int n_bands, WideBands wide,
    const SinkT& hits) {
  const float radius = scal[2];
  const Listeners lis{s_lis, n_listeners, radius * radius, scal[3], s_mic,
                      n_mic};
  const int n_walls = walls.n;
  Work work;
  // kLanes > 1: this lane's part of each scan, and whether it is the lane
  // that deposits and counts; kLanes = 1 scans the whole table
  const LaneGroup<kLanes> group = LaneGroup<kLanes>::mine(n_walls);
  const auto sink = group.sink(hits);

  auto draw = [&](int bounce) -> Uniforms {
    if (kHostUniforms) {
      const size_t o =
          ((static_cast<size_t>(entry) * n_frames + frame) * max_bounces +
           bounce) * n_rays + ray;
      return {u[3 * o], u[3 * o + 1], u[3 * o + 2]};
    }
    return philox_uniforms(ray, frame, bounce, entry_id, key0, key1);
  };
  // One occlusion sweep: stop at the first wall (ascending) that blocks
  // the shadow ray before `limit`.
  auto occluded = [&](float sx, float sy, float vdx, float vdy, float,
                      float limit) {
    int blocker;
    if constexpr (kLanes == 1)
      blocker = scan_blocker(walls, 0, n_walls, make_probe(sx, sy, vdx, vdy),
                             limit);
    else
      blocker = group.min_blocker(
          scan_blocker(walls, group.lo, group.count,
                       make_probe(sx, sy, vdx, vdy), limit));
    if (group.lead()) {
      work.tests += blocker < 0 ? n_walls : blocker + 1;
      ++work.sweeps;
    }
    return blocker >= 0;
  };

  // --- emission (ops/trace.py::_emit) ---------------------------------------
  const float jitter0 =
      kHostUniforms
          ? emit[(static_cast<size_t>(entry) * n_frames + frame) * n_rays +
                 ray]
          : draw(max_bounces).u0;
  Ray<kMaxK> r = emit_ray<kMaxK, kDirective>(
      ray, n_rays, jitter0, scal[0], scal[1], scal[3], scal[4], s_src, n_src,
      wide, n_bands);

  for (int b = 0; b < max_bounces; ++b) {
    // --- nearest wall: the lowest index among the smallest distances -------
    float closest = kInf;
    int best = 0x7fffffff;
    if constexpr (kLanes == 1) {
      scan_nearest(walls, 0, n_walls, make_probe(r.px, r.py, r.dx, r.dy),
                   closest, best);
    } else {
      scan_nearest(walls, group.lo, group.count,
                   make_probe(r.px, r.py, r.dx, r.dy), closest, best);
      group.min_hit(closest, best);
    }
    if (group.lead()) {
      work.tests += n_walls;
      ++work.sweeps;
    }
    const bool alive = finish_bounce<kMaxK, kDirective>(
        r, closest, closest < kInf ? best : -1, walls, lis, sink, occluded,
        [&] { return draw(b); });
    end_bounce(sink, b, alive);
    if (!alive) break;
  }
  return work;
}

// Grid (ceil(R * kLanes / 256), F, E) for a register bucket, kLanes lanes
// per (ray, frame, entry); a wide kernel (kMaxK == kWideK, kLanes = 1)
// runs over planes (entry, frame) = divmod(plane0 + blockIdx.y,
// n_frames_all) on a grid (ceil(R / 256), planes, 1), its energies in
// `scratch` [K, gridDim.y * gridDim.x * 256].
template <bool kHostUniforms, bool kDirective, int kMaxK, int kLanes>
__global__ void __launch_bounds__(kThreads) frames_ir_kernel(
    const float* __restrict__ walls, long long wall_stride, int n_walls,
    int n_bands, const float* __restrict__ listeners, int n_listeners,
    const float* __restrict__ src_c, int n_src,
    const float* __restrict__ mic_c, int n_mic,
    const float* __restrict__ scal, float sr,
    const float* __restrict__ emit, const float* __restrict__ u,
    uint32_t key0, uint32_t key1, uint32_t entry_offset,
    uint32_t frame_offset, int n_rays, int max_bounces, int ir_length,
    int plane0, int n_frames_all,
    float* __restrict__ scratch, const double* __restrict__ scales,
    unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ work_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int entry, frame, n_frames;
  WideBands wide{};
  if constexpr (kMaxK == kWideK) {
    const int plane = plane0 + static_cast<int>(blockIdx.y);
    entry = plane / n_frames_all;
    frame = plane - entry * n_frames_all;
    n_frames = n_frames_all;
    const size_t stride =
        static_cast<size_t>(gridDim.y) * gridDim.x * blockDim.x;
    wide = {scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                       blockIdx.x) * blockDim.x + threadIdx.x,
            stride};
  } else {
    entry = blockIdx.z;
    frame = blockIdx.y;
    n_frames = gridDim.y;
  }
  // K4/K9 draw frames frame_offset .. of the Philox stream (a shard of a
  // frame-sharded run); host uniforms are indexed from frame 0
  if constexpr (!kHostUniforms)
    frame = static_cast<int>(static_cast<uint32_t>(frame) + frame_offset);
  const int nk = kMaxK == 1 ? 1 : n_bands;
  walls += entry * wall_stride;  // stride 0: one scene shared by all entries
  listeners += static_cast<size_t>(entry) * 2 * n_listeners;
  WallTable table = load_wall_table(walls, n_walls, 0, n_walls, kAttrRows,
                                    smem);
  table.band_rows = walls + NX * n_walls;  // bands 1.., global (L2)
  float* s_lis = smem + wall_table_floats(n_walls, kAttrRows);  // [L][2]
  for (int i = threadIdx.x; i < 2 * n_listeners; i += blockDim.x)
    s_lis[i] = listeners[i];
  // this entry's pattern rows: source [n_src], microphones [L, n_mic]
  float* s_src = s_lis + 2 * n_listeners;
  float* s_mic = s_src + n_src;
  if constexpr (kDirective) {
    stage(src_c + static_cast<size_t>(entry) * n_src, n_src, s_src);
    stage(mic_c + static_cast<size_t>(entry) * n_listeners * n_mic,
          n_listeners * n_mic, s_mic);
  }
  __syncthreads();

  // a lane group's lanes are neighbours and share one ray
  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  Work work;
  if (ray < n_rays)
    work = trace_ray<kHostUniforms, kDirective, kMaxK, kLanes>(
        table, s_lis, n_listeners, s_src, n_src, s_mic, n_mic,
        scal + kScalFields * entry, emit, u, key0, key1,
        entry_offset + static_cast<uint32_t>(entry), ray, frame, n_frames,
        entry, n_rays, max_bounces, nk, wide,
        Sink{acc + static_cast<size_t>(entry) * n_listeners * ir_length * nk,
             ir_length, nk, sr, scales[entry]});
  if (work_out != nullptr)  // every thread of the block reaches this point
    add_work(work, work_out);
}

// K5's resident blocks per SM, asked of the compiler: with one lane a ray
// (a grid that fills the card) 4 blocks of 256, which holds it to K3's 64
// registers without spilling (asked for 1 it takes 84, 3 blocks fit an
// SM, and 131,072 x 8 ran 13% slower); in lane groups 1 (83 registers, no
// spills; held to 64 they spill and ran 4% slower at 15,000 rays).
// scripts/torch_redesign_k5_k6.py times both alternatives.
template <int kLanes>
constexpr int kRowsMinBlocks = kLanes == 1 ? 4 : 1;

// K5: the hit rows [B, 8, R] of one frame, host uniforms emit [R] and u
// [B, R, 3], one listener, one band; kLanes lanes per ray, as K3. The
// frame's rays go through trace_ray with a RowSink in place of the IR.
template <bool kDirective, int kLanes>
__global__ void __launch_bounds__(kThreads, kRowsMinBlocks<kLanes>)
    frame_rows_kernel(
    const float* __restrict__ walls, int n_walls,
    const float* __restrict__ listener, const float* __restrict__ src_c,
    int n_src, const float* __restrict__ mic_c, int n_mic,
    const float* __restrict__ scal, const float* __restrict__ emit,
    const float* __restrict__ u, int n_rays, int max_bounces,
    float* __restrict__ rows, unsigned long long* __restrict__ work_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WallTable table = load_wall_table(walls, n_walls, 0, n_walls,
                                          kAttrRows, smem);
  float* s_lis = smem + wall_table_floats(n_walls, kAttrRows);  // [1][2]
  float* s_src = s_lis + 2;
  float* s_mic = s_src + n_src;
  stage(listener, 2, s_lis);
  if constexpr (kDirective) {
    stage(src_c, n_src, s_src);
    stage(mic_c, n_mic, s_mic);
  }
  __syncthreads();

  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  Work work;
  if (ray < n_rays)
    work = trace_ray<true, kDirective, 1, kLanes>(
        table, s_lis, 1, s_src, n_src, s_mic, n_mic, scal, emit, u, 0, 0, 0,
        ray, 0, 1, 0, n_rays, max_bounces, 1, WideBands{},
        RowSink{rows + ray, n_rays, max_bounces, 0u});
  if (work_out != nullptr)  // every thread of the block reaches this point
    add_work(work, work_out);
}

template <bool kDirective, int kLanes>
cudaError_t launch_rows(const float* walls, int n_walls,
                        const float* listener, const float* src_c, int n_src,
                        const float* mic_c, int n_mic, const float* scal,
                        const float* emit, const float* u, int n_rays,
                        int max_bounces, float* rows,
                        unsigned long long* work, cudaStream_t stream) {
  const auto kernel = frame_rows_kernel<kDirective, kLanes>;
  const size_t smem =
      sizeof(float) *
      (kWallFields * static_cast<size_t>(n_walls) + 2 + n_src + n_mic);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = static_cast<int>(
      (static_cast<long long>(n_rays) * kLanes + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, stream>>>(walls, n_walls, listener, src_c,
                                           n_src, mic_c, n_mic, scal, emit,
                                           u, n_rays, max_bounces, rows,
                                           work);
  return cudaGetLastError();
}

template <bool kHostUniforms, bool kDirective, int kMaxK, int kLanes>
cudaError_t launch(const float* walls, long long wall_stride, int n_walls,
                   int n_bands, const float* listeners, int n_listeners,
                   const float* src_c, int n_src, const float* mic_c,
                   int n_mic, const float* scal,
                   float sr, const float* emit, const float* u, uint32_t key0,
                   uint32_t key1, uint32_t entry_offset,
                   uint32_t frame_offset, int n_entries,
                   int n_rays, int max_bounces, int n_frames, int ir_length,
                   float* scratch, long long scratch_floats,
                   const double* scales, unsigned long long* acc, float* out,
                   unsigned long long* work, int* launched,
                   cudaStream_t stream) {
  const auto kernel = frames_ir_kernel<kHostUniforms, kDirective, kMaxK,
                                       kLanes>;
  const size_t smem =
      sizeof(float) * (kWallFields * static_cast<size_t>(n_walls) +
                       2 * static_cast<size_t>(n_listeners) + n_src +
                       static_cast<size_t>(n_listeners) * n_mic);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const size_t per_entry =
      static_cast<size_t>(n_listeners) * ir_length * n_bands;
  const size_t n = per_entry * n_entries;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * n,
                                    stream);
  if (err != cudaSuccess) return err;
  const int gx = static_cast<int>(
      (static_cast<long long>(n_rays) * kLanes + kThreads - 1) / kThreads);
  if constexpr (kMaxK == kWideK) {
    // planes (entry, frame) in chunks whose energies fit the scratch
    const long long per_plane = static_cast<long long>(gx) * kThreads *
                                n_bands;
    if (scratch == nullptr || scratch_floats < per_plane)
      return cudaErrorInvalidValue;
    const long long planes = static_cast<long long>(n_entries) * n_frames;
    const long long chunk = std::min<long long>(65535,
                                                scratch_floats / per_plane);
    for (long long p0 = 0; p0 < planes; p0 += chunk) {
      const dim3 grid(gx, static_cast<unsigned>(std::min(chunk, planes - p0)));
      kernel<<<grid, kThreads, smem, stream>>>(
          walls, wall_stride, n_walls, n_bands, listeners, n_listeners, src_c,
          n_src, mic_c, n_mic, scal, sr, emit, u, key0, key1, entry_offset,
          frame_offset, n_rays, max_bounces, ir_length, static_cast<int>(p0),
          n_frames,
          scratch, scales, acc, work);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      ++*launched;
    }
  } else {
    const dim3 grid(gx, n_frames, n_entries);
    kernel<<<grid, kThreads, smem, stream>>>(
        walls, wall_stride, n_walls, n_bands, listeners, n_listeners, src_c,
        n_src, mic_c, n_mic, scal, sr, emit, u, key0, key1, entry_offset,
        frame_offset, n_rays, max_bounces, ir_length, 0, n_frames, nullptr,
        scales, acc, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return launch_fixed_to_float(acc, scales, out, n, per_entry, stream);
}

// Call f(std::integral_constant<int, K>{}, std::integral_constant<int,
// G>{}) with the band bucket of n_bands (by_bucket) and G = lanes, 1 or
// kLaneGroup; the wide kernel runs G = 1 only.
template <class F>
cudaError_t by_shape(int n_bands, int lanes, F f) {
  return by_bucket<kLargestBucket>(n_bands, [&](auto bucket) {
    if (lanes == 1) return f(bucket, std::integral_constant<int, 1>{});
    if constexpr (decltype(bucket)::value != kWideK) {
      if (lanes == kLaneGroup)
        return f(bucket, std::integral_constant<int, kLaneGroup>{});
    }
    return cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" {

// Frame-summed IRs out[E, L, T, K] (f32) of n_frames frames for each of
// n_entries batch entries. host_uniforms != 0 reads emit[E, F, R] and
// u[E, F, B, R, 3] (K3); otherwise draws Philox numbers under (key0, key1)
// with counter word 3 = entry_offset + e and word 1 = frame_offset + f
// for frame f of the launch (K4 is E = 1, entry offset 0; K9 any E;
// frame_offset must be 0 with host uniforms). walls is [E or 1, 10 + K,
// W] (see WallField; the absorption of bands 1 .. K-1 in rows 11 ..) with
// wall_stride (10 + K) * W or 0 (shared),
// listeners [E, L, 2] (any L whose table fits beside the walls in shared
// memory), scal [E, 5] = (source x, source y, listener radius, speed of
// sound, input gain), all device f32. src_c [E, n_src] and mic_c [E, L,
// n_mic] (device f32, n odd) are the source and microphone patterns of a
// directive trace, both null for omni (the reference's emission and
// pickup). K <= 32 keeps a ray's energies in registers; a larger K needs
// scratch, scratch_floats >= ceil(R / 256) * 256 * K device floats (more
// lets one launch take more (entry, frame) planes). lanes (1, or 4 up to
// 32 bands) neighbouring threads share one (ray, frame, entry), each
// scanning 1 / lanes of the walls: the same IR at either. scales [E]
// device doubles, acc [E, L, T, K] u64 scratch; work, if not null, three
// device u64 to which the launch adds the wall tests it made, the wall
// sweeps (nearest or occlusion) they belong to and its slab tests (none). *launched (host) receives the launches of
// the trace kernel: one, or one per chunk of planes for the scratch.
// Returns a cudaError_t code (0 = launched).
int art_trace_frames_ir(int host_uniforms, const float* walls,
                        long long wall_stride, int n_walls, int n_bands,
                        const float* listeners, int n_listeners,
                        const float* src_c, int n_src, const float* mic_c,
                        int n_mic, const float* scal, float sr,
                        const float* emit, const float* u, unsigned int key0,
                        unsigned int key1, unsigned int entry_offset,
                        unsigned int frame_offset, int n_entries, int n_rays, int max_bounces,
                        int n_frames, int ir_length, int lanes,
                        float* scratch, long long scratch_floats,
                        const double* scales, unsigned long long* acc,
                        float* out, unsigned long long* work, int* launched,
                        void* stream) {
  const bool directive = src_c != nullptr || mic_c != nullptr;
  if (n_walls < 1 || n_walls > kMaxWalls || n_bands < 1 || n_listeners < 1 ||
      n_rays < 1 || n_frames < 1 || n_frames > 65535 || n_entries < 1 ||
      n_entries > 65535 || max_bounces < 1 || ir_length < 1 ||
      (host_uniforms && frame_offset != 0) ||
      (wall_stride != 0 &&
       wall_stride != static_cast<long long>(kWallFields + n_bands - 1) *
                          n_walls) ||
      (directive && (src_c == nullptr || mic_c == nullptr || n_src < 1 ||
                     n_src % 2 != 1 || n_mic < 1 || n_mic % 2 != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!directive) n_src = n_mic = 0;
  const auto s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  return static_cast<int>(by_shape(n_bands, lanes, [&](auto k, auto g) {
    constexpr int K = decltype(k)::value, G = decltype(g)::value;
#define ART_FRAMES(H, D)                                                     \
  launch<H, D, K, G>(walls, wall_stride, n_walls, n_bands, listeners,        \
                     n_listeners, src_c, n_src, mic_c, n_mic, scal, sr, emit,\
                     u, key0, key1, entry_offset, frame_offset, n_entries,   \
                     n_rays, max_bounces, n_frames, ir_length, scratch,      \
                     scratch_floats, scales, acc, out, work, launched, s)
    if (host_uniforms)
      return directive ? ART_FRAMES(true, true) : ART_FRAMES(true, false);
    return directive ? ART_FRAMES(false, true) : ART_FRAMES(false, false);
#undef ART_FRAMES
  }));
}

// K5: the hit rows [B, 8, R] f32 (per bounce direct delay, energy,
// valid, NEE delay, energy, valid, two rows of zeros; zeros where no hit
// was made and in every bounce after a ray dies) of one frame of n_rays
// rays with host uniforms emit [R] and u [B, R, 3], one listener [1, 2]
// and one band: walls [11, W] and scal [5] as for art_trace_frames_ir,
// src_c [n_src] and mic_c [n_mic] the patterns of a directive trace (both
// null for omni). lanes 1 or 4 as there: the same rows at either. work,
// if not null, three device u64, as there (K3's counts on the same
// uniforms). One launch; returns a cudaError_t code (0 = launched).
int art_trace_frame_rows(const float* walls, int n_walls,
                         const float* listener, const float* src_c,
                         int n_src, const float* mic_c, int n_mic,
                         const float* scal, const float* emit, const float* u,
                         int n_rays, int max_bounces, int lanes, float* rows,
                         unsigned long long* work, void* stream) {
  const bool directive = src_c != nullptr || mic_c != nullptr;
  if (n_walls < 1 || n_walls > kMaxWalls || n_rays < 1 || max_bounces < 1 ||
      emit == nullptr || u == nullptr || rows == nullptr ||
      (lanes != 1 && lanes != kLaneGroup) ||
      (directive && (src_c == nullptr || mic_c == nullptr || n_src < 1 ||
                     n_src % 2 != 1 || n_mic < 1 || n_mic % 2 != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!directive) n_src = n_mic = 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define ART_ROWS(D, G)                                                       \
  launch_rows<D, G>(walls, n_walls, listener, src_c, n_src, mic_c, n_mic,    \
                    scal, emit, u, n_rays, max_bounces, rows, work, s)
  cudaError_t err;
  if (lanes == 1)
    err = directive ? ART_ROWS(true, 1) : ART_ROWS(false, 1);
  else
    err = directive ? ART_ROWS(true, kLaneGroup) : ART_ROWS(false, kLaneGroup);
#undef ART_ROWS
  return static_cast<int>(err);
}

// The registers and local (stack) bytes per thread of the instantiation
// of frames_ir_kernel that a launch of n_bands takes without lane groups
// (G = 1), into out[2] (cudaFuncGetAttributes). Returns a cudaError_t
// code.
int art_frames_attributes(int host_uniforms, int n_bands, int directive,
                          int* out) {
  if (n_bands < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const auto get = [&](auto bucket) {
    constexpr int K = decltype(bucket)::value;
    if (host_uniforms)
      return directive
                 ? cudaFuncGetAttributes(&a, frames_ir_kernel<true, true, K, 1>)
                 : cudaFuncGetAttributes(&a,
                                         frames_ir_kernel<true, false, K, 1>);
    return directive
               ? cudaFuncGetAttributes(&a, frames_ir_kernel<false, true, K, 1>)
               : cudaFuncGetAttributes(&a,
                                       frames_ir_kernel<false, false, K, 1>);
  };
  const cudaError_t err = by_bucket<kLargestBucket>(n_bands, get);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
