// Monte-Carlo bounce kernel for Hopper (sm_90a): whole frames, batched
// over rooms or sources.
//
// Replaces three TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py):
//   _make_frame_hist_kernel (K3, through trace_frame_ir_whole: uniforms
//     drawn on the host),
//   _make_mega_kernel (K4, through trace_frames_ir_mega: all frames in one
//     launch, random numbers drawn on the device), and
//   _make_rooms_mega_kernel (K9, through trace_rooms_ir_mega: K4 over a
//     batch of E entries, rooms of a sweep or sources of a mixdown, each
//     with its own wall table or one shared table, listeners, source,
//     gain, radius, speed of sound and fixed-point scale).
// All three compute the same thing (emission, every bounce of _bounce_step
// and the IR binning of _hist_listener) and differ only in where the
// uniforms come from and in the batch axis, so they are one template,
// frames_ir_kernel<kHostUniforms>, whose grid z axis is the batch entry:
// K3 and K4 are its E = 1 case. The semantics are those of the plain
// oracle ops/trace.py::_bounce + ops/ir.py::scatter_hits of this package;
// the TPU layout (rays on lanes, one-hot MXU gather, two-level bf16
// histogram, K9's [Rg, Wp, 8] blocks and its seed plan) is not carried
// over.
//
// Design:
//  * One thread per (ray, frame, entry); its state (pos, dir, energy,
//    time, distance, speed, depth) lives in registers. Grid
//    (ceil(R/256), F, E): entries on z keep F and E each under the 65,535
//    limit of those axes.
//  * Each block loads its entry's wall table into shared memory as
//    struct-of-arrays (ax, ay, v2x, v2y, cc, nx, ny, abs, scat, trans,
//    ior: 44 B per wall), plus its listener table (<= 16 listeners). The
//    tables are [E or 1, 11, W] and [E, L, 2]; a wall stride of 0 shares
//    one scene among all entries (the mixdown) without copying it. The
//    attribute gather is an indexed shared-memory load. The 227 KB a
//    block can use caps a scene at kMaxWalls = 5280 walls; larger scenes
//    belong to the cluster kernels (K7/K8), which are not ported yet.
//  * Nearest wall: walls scanned in ascending order with a strict '<', so
//    the lowest index wins among equal distances (the oracle's argmin).
//    Padding walls are degenerate (a == b, so v2 == 0): dotp == 0 marks
//    them parallel to every ray and they never hit, as in the oracle.
//  * Arithmetic is IEEE: '/', sqrtf, sincosf, asinf, no fast math, and the
//    build passes --fmad=false so no multiply-add is contracted. The
//    diffuse direction keeps the oracle's form, asin then rotate.
//  * IR binning: each valid hit adds llrint(e * S_e) into an unsigned
//    64-bit [E, L, T] accumulator with atomicAdd in global memory (a
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
//  * An optional counter (work != nullptr) sums the wall tests the launch
//    really made and the wall sweeps they belong to (one warp-reduced
//    atomic per warp and counter), so a bound can be computed from this
//    run's data.
//
// What bounds it: the wall pass is compute-bound, O(R * W * B * (1 + L))
// intersection tests of 13 FP32 operations each (two of them divides),
// plus 3 per sweep for the ray's own cross product (oy * dx - ox * dy),
// which does not depend on the wall; one nearest-wall sweep per live
// bounce plus one occlusion sweep per listener, which stops at the first
// blocking wall. The bytes it must move
// (wall tables in, the f32 IR out) are far fewer. Hits that land in the
// same bins contend on the atomics (the early bins of an IR gather most
// of them). This first design keeps both simple; tiling walls through
// registers, warp-aggregated or shared-memory time windows for the
// histogram, and a persistent grid are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-4f;
constexpr float kInf = 1e8f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265);
constexpr float kEnergyCutoff = 1e-3f;
constexpr float kNeeCutoff = 1e-5f;
constexpr float kOcclusionSlack = 0.1f;
constexpr int kThreads = 256;
constexpr int kWallFields = 11;
constexpr int kScalFields = 5;
constexpr int kMaxListeners = 16;
constexpr int kMaxSmemBytes = 232448;  // 227 KB per block on sm_90
constexpr int kMaxWalls =
    (kMaxSmemBytes - 2 * kMaxListeners * 4) / (kWallFields * 4);

enum WallField { AX, AY, V2X, V2Y, CC, NX, NY, ABS, SCAT, TRANS, IOR };

struct Uniforms {
  float u0, u1, u2;
};

struct Work {  // what one ray did: wall tests and the sweeps they belong to
  unsigned long long tests = 0, sweeps = 0;
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
    const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += W0;
    k1 += W1;
  }
}

__device__ __forceinline__ float u24(uint32_t w) {
  return static_cast<float>(w >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Ray-segment distance, the operation order of geometry.py::
// pairwise_ray_segment_t (cc = v2x * ay - v2y * ax precomputed).
__device__ __forceinline__ float wall_t(const float* w, int n, int i,
                                       float ox, float oy, float dx,
                                       float dy) {
  const float ax = w[AX * n + i], ay = w[AY * n + i];
  const float v2x = w[V2X * n + i], v2y = w[V2Y * n + i];
  const float cc = w[CC * n + i];
  const float dotp = v2y * dx - v2x * dy;
  const bool parallel = fabsf(dotp) < kEps;
  const float safe = parallel ? 1.0f : dotp;
  const float t1 = (v2x * oy - v2y * ox - cc) / safe;
  const float t2 = ((oy * dx - ox * dy) - (ay * dx - ax * dy)) / safe;
  return (!parallel && t1 >= kEps && t2 >= 0.0f && t2 <= 1.0f) ? t1 : kInf;
}

// Safe normalize (geometry.py::normalize).
__device__ __forceinline__ void normalize2(float& x, float& y) {
  const float n2 = x * x + y * y;
  const float inv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  x *= inv;
  y *= inv;
}

__device__ __forceinline__ void deposit(unsigned long long* acc, int row,
                                        int ir_length, float delay,
                                        float energy, float sr,
                                        double scale) {
  const float fb = floorf(delay * sr);
  if (!(fb >= 0.0f && fb < static_cast<float>(ir_length))) return;
  const unsigned long long q =
      static_cast<unsigned long long>(llrint(static_cast<double>(energy) *
                                             scale));
  if (q) atomicAdd(acc + static_cast<size_t>(row) * ir_length +
                       static_cast<int>(fb),
                   q);
}

template <bool kHostUniforms>
__device__ __forceinline__ Work trace_ray(
    const float* s_walls, int n_walls, const float* s_lis, int n_listeners,
    const float* scal, float sr, const float* emit, const float* u,
    uint32_t key0, uint32_t key1, uint32_t entry_id, int ray, int frame,
    int n_frames, int entry, int n_rays, int max_bounces, int ir_length,
    double scale, unsigned long long* acc) {
  const float src_x = scal[0], src_y = scal[1], radius = scal[2];
  const float c = scal[3], gain = scal[4];
  const float r2 = radius * radius;
  Work work;

  auto draw = [&](int bounce) -> Uniforms {
    if (kHostUniforms) {
      const size_t o =
          ((static_cast<size_t>(entry) * n_frames + frame) * max_bounces +
           bounce) * n_rays + ray;
      return {u[3 * o], u[3 * o + 1], u[3 * o + 2]};
    }
    uint32_t ctr[4] = {static_cast<uint32_t>(ray),
                       static_cast<uint32_t>(frame),
                       static_cast<uint32_t>(bounce), entry_id};
    philox4x32_10(ctr, key0, key1);
    return {u24(ctr[0]), u24(ctr[1]), u24(ctr[2])};
  };

  // --- emission (ops/trace.py::_emit) ---------------------------------------
  const float jitter0 =
      kHostUniforms
          ? emit[(static_cast<size_t>(entry) * n_frames + frame) * n_rays +
                 ray]
          : draw(max_bounces).u0;
  const float angle =
      (static_cast<float>(ray) + jitter0) / static_cast<float>(n_rays) *
      kTwoPi;
  float px = src_x, py = src_y, dx, dy;
  sincosf(angle, &dy, &dx);
  float en = gain, tm = 0.0f, ds = 0.0f, sp = c;
  int dep = 0;

  for (int b = 0; b < max_bounces; ++b) {
    // --- nearest wall ------------------------------------------------------
    float closest = kInf;
    int hit = -1;
    for (int i = 0; i < n_walls; ++i) {
      const float t = wall_t(s_walls, n_walls, i, px, py, dx, dy);
      if (t < closest) {
        closest = t;
        hit = i;
      }
    }
    work.tests += n_walls;
    ++work.sweeps;

    // --- direct listener capture, outside walls only -------------------------
    if (dep == 0) {
      for (int l = 0; l < n_listeners; ++l) {
        const float lx = s_lis[2 * l] - px, ly = s_lis[2 * l + 1] - py;
        const float tca = lx * dx + ly * dy;
        const float d2 = (lx * lx + ly * ly) - tca * tca;
        if (!(tca >= 0.0f && d2 <= r2)) continue;
        const float thc = (r2 - d2) > 0.0f ? sqrtf(r2 - d2) : 0.0f;
        const float t0 = tca - thc, t1 = tca + thc;
        const float t_lis = t0 > kEps ? t0 : (t1 > kEps ? t1 : kInf);
        if (!(t_lis < closest && t_lis < kInf)) continue;
        const float total_d = ds + t_lis;
        deposit(acc, l, ir_length, tm + t_lis / sp,
                en / fmaxf(total_d * total_d, 1.0f), sr, scale);
      }
    }
    if (hit < 0) break;  // escaped: dead from here on

    // --- advance to the wall -------------------------------------------------
    const float npx = px + dx * closest, npy = py + dy * closest;
    const float ntm = tm + closest / sp, nds = ds + closest;
    const float w_nx = s_walls[NX * n_walls + hit];
    const float w_ny = s_walls[NY * n_walls + hit];
    const float w_abs = s_walls[ABS * n_walls + hit];
    const float w_scat = s_walls[SCAT * n_walls + hit];
    const float w_trans = s_walls[TRANS * n_walls + hit];
    const float w_ior = s_walls[IOR * n_walls + hit];
    const float d_dot_n = dx * w_nx + dy * w_ny;

    // --- NEE with occlusion (shadow ray offset along the UNflipped normal,
    //     direction normalized by the unoffset distance: reference quirks) --
    if (dep == 0) {
      const float sx = npx + w_nx * kEps, sy = npy + w_ny * kEps;
      const float eff_sign = d_dot_n > 0.0f ? -1.0f : 1.0f;
      const float enx = w_nx * eff_sign, eny = w_ny * eff_sign;
      for (int l = 0; l < n_listeners; ++l) {
        const float lx = s_lis[2 * l], ly = s_lis[2 * l + 1];
        const float tx = lx - npx, ty = ly - npy;
        const float dist_l = sqrtf(fmaxf(tx * tx + ty * ty, 1e-20f));
        const float cos_t = fmaxf(enx * (tx / dist_l) + eny * (ty / dist_l),
                                  0.0f);
        const float total_dn = nds + dist_l;
        const float geom = cos_t * 0.5f / (total_dn * total_dn);
        const float e_nee = en * (1.0f - w_abs) * geom;
        if (!(e_nee > kNeeCutoff)) continue;
        const float vdx = (lx - sx) / dist_l, vdy = (ly - sy) / dist_l;
        const float limit = dist_l - kOcclusionSlack;
        bool visible = true;
        int i = 0;
        for (; i < n_walls && visible; ++i)
          visible = wall_t(s_walls, n_walls, i, sx, sy, vdx, vdy) >= limit;
        work.tests += i;
        ++work.sweeps;
        // The listener leg uses the rest-frame speed c, not the current one.
        if (visible)
          deposit(acc, l, ir_length, ntm + dist_l / c, e_nee, sr, scale);
      }
    }

    // --- absorption + cutoff -------------------------------------------------
    const float nen = en * (1.0f - w_abs);
    if (!(nen >= kEnergyCutoff)) break;

    const Uniforms uv = draw(b);

    // --- transmission / refraction -------------------------------------------
    const bool entering = d_dot_n < 0.0f;
    const float nex = entering ? w_nx : -w_nx;
    const float ney = entering ? w_ny : -w_ny;
    const float wall_speed = c / w_ior;
    const float next_speed =
        entering ? wall_speed : (dep <= 1 ? c : wall_speed);
    const float eta = next_speed / sp;
    const float cosi = -(dx * nex + dy * ney);
    const float cost2 = 1.0f - eta * eta * (1.0f - cosi * cosi);
    const bool refr_ok = cost2 > 0.0f;
    const bool transmit = (uv.u0 < w_trans) && refr_ok;

    float ndx, ndy;
    if (transmit) {
      const float coef = eta * cosi - sqrtf(fabsf(cost2));
      const float rx = eta * dx + coef * nex, ry = eta * dy + coef * ney;
      float sj, cj;
      sincosf((uv.u1 - 0.5f) * 2.0f * w_scat, &sj, &cj);
      ndx = rx * cj - ry * sj;
      ndy = rx * sj + ry * cj;
      normalize2(ndx, ndy);
    } else {
      // --- reflection: specular/diffuse lerp ---------------------------------
      const float dn2 = 2.0f * (dx * nex + dy * ney);
      const float spx = dx - dn2 * nex, spy = dy - dn2 * ney;
      float sd, cd;
      sincosf(asinf(fminf(fmaxf(2.0f * uv.u2 - 1.0f, -1.0f), 1.0f)), &sd,
              &cd);
      const float ddx = nex * cd - ney * sd, ddy = nex * sd + ney * cd;
      ndx = spx + (ddx - spx) * w_scat;
      ndy = spy + (ddy - spy) * w_scat;
      normalize2(ndx, ndy);
    }

    px = npx + (transmit ? ndx * kEps : nex * kEps);
    py = npy + (transmit ? ndy * kEps : ney * kEps);
    dx = ndx;
    dy = ndy;
    en = nen;
    tm = ntm;
    ds = nds;
    if (transmit) {
      sp = next_speed;
      dep = entering ? dep + 1 : max(0, dep - 1);
    }
  }
  return work;
}

template <bool kHostUniforms>
__global__ void __launch_bounds__(kThreads) frames_ir_kernel(
    const float* __restrict__ walls, long long wall_stride, int n_walls,
    const float* __restrict__ listeners, int n_listeners,
    const float* __restrict__ scal, float sr,
    const float* __restrict__ emit, const float* __restrict__ u,
    uint32_t key0, uint32_t key1, uint32_t entry_offset, int n_rays,
    int max_bounces, int ir_length, const double* __restrict__ scales,
    unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ work_out) {
  extern __shared__ float smem[];
  const int entry = blockIdx.z;
  walls += entry * wall_stride;  // stride 0: one scene shared by all entries
  listeners += static_cast<size_t>(entry) * 2 * n_listeners;
  float* s_walls = smem;                              // [11][W]
  float* s_lis = smem + kWallFields * n_walls;        // [L][2]
  for (int i = threadIdx.x; i < kWallFields * n_walls; i += blockDim.x)
    s_walls[i] = walls[i];
  for (int i = threadIdx.x; i < 2 * n_listeners; i += blockDim.x)
    s_lis[i] = listeners[i];
  __syncthreads();

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  Work work;
  if (ray < n_rays)
    work = trace_ray<kHostUniforms>(
        s_walls, n_walls, s_lis, n_listeners, scal + kScalFields * entry, sr,
        emit, u, key0, key1, entry_offset + static_cast<uint32_t>(entry),
        ray, blockIdx.y, gridDim.y, entry, n_rays, max_bounces, ir_length,
        scales[entry],
        acc + static_cast<size_t>(entry) * n_listeners * ir_length);
  if (work_out != nullptr) {  // every thread of the block reaches this point
    for (int off = 16; off > 0; off >>= 1) {
      work.tests += __shfl_down_sync(0xffffffffu, work.tests, off);
      work.sweeps += __shfl_down_sync(0xffffffffu, work.sweeps, off);
    }
    if ((threadIdx.x & 31) == 0 && work.sweeps) {
      atomicAdd(work_out, work.tests);
      atomicAdd(work_out + 1, work.sweeps);
    }
  }
}

// out[e, i] = acc[e, i] / S_e over the [E, per_entry] accumulator.
__global__ void fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                                      const double* __restrict__ scales,
                                      float* __restrict__ out, size_t n,
                                      size_t per_entry) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = static_cast<float>(static_cast<double>(acc[i]) /
                                scales[i / per_entry]);
}

template <bool kHostUniforms>
cudaError_t launch(const float* walls, long long wall_stride, int n_walls,
                   const float* listeners, int n_listeners, const float* scal,
                   float sr, const float* emit, const float* u, uint32_t key0,
                   uint32_t key1, uint32_t entry_offset, int n_entries,
                   int n_rays, int max_bounces, int n_frames, int ir_length,
                   const double* scales, unsigned long long* acc, float* out,
                   unsigned long long* work, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kWallFields * static_cast<size_t>(n_walls) +
                       2 * static_cast<size_t>(n_listeners));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frames_ir_kernel<kHostUniforms>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const size_t per_entry = static_cast<size_t>(n_listeners) * ir_length;
  const size_t n = per_entry * n_entries;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * n,
                                    stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rays + kThreads - 1) / kThreads, n_frames, n_entries);
  frames_ir_kernel<kHostUniforms><<<grid, kThreads, smem, stream>>>(
      walls, wall_stride, n_walls, listeners, n_listeners, scal, sr, emit, u,
      key0, key1, entry_offset, n_rays, max_bounces, ir_length, scales, acc,
      work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fixed_to_float_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0,
                          stream>>>(acc, scales, out, n, per_entry);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Frame-summed IRs out[E, L, T] (f32) of n_frames frames for each of
// n_entries batch entries. host_uniforms != 0 reads emit[E, F, R] and
// u[E, F, B, R, 3] (K3); otherwise draws Philox numbers under (key0, key1)
// with counter word 3 = entry_offset + e (K4 is E = 1, offset 0; K9 any
// E). walls is [E or 1, 11, W] (see WallField) with wall_stride 11 * W or
// 0 (shared), listeners [E, L, 2], scal [E, 5] = (source x, source y,
// listener radius, speed of sound, input gain), all device f32; scales
// [E] device doubles, acc [E, L, T] u64 scratch; work, if not null, two
// device u64 to which the launch adds the wall tests it made and the wall
// sweeps (nearest or occlusion) they belong to. Returns a cudaError_t code
// (0 = launched).
int art_trace_frames_ir(int host_uniforms, const float* walls,
                        long long wall_stride, int n_walls,
                        const float* listeners, int n_listeners,
                        const float* scal, float sr, const float* emit,
                        const float* u, unsigned int key0, unsigned int key1,
                        unsigned int entry_offset, int n_entries, int n_rays,
                        int max_bounces, int n_frames, int ir_length,
                        const double* scales, unsigned long long* acc,
                        float* out, unsigned long long* work, void* stream) {
  if (n_walls < 1 || n_walls > kMaxWalls || n_listeners < 1 ||
      n_listeners > kMaxListeners || n_rays < 1 || n_frames < 1 ||
      n_frames > 65535 || n_entries < 1 || n_entries > 65535 ||
      max_bounces < 1 || ir_length < 1 ||
      (wall_stride != 0 && wall_stride != kWallFields * n_walls))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      host_uniforms
          ? launch<true>(walls, wall_stride, n_walls, listeners, n_listeners,
                         scal, sr, emit, u, key0, key1, entry_offset,
                         n_entries, n_rays, max_bounces, n_frames, ir_length,
                         scales, acc, out, work, s)
          : launch<false>(walls, wall_stride, n_walls, listeners, n_listeners,
                          scal, sr, emit, u, key0, key1, entry_offset,
                          n_entries, n_rays, max_bounces, n_frames, ir_length,
                          scales, acc, out, work, s);
  return static_cast<int>(err);
}

}  // extern "C"
