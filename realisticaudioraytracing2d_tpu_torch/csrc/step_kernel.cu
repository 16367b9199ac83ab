// One bounce per launch for Hopper (sm_90a): the per-bounce step kernel,
// with the hits written out as records or binned into the IR.
//
// Replaces two TPU kernels of the JAX package
// (realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py):
//   _bounce_kernel (K5, through trace_fused_rows: state in, next state and
//     the raw hit rows of ONE bounce out; one listener, one band), and
//   _make_bounce_hist_kernel (K6, through trace_frame_ir_fused: the same
//     bounce with the binning of its hits in the kernel).
// Both are one template, bounce_step_kernel<kRows, kHostUniforms,
// kDirective>, over where a hit goes: RowSink (K5) or the fixed-point Sink (K6) of
// trace_common.cuh, whose finish_bounce is the bounce itself, shared with
// K3/K4/K9 and K7/K8, so the physics cannot drift. The semantics are those
// of the plain oracle ops/trace.py::_bounce, one bounce at a time on an
// explicit state. The TPU layout (state [16, Rp] on lanes, u [8, Rp], the
// Newton reciprocal and division-free segment test of _wall_pass, the
// one-hot MXU gather and the two-level bf16 histogram) is not carried over:
// K6 bins into the same u64 accumulator with the same scale as K3, so K6
// and K3 give the same bits on the same uniforms, and K6 with a seed gives
// K4's bits.
//
// Design:
//  * One thread per ray. Between launches a ray's state lives in device
//    memory as struct-of-arrays: state [8, R] f32 (px py dx dy energy time
//    distance speed) and depth [R] i32, -1 for a dead ray, updated in
//    place (a thread reads and writes only its own column). Bounce 0 emits
//    the ray and reads no state.
//  * The wall table [11, W] and the listeners are packed into shared
//    memory by every block, as in bounce_kernel.cu (a WallTable: one
//    float4 of geometry per wall, cc, six attribute rows); the same
//    5,280-wall limit applies. The sweeps are scan_nearest / scan_blocker
//    of trace_common.cuh: a division-free filter, then the exact test on
//    the few walls it leaves.
//  * Uniforms: host u[R, 3] of this bounce and emit[R] (bounce 0), or
//    Philox by counter (ray, frame, bounce, 0) as K4 draws them.
//  * kDirective: bounce 0 weights the emission by the source pattern and
//    every hit is weighted by its listener's microphone pattern, as in
//    K3/K4 (trace_common.cuh), the coefficients staged in shared memory
//    beside the listeners. The JAX K5/K6 refuse microphone patterns only
//    because of their TPU row layout; here a row holds the weighted
//    energy the plain trace's hit holds.
//  * K5 zeroes its ray's column of the [8, R] rows before the bounce, dead
//    rays included, so a hit that did not happen reads as zeros with
//    valid = 0 (the JAX kernel writes stale values with valid = 0 there).
//  * K6 adds to a u64 accumulator that the caller zeroes before bounce 0
//    and converts after the last (art_fixed_to_float of accel_kernel.cu).
//
// What bounds it: bytes, on a room of a few dozen walls. The work is K3's
// (one nearest sweep per live ray and one occlusion sweep per listener, 13
// FP32 operations per wall test plus 3 per sweep), but handing out
// records costs, per ray and bounce, the uniforms in (12 B), the state
// round trip (2 x 36 B) and, for K5, 32 B of rows, which at SmollRoom's 24
// walls outweigh the ~50 wall tests. Against K3 it also adds a launch per
// bounce, and every block of every launch reloads the wall table.

#include "trace_common.cuh"

namespace {

constexpr int kStepThreads = 256;
constexpr int kStepMaxSmemBytes = 232448;  // 227 KB per block on sm_90
// K5/K6 take at most 16 listeners (the JAX kernels 4; engine.trace_hits
// sends larger requests for hits to K1/K2)
constexpr int kMaxListeners = 16;
constexpr int kStepMaxWalls =
    (kStepMaxSmemBytes - 2 * kMaxListeners * 4) / (kWallFields * 4);
constexpr int kHitRows = 8;

template <bool kRows, bool kHostUniforms, bool kDirective>
__global__ void __launch_bounds__(kStepThreads) bounce_step_kernel(
    const float* __restrict__ walls, int n_walls,
    const float* __restrict__ listeners, int n_listeners,
    const float* __restrict__ src_c, int n_src,
    const float* __restrict__ mic_c, int n_mic,
    const float* __restrict__ scal, float sr, const float* __restrict__ emit,
    const float* __restrict__ u, uint32_t key0, uint32_t key1, int frame,
    int n_rays, int max_bounces, int bounce, int ir_length,
    const double* __restrict__ scale, float* __restrict__ state,
    int* __restrict__ depth, float* __restrict__ rows,
    unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ work_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WallTable table = load_wall_table(walls, n_walls, 0, n_walls,
                                          kWallFields - 5, smem);
  float* s_lis = smem + kWallFields * n_walls;  // [L][2]
  for (int i = threadIdx.x; i < 2 * n_listeners; i += blockDim.x)
    s_lis[i] = listeners[i];
  float* s_src = s_lis + 2 * n_listeners;  // [n_src], then [L, n_mic]
  float* s_mic = s_src + n_src;
  if constexpr (kDirective) {
    stage(src_c, n_src, s_src);
    stage(mic_c, n_listeners * n_mic, s_mic);
  }
  __syncthreads();

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  Work work;
  if (ray < n_rays) {
    if (kRows) {
      for (int row = 0; row < kHitRows; ++row)
        rows[static_cast<size_t>(row) * n_rays + ray] = 0.0f;
    }
    const int dep = bounce == 0 ? 0 : depth[ray];
    if (dep >= 0) {
      const size_t n = static_cast<size_t>(n_rays);
      float* s = state + ray;
      Ray<1> r;
      if (bounce == 0) {
        const float jitter =
            kHostUniforms
                ? emit[ray]
                : philox_uniforms(ray, frame, max_bounces, 0, key0, key1).u0;
        r = emit_ray<1, kDirective>(ray, n_rays, jitter, scal[0], scal[1],
                                    scal[3], scal[4], s_src, n_src);
      } else {
        r.px = s[0];
        r.py = s[n];
        r.dx = s[2 * n];
        r.dy = s[3 * n];
        r.en[0] = s[4 * n];
        r.tm = s[5 * n];
        r.ds = s[6 * n];
        r.sp = s[7 * n];
        r.dep = dep;
      }
      // nearest wall: the lowest index among the smallest distances
      float closest = kInf;
      int best = 0x7fffffff;
      scan_nearest(table, 0, n_walls, make_probe(r.px, r.py, r.dx, r.dy),
                   closest, best);
      const int hit = closest < kInf ? best : -1;
      work.tests += n_walls;
      ++work.sweeps;
      // one occlusion sweep: stop at the first wall that blocks the shadow
      // ray before `limit`
      auto occluded = [&](float sx, float sy, float vdx, float vdy, float,
                          float limit) {
        const int blocker = scan_blocker(
            table, 0, n_walls, make_probe(sx, sy, vdx, vdy), limit);
        work.tests += blocker < 0 ? n_walls : blocker + 1;
        ++work.sweeps;
        return blocker >= 0;
      };
      auto draw = [&]() -> Uniforms {
        if (kHostUniforms)
          return {u[3 * ray], u[3 * ray + 1], u[3 * ray + 2]};
        return philox_uniforms(ray, frame, bounce, 0, key0, key1);
      };
      const Listeners lis{s_lis, n_listeners, scal[2] * scal[2], scal[3],
                          s_mic, n_mic};
      bool alive;
      if constexpr (kRows) {
        const RowSink sink{rows, n_rays, ray};
        alive = finish_bounce<1, kDirective>(r, closest, hit, table, lis,
                                             sink, occluded, draw);
      } else {
        const Sink sink{acc, ir_length, 1, sr, *scale};
        alive = finish_bounce<1, kDirective>(r, closest, hit, table, lis,
                                             sink, occluded, draw);
      }
      s[0] = r.px;
      s[n] = r.py;
      s[2 * n] = r.dx;
      s[3 * n] = r.dy;
      s[4 * n] = r.en[0];
      s[5 * n] = r.tm;
      s[6 * n] = r.ds;
      s[7 * n] = r.sp;
      depth[ray] = alive ? r.dep : -1;
    }
  }
  if (work_out != nullptr)  // every thread of the block reaches this point
    add_work(work, work_out);
}

template <bool kRows, bool kHostUniforms, bool kDirective>
cudaError_t launch_step(const float* walls, int n_walls,
                        const float* listeners, int n_listeners,
                        const float* src_c, int n_src, const float* mic_c,
                        int n_mic, const float* scal, float sr, const float* emit,
                        const float* u, uint32_t key0, uint32_t key1,
                        int frame, int n_rays, int max_bounces, int bounce,
                        int ir_length, const double* scale, float* state,
                        int* depth, float* rows, unsigned long long* acc,
                        unsigned long long* work, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kWallFields * static_cast<size_t>(n_walls) +
                       2 * static_cast<size_t>(n_listeners) + n_src +
                       static_cast<size_t>(n_listeners) * n_mic);
  if (smem > kStepMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bounce_step_kernel<kRows, kHostUniforms, kDirective>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (n_rays + kStepThreads - 1) / kStepThreads;
  bounce_step_kernel<kRows, kHostUniforms, kDirective>
      <<<grid, kStepThreads, smem, stream>>>(
      walls, n_walls, listeners, n_listeners, src_c, n_src, mic_c, n_mic,
      scal, sr, emit, u, key0, key1,
      frame, n_rays, max_bounces, bounce, ir_length, scale, state, depth,
      rows, acc, work);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One bounce (0 .. max_bounces - 1) of n_rays rays whose state is state
// [8, R] f32 (px py dx dy energy time distance speed) and depth [R] i32
// (-1 = dead), updated in place; bounce 0 emits the rays and reads no
// state. walls [11, W] (see WallField), listeners [L, 2], scal [5] =
// (source x, source y, listener radius, speed of sound, input gain), all
// device f32. host_uniforms != 0 reads u [R, 3] (this bounce's draws) and,
// at bounce 0, emit [R]; otherwise the kernel draws Philox numbers under
// (key0, key1) by counter (ray, frame, bounce, 0). If rows is not null
// (K5; L = 1) the bounce's hit records go to rows [8, R] f32 (direct
// delay, energy, valid, NEE delay, energy, valid, 0, 0) and acc, scale and
// ir_length are unused; otherwise (K6) its hits add to acc [L, T] u64
// under *scale (zeroed by the caller before bounce 0, converted by
// art_fixed_to_float after the last). src_c [n_src] and mic_c [L, n_mic]
// (device f32, n odd) are the source and microphone patterns of a
// directive trace, both null for omni. work, if not null, three device
// u64 (wall tests, wall sweeps, slab tests). Returns a cudaError_t code
// (0 = launched).
int art_bounce_step(int host_uniforms, const float* walls, int n_walls,
                    const float* listeners, int n_listeners,
                    const float* src_c, int n_src, const float* mic_c,
                    int n_mic, const float* scal, float sr, const float* emit,
                    const float* u, unsigned int key0, unsigned int key1,
                    int frame, int n_rays, int max_bounces, int bounce,
                    int ir_length, const double* scale, float* state,
                    int* depth, float* rows, unsigned long long* acc,
                    unsigned long long* work, void* stream) {
  const bool want_rows = rows != nullptr;
  if (n_walls < 1 || n_walls > kStepMaxWalls || n_listeners < 1 ||
      n_listeners > kMaxListeners || (want_rows && n_listeners != 1) ||
      n_rays < 1 || max_bounces < 1 || bounce < 0 || bounce >= max_bounces ||
      frame < 0 || state == nullptr || depth == nullptr ||
      (!want_rows && (acc == nullptr || scale == nullptr || ir_length < 1)) ||
      (host_uniforms && (u == nullptr || (bounce == 0 && emit == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool directive = src_c != nullptr || mic_c != nullptr;
  if (directive && (src_c == nullptr || mic_c == nullptr || n_src < 1 ||
                    n_src % 2 != 1 || n_mic < 1 || n_mic % 2 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!directive) n_src = n_mic = 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define ART_STEP(R, H, D)                                                    \
  launch_step<R, H, D>(walls, n_walls, listeners, n_listeners, src_c, n_src, \
                       mic_c, n_mic, scal, sr, emit, u, key0, key1, frame,   \
                       n_rays, max_bounces, bounce, ir_length, scale, state, \
                       depth, rows, acc, work, s)
#define ART_STEP_D(R, H)                                                     \
  (directive ? ART_STEP(R, H, true) : ART_STEP(R, H, false))
  cudaError_t err;
  if (want_rows)
    err = host_uniforms ? ART_STEP_D(true, true) : ART_STEP_D(true, false);
  else
    err = host_uniforms ? ART_STEP_D(false, true) : ART_STEP_D(false, false);
#undef ART_STEP_D
#undef ART_STEP
  return static_cast<int>(err);
}

// The registers and local (stack) bytes per thread of one instantiation
// of bounce_step_kernel into out[2] (cudaFuncGetAttributes). Returns a
// cudaError_t code.
int art_step_attributes(int rows, int host_uniforms, int directive,
                        int* out) {
  cudaFuncAttributes a;
#define ART_ATTR(R, H, D) cudaFuncGetAttributes(&a, bounce_step_kernel<R, H, D>)
#define ART_ATTR_D(R, H) \
  (directive ? ART_ATTR(R, H, true) : ART_ATTR(R, H, false))
  cudaError_t err;
  if (rows)
    err = host_uniforms ? ART_ATTR_D(true, true) : ART_ATTR_D(true, false);
  else
    err = host_uniforms ? ART_ATTR_D(false, true) : ART_ATTR_D(false, false);
#undef ART_ATTR_D
#undef ART_ATTR
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
