// The arguments of one single-scene trace launch (K3, K4, K6), packed in
// one launch: the wall table, the per-entry scalars and the fixed-point
// scale that ops/cuda/bounce_kernel.py::_launch_scene hands to
// art_trace_frames_ir.
//
// Its plain twin is that module's pack_walls_banded, pack_scalars and
// fixed_point_scale (k4_args_plain), a chain of some 25 elementwise and
// reduce launches on a few hundred bytes. This kernel makes the same IEEE
// operations in the same order, each rounded on its own (explicit _rn
// intrinsics; the library builds with --fmad=false besides), and the same
// libdevice log2 / floor / exp2 in double as PyTorch's CUDA kernels call,
// so its three outputs equal the twin's bit for bit:
//   walls [10 + K, W] f32: ax, ay, v2x = bx - ax, v2y = by - ay,
//     cc = v2x * ay - v2y * ax, nx, ny, absorption of band 0, scattering,
//     transmission, ior, then the absorption of bands 1 .. K-1 in rows
//     11 .. 9 + K;
//   scal [5] f32: source x, source y, listener radius, speed of sound,
//     input gain;
//   scale [1] f64: d2 = min over listeners of (lx - sx)^2 + (ly - sy)^2 in
//     double, clamped at 1e-12; e = gain * max(0.5 / d2, 1) (0.5 / d2 as
//     PyTorch computes it, the reciprocal times 0.5), times the patterns'
//     gain bound when directive; bound = max(n_hits * e, 1); scale =
//     exp2(floor(62 - log2(bound))).
// NaN propagates through the minimum and the clamps as in PyTorch.
//
// One block: its threads stride over the walls (and the band rows), then
// over the listeners for the minimum, which a shared-memory tree finishes;
// thread 0 writes the scalars and the scale. The scalar inputs are device
// f32, or f64 where bit i of f64_mask is set (source, radius, speed of
// sound, gain: the wrapper converts any other dtype to f64 first), read
// as double for the scale and rounded to f32 for scal, as the twin's
// stack and .double() see them.

#include <cuda_runtime.h>

namespace {

constexpr int kArgsThreads = 256;

__device__ __forceinline__ double load_scalar(const void* p, int i,
                                              bool f64) {
  return f64 ? static_cast<const double*>(p)[i]
             : static_cast<double>(static_cast<const float*>(p)[i]);
}

// PyTorch's amin: the smaller, NaN where either is NaN
__device__ __forceinline__ double min_nan(double m, double d) {
  return (isnan(m) || m < d) ? m : d;
}

// PyTorch's clamp(min=lo): NaN stays NaN
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

__global__ void __launch_bounds__(kArgsThreads) k4_args_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ normal, const float* __restrict__ absorption,
    const float* __restrict__ scattering,
    const float* __restrict__ transmission, const float* __restrict__ ior,
    int n_walls, int n_bands, const void* source, const void* radius,
    const void* speed, const void* gain, int f64_mask,
    const float* __restrict__ listeners, int n_listeners,
    const double* __restrict__ gain_bound, double n_hits,
    float* __restrict__ walls, float* __restrict__ scal,
    double* __restrict__ scale) {
  __shared__ double part[kArgsThreads];
  const int t = threadIdx.x;
  const long long n_w = n_walls;
  for (int w = t; w < n_walls; w += kArgsThreads) {
    const float ax = a[2 * w], ay = a[2 * w + 1];
    const float v2x = __fsub_rn(b[2 * w], ax);
    const float v2y = __fsub_rn(b[2 * w + 1], ay);
    float* col = walls + w;
    col[0] = ax;
    col[n_w] = ay;
    col[2 * n_w] = v2x;
    col[3 * n_w] = v2y;
    col[4 * n_w] = __fsub_rn(__fmul_rn(v2x, ay), __fmul_rn(v2y, ax));
    col[5 * n_w] = normal[2 * w];
    col[6 * n_w] = normal[2 * w + 1];
    col[7 * n_w] = absorption[static_cast<long long>(w) * n_bands];
    col[8 * n_w] = scattering[w];
    col[9 * n_w] = transmission[w];
    col[10 * n_w] = ior[w];
  }
  const long long n_rows = static_cast<long long>(n_bands - 1) * n_w;
  for (long long i = t; i < n_rows; i += kArgsThreads) {
    const long long k = 1 + i / n_w, w = i % n_w;
    walls[(10 + k) * n_w + w] = absorption[w * n_bands + k];
  }

  const double sx = load_scalar(source, 0, f64_mask & 1);
  const double sy = load_scalar(source, 1, f64_mask & 1);
  double m = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  for (int l = t; l < n_listeners; l += kArgsThreads) {
    const double dx = __dsub_rn(static_cast<double>(listeners[2 * l]), sx);
    const double dy =
        __dsub_rn(static_cast<double>(listeners[2 * l + 1]), sy);
    m = min_nan(m, __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)));
  }
  part[t] = m;
  __syncthreads();
  for (int half = kArgsThreads / 2; half > 0; half /= 2) {
    if (t < half) part[t] = min_nan(part[t], part[t + half]);
    __syncthreads();
  }
  if (t != 0) return;

  const double r = load_scalar(radius, 0, f64_mask & 2);
  const double c = load_scalar(speed, 0, f64_mask & 4);
  const double g = load_scalar(gain, 0, f64_mask & 8);
  scal[0] = __double2float_rn(sx);
  scal[1] = __double2float_rn(sy);
  scal[2] = __double2float_rn(r);
  scal[3] = __double2float_rn(c);
  scal[4] = __double2float_rn(g);

  const double d2 = clamp_min(part[0], 1e-12);
  const double near = clamp_min(__dmul_rn(__ddiv_rn(1.0, d2), 0.5), 1.0);
  double e_max = __dmul_rn(g, near);
  if (gain_bound != nullptr) e_max = __dmul_rn(e_max, gain_bound[0]);
  const double bound = clamp_min(__dmul_rn(e_max, n_hits), 1.0);
  scale[0] = exp2(floor(__dsub_rn(62.0, log2(bound))));
}

}  // namespace

extern "C" {

// Packs a single-scene launch's arguments (see the top of this file) from
// the scene's device f32 tensors a [W, 2], b [W, 2], normal [W, 2],
// absorption [W, K], scattering, transmission and ior [W] (contiguous),
// the scalar inputs (source [2], radius, speed of sound and gain, f32 or,
// by f64_mask, f64), listeners [L, 2] f32, gain_bound (one device double:
// the directive patterns' bound; null for omni) and n_hits = F * R * 2 * B
// into walls [10 + K, W] f32, scal [5] f32 and scale [1] f64. One launch
// on `stream`, no host sync. Returns a cudaError_t code (0 = launched).
int art_k4_args(const float* a, const float* b, const float* normal,
                const float* absorption, const float* scattering,
                const float* transmission, const float* ior, int n_walls,
                int n_bands, const void* source, const void* radius,
                const void* speed, const void* gain, int f64_mask,
                const float* listeners, int n_listeners,
                const double* gain_bound, double n_hits, float* walls,
                float* scal, double* scale, void* stream) {
  if (n_walls < 1 || n_bands < 1 || n_listeners < 1 || (f64_mask & ~15) ||
      !(n_hits >= 1.0))
    return static_cast<int>(cudaErrorInvalidValue);
  k4_args_kernel<<<1, kArgsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, normal, absorption, scattering, transmission, ior, n_walls,
      n_bands, source, radius, speed, gain, f64_mask, listeners, n_listeners,
      gain_bound, n_hits, walls, scal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The registers and local (stack) bytes per thread of k4_args_kernel
// into out[2] (cudaFuncGetAttributes). Returns a cudaError_t code.
int art_k4_args_attributes(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k4_args_kernel);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
