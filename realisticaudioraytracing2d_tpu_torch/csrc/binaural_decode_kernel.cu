// The binaural decode of a spatial IR in one launch: spatial.py's
// SpatialIR.binaural and binaural_decode_ir, the DirAC-style two-ear
// decode of the W/X/Y capture, as a gather.
//
// It replaces no TPU kernel: the JAX package's decode is jnp, which XLA
// fuses. It was added because on the card the plain chain
// (spatial.py::binaural_plain) is some 92 PyTorch launches a decode: the
// split, the bearing, each ear's positions and gains, the concatenation
// of rows and values, the two-bin splat through ops/ir.py::add_rows
// (the deterministic index_put_, which sorts the 4 L T K entries and
// walks each row's duplicates), the diffuse term and the final cat. A
// binaural chunk decodes twice (the full capture and the per-arrival
// residual). The decode's bound is bytes: at [3, 72,000, 1] it reads
// 864 KB of capture and 576 KB of ear signs and writes 576 KB, ~0.6 us
// at 3.35 TB/s.
//
// The splat is a scatter: source bin b of ear e deposits e (1 - frac) at
// lo = floor(t) and e frac at hi = min(lo + 1, T - 1), t = clamp(b - sign
// max_shift sin(phi), 0, T - 1). A target moves at most max_shift plus a
// rounding from its source, so each output bin is a gather over the
// sources within +-H bins (window_half_width, the same rule as
// ops/cuda/binaural_kernel.py::window_half_width), and no atomics are
// needed: a rerun gives the same bits.
//
// Grid: blocks over (tile of kDecodeTile output bins, listener row l,
// band k) on x and the ear on y; a thread owns one output bin. A block
// first computes the per-source values of its tile plus as much of its
// window as `halo` source bins on each side hold, into shared memory (a
// deposit as its bin and value, 8 bytes), with the chain's
// float32 operations in the chain's order (each rounded on its own:
// explicit _rn intrinsics, and the library builds with --fmad=false; the
// same libdevice atan2f / sinf as PyTorch's CUDA kernels call), so lo,
// hi and both deposits equal the chain's bit for bit:
//   x = C0 - W, y = C90 - W (capture rows; given as they are otherwise),
//   coh = min(sqrt(x x + y y), W), diffuse = W - coh,
//   s = sin(atan2(y, x) - facing),
//   t = clamp(b - (sign max_shift) s, 0, T - 1), lo, frac = t - lo, hi,
//   e = coh ((sign shadow) s + 1),
//   deposits e (1 - frac) and e frac.
// Then each thread sums from 0, in the order of the chain's concatenated
// entries (the CPU index_add_ order): first e (1 - frac) of every source
// with lo == its bin, ascending source bin, then e frac of every source
// with hi == its bin, ascending; and adds diffuse * ear_sign[t] (diffuse
// alone without decorrelation).
//
// The halo: the host sizes it for the max_shift it knows (a speed of
// sound given as a number or a host tensor), or for the slowest speed it
// assumes (a card tensor it cannot read without a sync), capped at
// kMaxSharedHalo. The window a block reads comes from max_shift as the
// card computes it; a source of the window outside the shared range is
// computed from global memory by the same function, in the same order,
// so a slower speed of sound than the host assumed costs time, not bits.

#include <cuda_runtime.h>

namespace {

constexpr int kDecodeTile = 256;      // output bins of a block, one a thread
constexpr int kMaxSharedHalo = 1280;  // 16 B x 2,816 + 1 KB < 48 KB
constexpr int kMaxBins = 1 << 24;     // float32 bin indices stay exact

// PyTorch's minimum: NaN where either is NaN, the first one
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// PyTorch's clamp(v, lo, hi) with scalar limits: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

struct Inputs {
  const float* w;
  const float* x;
  const float* y;
  bool capture;  // x, y hold the cardioid rows C0, C90: subtract W
};

__device__ __forceinline__ void xyw(const Inputs& in, long long i, float& w,
                                    float& x, float& y) {
  w = in.w[i];
  x = in.x[i];
  y = in.y[i];
  if (in.capture) {
    x = __fsub_rn(x, w);
    y = __fsub_rn(y, w);
  }
}

__device__ __forceinline__ float coherent(float w, float x, float y) {
  return min_nan(__fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y))), w);
}

struct Entry {
  int lo, hi;
  float v_lo, v_hi, diffuse;
};

// One source bin's two deposits for one ear (shift = sign max_shift,
// shade = sign shadow), as the chain computes them, and its diffuse rest.
__device__ __forceinline__ Entry source_entry(const Inputs& in, long long i,
                                              int bin, float facing,
                                              float shift, float shade,
                                              int n_t) {
  float w, x, y;
  xyw(in, i, w, x, y);
  const float coh = coherent(w, x, y);
  const float s = sinf(__fsub_rn(atan2f(y, x), facing));
  const float t = clamp_nan(
      __fsub_rn(static_cast<float>(bin), __fmul_rn(shift, s)), 0.0f,
      static_cast<float>(n_t - 1));
  const float lo_f = floorf(t);
  const float frac = __fsub_rn(t, lo_f);
  const float e = __fmul_rn(coh, __fadd_rn(__fmul_rn(shade, s), 1.0f));
  Entry out;
  out.lo = static_cast<int>(lo_f);
  out.hi = min(out.lo + 1, n_t - 1);
  out.v_lo = __fmul_rn(e, __fsub_rn(1.0f, frac));
  out.v_hi = __fmul_rn(e, frac);
  out.diffuse = __fsub_rn(w, coh);
  return out;
}

// A deposit as a block keeps it: its target bin and value, one 8-byte
// shared load.
struct Deposit {
  int bin;
  float v;
};

// The sources each side of an output bin whose deposits can reach it:
// |t - b| <= D = |max_shift| + (T + |max_shift|) 2^-24 (the rounding of
// b - shift s), lo > t - 1 and hi <= lo + 1, so a deposit lands within
// ceil(D) + 1 bins of its source; one more for the float32 rounding of
// D itself. The whole IR where max_shift is not finite or reaches T.
__device__ __forceinline__ int window_half_width(float max_shift, int n_t) {
  const float a = fabsf(max_shift);
  if (!(a < static_cast<float>(n_t))) return n_t;
  const float d = __fadd_rn(a, __fmul_rn(__fadd_rn(static_cast<float>(n_t),
                                                   a), 6.0e-8f));
  return min(static_cast<int>(ceilf(d)) + 2, n_t);
}

struct Ear {
  Inputs in;
  long long row;  // element (l, 0, k) of the [L, T, K] channels
  int n_k, n_t;
  float facing, shift, shade;

  __device__ __forceinline__ Entry at(int b) const {
    return source_entry(in, row + static_cast<long long>(b) * n_k, b,
                        facing, shift, shade, n_t);
  }
};

// One pass of an output bin t's sum: the deposits (lo ones, or with
// `hi` the hi ones) of the sources first .. last whose target is t, in
// ascending source order, onto acc: those in the block's shared range
// [s0, s1) from shared memory, the others (a window past the halo)
// computed from global memory.
__device__ __forceinline__ float gather(float acc, int t, int first,
                                        int last, int s0, int s1,
                                        const Deposit* sh, bool hi,
                                        const Ear& ear) {
  // (no unrolling: a runtime-unrolled shared loop summed some deposits
  // of its first iterations twice where a global segment came before it)
#pragma unroll 1
  for (int b = first; b <= min(last, s0 - 1); ++b) {
    const Entry e = ear.at(b);
    if ((hi ? e.hi : e.lo) == t) acc = __fadd_rn(acc, hi ? e.v_hi : e.v_lo);
  }
  const int z = min(last, s1 - 1);
#pragma unroll 1
  for (int b = max(first, s0); b <= z; ++b) {
    const Deposit d = sh[b - s0];
    if (d.bin == t) acc = __fadd_rn(acc, d.v);
  }
#pragma unroll 1
  for (int b = max(first, s1); b <= last; ++b) {
    const Entry e = ear.at(b);
    if ((hi ? e.hi : e.lo) == t) acc = __fadd_rn(acc, hi ? e.v_hi : e.v_lo);
  }
  return acc;
}

__global__ void __launch_bounds__(kDecodeTile) binaural_decode_kernel(
    Inputs in, int n_l, int n_t, int n_k, const float* __restrict__ facing_p,
    float facing_h, const void* speed, int speed_f64, double head_radius,
    double sample_rate, float max_shift_h, float shadow,
    const float* __restrict__ sign_l, const float* __restrict__ sign_r,
    int halo, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int span = kDecodeTile + 2 * halo;
  Deposit* sh_lo = reinterpret_cast<Deposit*>(smem);
  Deposit* sh_hi = sh_lo + span;
  float* sh_diffuse = reinterpret_cast<float*>(sh_hi + span);

  const int n_tiles = (n_t + kDecodeTile - 1) / kDecodeTile;
  const int tile = blockIdx.x % n_tiles;
  const int lk = blockIdx.x / n_tiles;
  const int l = lk / n_k, k = lk % n_k;
  const int side = blockIdx.y;  // 0 left (sign +1), 1 right (sign -1)

  // max_shift as the chain has it: (r / c) * sample_rate in float32 ops
  // on a float32 speed of sound, in double and rounded once on a float64
  // one; the host's float32 value of the Python or host-tensor formula
  float max_shift = max_shift_h;
  if (speed != nullptr) {
    if (speed_f64) {
      const double c = *static_cast<const double*>(speed);
      max_shift = __double2float_rn(
          __dmul_rn(__ddiv_rn(head_radius, c), sample_rate));
    } else {
      const float c = *static_cast<const float*>(speed);
      max_shift = __fmul_rn(__fdiv_rn(__double2float_rn(head_radius), c),
                            __double2float_rn(sample_rate));
    }
  }
  Ear ear;
  ear.in = in;
  ear.row = static_cast<long long>(l) * n_t * n_k + k;
  ear.n_k = n_k;
  ear.n_t = n_t;
  ear.facing = facing_p != nullptr ? *facing_p : facing_h;
  ear.shift = side == 0 ? max_shift : -max_shift;
  ear.shade = side == 0 ? shadow : -shadow;

  // the shared range: the tile and as much of its window as the halo
  // holds
  const int h = window_half_width(max_shift, n_t);
  const int t0 = tile * kDecodeTile;
  const int s0 = max(0, t0 - min(h, halo));
  const int s1 = min(n_t, t0 + kDecodeTile + min(h, halo));
  for (int b = s0 + threadIdx.x; b < s1; b += kDecodeTile) {
    const Entry e = ear.at(b);
    sh_lo[b - s0] = Deposit{e.lo, e.v_lo};
    sh_hi[b - s0] = Deposit{e.hi, e.v_hi};
    if (b >= t0 && b < t0 + kDecodeTile) sh_diffuse[b - t0] = e.diffuse;
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= n_t) return;
  const int first = max(0, t - h), last = min(n_t - 1, t + h);
  float acc = gather(0.0f, t, first, last, s0, s1, sh_lo, false, ear);
  acc = gather(acc, t, first, last, s0, s1, sh_hi, true, ear);

  const float diffuse = sh_diffuse[threadIdx.x];
  const float* sign = side == 0 ? sign_l : sign_r;
  const float rest = sign != nullptr ? __fmul_rn(diffuse, sign[t]) : diffuse;
  out[static_cast<long long>(side) * n_l * n_t * n_k + ear.row +
      static_cast<long long>(t) * n_k] = __fadd_rn(acc, rest);
}

}  // namespace

extern "C" {

// The two-ear decode (see the top of this file) of the channels w, x, y
// [L, T, K] f32 (contiguous; with capture != 0, x and y are the C0 and
// C90 rows of a [3L, T, K] capture and W is subtracted from them) into
// out [2L, T, K] f32, left ear first. facing: the device f32 at facing_p,
// else facing_h. max_shift: from the device speed of sound at `speed` (f32,
// or f64 with speed_f64), head_radius and sample_rate, else max_shift_h.
// sign_l / sign_r: each ear's [T] decorrelation signs, both null for
// none. halo: the shared source bins each side of a tile, 0 ..
// kMaxSharedHalo. One launch on `stream`, no host sync. Returns a
// cudaError_t code (0 = launched).
int art_binaural_decode(const float* w, const float* x, const float* y,
                        int capture, int n_l, int n_t, int n_k,
                        const float* facing_p, float facing_h,
                        const void* speed, int speed_f64, double head_radius,
                        double sample_rate, float max_shift_h, float shadow,
                        const float* sign_l, const float* sign_r, int halo,
                        float* out, void* stream) {
  const long long n_tiles = (n_t + kDecodeTile - 1) / kDecodeTile;
  if (n_l < 1 || n_t < 1 || n_t > kMaxBins || n_k < 1 || halo < 0 ||
      halo > kMaxSharedHalo || (sign_l == nullptr) != (sign_r == nullptr) ||
      n_tiles * n_l * n_k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{w, x, y, capture != 0};
  const dim3 grid(static_cast<unsigned>(n_tiles * n_l * n_k), 2);
  const size_t smem = 16u * static_cast<size_t>(kDecodeTile + 2 * halo) +
                      4u * kDecodeTile;
  binaural_decode_kernel<<<grid, kDecodeTile, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      in, n_l, n_t, n_k, facing_p, facing_h, speed, speed_f64, head_radius,
      sample_rate, max_shift_h, shadow, sign_l, sign_r, halo, out);
  return static_cast<int>(cudaGetLastError());
}

// The registers and local (stack) bytes per thread of
// binaural_decode_kernel into out[2] (cudaFuncGetAttributes). Returns a
// cudaError_t code.
int art_binaural_decode_attributes(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, binaural_decode_kernel);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
