// Per-arrival Doppler's taps in two launches: the binaural ear-tap table
// and the tap synthesis of streaming.py (the art.arrival.taps span).
//
// It replaces no TPU kernel: the JAX package's taps are jnp, which XLA
// fuses into the jitted chunk step. It was added because on the card the
// plain chain is some 229 PyTorch launches a headphone chunk: the history
// window (_device_window), the mutual-nearest match (_match_arrivals),
// four ear-field sets (_ear_fields: two ears x this chunk's table and the
// previous one), the torch.where / cat assembly of the tap rows, the input
// gate and the gather form of _tap_chunk, whose [2, 24, 3, 1, 4,800]
// delay, gain and index tensors make some 40 launches of their own. Each
// launch costs the card about 2 us whatever it does; the work is small.
//
// ear_taps_kernel (one block) computes the table the chain assembles,
// with the chain's float32 operations in its order, each rounded on its
// own (explicit _rn intrinsics; the library builds with --fmad=false;
// the same libdevice sqrtf / atan2f / sinf as PyTorch's CUDA kernels
// call), so its rows equal the card's chain bit for bit:
//   match: d = |f32(idx_c[a]) - f32(idx_p[b])|; j[a] the valid previous
//     tap of least d, ties to the lower index (argmin); mutual[a] when
//     this tap is j[a]'s nearest valid current tap (ties lower), d <=
//     match_bins and this tap is valid; vanished[b] = valid_p[b] and no
//     mutual a has j[a] == b;
//   ear fields of a window bin (table t, tap a, bin d, band k; sign +1
//     left, -1 right): x, y, w = x3, y3, g3 at it,
//     coh = min(sqrt(x x + y y), w), dif = w - coh,
//     s = sin(atan2(y, x) - facing), raw = idx[a] + d - 1,
//     tau_coh = clamp(f32(raw) - (sign max_shift) s, 0, T - 1),
//     g_coh = coh ((sign shadow) s + 1),
//     tau_dif = clamp(f32(raw), 0, T - 1),
//     g_dif = dif * ear_sign[clamp(raw, 0, T - 1)] (dif without signs);
//   rows of ear e (left first), listener l, [2L, 4A, 3, K]: current
//     coherent, current diffuse (tau0 / g0 from the previous tap j[a] at
//     the previous facing where mutual, else tau1 and 0; tau1 / g1 this
//     chunk's), then the vanished taps' fade-outs, coherent and diffuse
//     (tau0 = tau1 and g0 from the previous table, g1 = 0); valid: the
//     current taps' flags twice, then vanished twice.
// Its threads stride over the taps for the match, over the previous taps
// for the vanished flags, then over the rows' elements; the match's
// outputs, written to device memory, are read back after __syncthreads.
//
// tap_synthesis_kernel: a block holds kSynthSamples output samples of one
// row group (an ear) and kSynthSplit threads each, which share its rows:
// thread i takes rows i, i + kSynthSplit, ..., and sums, from 0, in row
// order over its valid ones, each row's 3 bins, each band, g(s) *
// lerp(dry, p(s)) with the chain's float32 operations:
//   r = s * f32(1 / n), tau = tau0 + (tau1 - tau0) r, g = g0 + (g1 - g0) r,
//   p = ((Wd - n) + s) - tau, lo = floor(p), frac = p - lo,
//   lo_i = clamp(lo, 0, Wd - 1), hi_i = clamp(lo_i + 1, 0, Wd - 1),
//   y = dry[lo_i] (1 - frac) + dry[hi_i] frac, 0 unless 0 <= p <= Wd - 1,
//   term = g y.
// A scalar delay (tau [L, R]) takes bin d's delay as tau + (d - 1), as
// the chain's promotion does. The dry reads apply _device_window's rule to
// the mono clip (positions before `prefix` or from `cut` on, or outside a
// clip that does not loop, are 0; a looping one wraps) and then
// cv.gate_input's (|v| <= eps is 0), so no window tensor is built; a
// [K, Wd] band split is read as it is (start 0, the whole row, no gate).
// Then the sample's kSynthSplit partial sums are added in thread order.
// The chain sums its [L, R, 3, K, n] terms in torch's reduction order,
// this kernel in that fixed order of its own: the taps agree within the
// rounding of the sum, and a rerun gives the same bits. The split puts
// eight times the warps of one thread a sample on the card (2,400 at the
// headphone chunk's 9,600 samples), which hides the reads' latency.
//
// Bound: the synthesis's FP32 operations, about 15 a tap term (691,200
// terms a headphone chunk, 0.15 us at 67 TFLOP/s) or its bytes (the
// window once, the output, the rows), whichever is larger; both are far
// below a launch's fixed cost, which is what the two launches save.
// Reads of the window go through the read-only cache: the 42 KB window of
// the headphone cell stays in each SM's L1.

#include <cuda_runtime.h>

namespace {

constexpr int kTableThreads = 256;
// tap_synthesis_kernel: a block's output samples (a warp's lanes) and the
// row groups that share them (row a goes to group a % kSynthSplit)
constexpr int kSynthSamples = 32;
constexpr int kSynthSplit = 8;
constexpr int kSynthThreads = kSynthSamples * kSynthSplit;

// PyTorch's minimum: NaN where either is NaN, the first one
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// PyTorch's clamp(v, lo, hi) with scalar limits: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// One tap table ([L, A] bins and flags, [L, A, 3, K] W/X/Y windows).
struct Table {
  const long long* __restrict__ idx;
  const unsigned char* __restrict__ val;
  const float* __restrict__ g3;
  const float* __restrict__ x3;
  const float* __restrict__ y3;
};

struct Fields {
  float tau_coh, g_coh, tau_dif, g_dif;
};

struct Head {
  int n_a, n_k, n_t;
  float shift;  // sign * max_shift
  float shade;  // sign * shadow
  const float* __restrict__ sign;  // the ear's [T] signs, or null
};

// The ear fields of window bin (l, a, d, k) of table t at `facing`.
__device__ __forceinline__ Fields ear_fields(const Table& t, const Head& h,
                                             int l, int a, int d, int k,
                                             float facing) {
  const long long la = static_cast<long long>(l) * h.n_a + a;
  const long long i = (la * 3 + d) * h.n_k + k;
  const float x = t.x3[i], y = t.y3[i], w = t.g3[i];
  const float coh =
      min_nan(__fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y))), w);
  const float dif = __fsub_rn(w, coh);
  const float s = sinf(__fsub_rn(atan2f(y, x), facing));
  const long long raw = t.idx[la] + (d - 1);
  const float bin = __ll2float_rn(raw);
  const float top = static_cast<float>(h.n_t - 1);
  Fields f;
  f.tau_coh = clamp_nan(__fsub_rn(bin, __fmul_rn(h.shift, s)), 0.0f, top);
  f.g_coh = __fmul_rn(coh, __fadd_rn(__fmul_rn(h.shade, s), 1.0f));
  f.tau_dif = clamp_nan(bin, 0.0f, top);
  if (h.sign != nullptr) {
    const long long b = raw < 0 ? 0 : (raw > h.n_t - 1 ? h.n_t - 1 : raw);
    f.g_dif = __fmul_rn(dif, h.sign[b]);
  } else {
    f.g_dif = dif;
  }
  return f;
}

__device__ __forceinline__ float load_f32(const float* p, float host) {
  return p != nullptr ? *p : host;
}

__global__ void __launch_bounds__(kTableThreads) ear_taps_kernel(
    Table cur, Table prev, int n_l, int n_a, int n_k, int n_t,
    const float* __restrict__ facing_p, float facing_h,
    const float* __restrict__ prev_facing_p, float prev_facing_h,
    const void* speed, int speed_f64, double head_radius,
    double sample_rate, float max_shift_h, float shadow,
    const float* __restrict__ sign_l, const float* __restrict__ sign_r,
    float match_bins, float* __restrict__ rows, unsigned char* flags,
    long long* j_out) {
  const int n_la = n_l * n_a;
  const int n_rows = 4 * n_a;
  unsigned char* valid = flags;                          // [2L, 4A]
  unsigned char* mutual = flags + 2 * n_l * n_rows;      // [L, A]
  unsigned char* vanished = mutual + n_la;               // [L, A]

  // 1. the match: this chunk's taps to the previous chunk's
  for (int t = threadIdx.x; t < n_la; t += kTableThreads) {
    const int l = t / n_a, a = t % n_a;
    const long long* ic = cur.idx + static_cast<long long>(l) * n_a;
    const long long* ip = prev.idx + static_cast<long long>(l) * n_a;
    const unsigned char* vc = cur.val + static_cast<long long>(l) * n_a;
    const unsigned char* vp = prev.val + static_cast<long long>(l) * n_a;
    const float tc = __ll2float_rn(ic[a]);
    float best = INFINITY;
    int j = 0;
    for (int b = 0; b < n_a; ++b) {
      const float d = vp[b] ? fabsf(__fsub_rn(tc, __ll2float_rn(ip[b])))
                            : INFINITY;
      if (d < best) {
        best = d;
        j = b;
      }
    }
    const float tp = __ll2float_rn(ip[j]);
    float back = INFINITY;
    int i_back = 0;
    for (int c = 0; c < n_a; ++c) {
      const float d = vc[c] ? fabsf(__fsub_rn(__ll2float_rn(ic[c]), tp))
                            : INFINITY;
      if (d < back) {
        back = d;
        i_back = c;
      }
    }
    j_out[t] = j;
    mutual[t] = (i_back == a) && (best <= match_bins) && vc[a];
  }
  __syncthreads();

  // 2. the previous taps no mutual current tap took
  for (int t = threadIdx.x; t < n_la; t += kTableThreads) {
    const int l = t / n_a, b = t % n_a;
    bool matched = false;
    for (int a = 0; a < n_a; ++a) {
      const int u = l * n_a + a;
      matched = matched || (mutual[u] && j_out[u] == b);
    }
    vanished[t] = prev.val[t] && !matched;
  }
  __syncthreads();

  // 3. the rows, ear-major: [2L, 4A, 3, K] each of tau0, tau1, g0, g1
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
  const float facing = load_f32(facing_p, facing_h);
  const float prev_facing = load_f32(prev_facing_p, prev_facing_h);
  const long long plane = 2LL * n_l * n_rows * 3 * n_k;
  const int per_row = 3 * n_k;
  for (long long e = threadIdx.x; e < plane; e += kTableThreads) {
    const int dk = static_cast<int>(e % per_row);
    const long long er = e / per_row;          // (ear, l, row)
    const int row = static_cast<int>(er % n_rows);
    const int el = static_cast<int>(er / n_rows);
    const int ear = el / n_l, l = el % n_l;
    const int d = dk / n_k, k = dk % n_k;
    const int part = row / n_a, a = row % n_a;
    const int u = l * n_a + a;
    Head h;
    h.n_a = n_a;
    h.n_k = n_k;
    h.n_t = n_t;
    h.shift = ear == 0 ? max_shift : -max_shift;
    h.shade = ear == 0 ? shadow : -shadow;
    h.sign = ear == 0 ? sign_l : sign_r;
    float tau0, tau1, g0, g1;
    if (part < 2) {                            // this chunk's taps
      const Fields c = ear_fields(cur, h, l, a, d, k, facing);
      const bool mu = mutual[u];
      Fields p;
      if (mu) p = ear_fields(prev, h, l, static_cast<int>(j_out[u]), d, k,
                             prev_facing);
      if (part == 0) {
        tau1 = c.tau_coh;
        g1 = c.g_coh;
        tau0 = mu ? p.tau_coh : c.tau_coh;
        g0 = mu ? p.g_coh : 0.0f;
      } else {
        tau1 = c.tau_dif;
        g1 = c.g_dif;
        tau0 = mu ? p.tau_dif : c.tau_dif;
        g0 = mu ? p.g_dif : 0.0f;
      }
    } else {                                   // the fade-outs
      const Fields p = ear_fields(prev, h, l, a, d, k, prev_facing);
      tau0 = tau1 = part == 2 ? p.tau_coh : p.tau_dif;
      g0 = part == 2 ? p.g_coh : p.g_dif;
      g1 = 0.0f;
    }
    rows[e] = tau0;
    rows[plane + e] = tau1;
    rows[2 * plane + e] = g0;
    rows[3 * plane + e] = g1;
    if (dk == 0) valid[er] = part < 2 ? cur.val[u] : vanished[u];
  }
}

// The dry source of the synthesis: row kb of `dry` ([rows, total]),
// window position j of `wd`, under _device_window's rule and, with
// `gate`, cv.gate_input's.
struct Dry {
  const float* __restrict__ src;
  long long total, start;
  int wd, prefix, cut, n_rows;
  bool loop, gate;
  float eps;

  __device__ __forceinline__ float at(int kb, int j) const {
    long long g = j + start;
    bool ok = j >= prefix && j < cut;
    if (loop) {
      if (g >= total) g %= total;
    } else {
      ok = ok && g >= 0 && g < total;
      g = g < 0 ? 0 : (g > total - 1 ? total - 1 : g);
    }
    const float v = ok ? __ldg(src + kb * total + g) : 0.0f;
    return (gate && !(fabsf(v) > eps)) ? 0.0f : v;
  }
};

// Tap rows [L, R, ...]: delays [L, R] (scalar, bin d at tau + d - 1) or
// [L, R, 3, Kt]; gains [L, R, 3, Kg]; a band index of 0 where Kt or Kg is
// 1 (the chain's broadcast).
struct Rows {
  const float* __restrict__ tau0;
  const float* __restrict__ tau1;
  const float* __restrict__ g0;
  const float* __restrict__ g1;
  const unsigned char* __restrict__ valid;
  int n_r, n_kt, n_kg;
  bool tau_scalar;
};

__global__ void __launch_bounds__(kSynthThreads) tap_synthesis_kernel(
    Dry dry, Rows rows, int n_k, int n, float inv_n,
    float* __restrict__ out) {
  __shared__ float part[kSynthSplit][kSynthSamples];
  const int lane = threadIdx.x % kSynthSamples;
  const int group = threadIdx.x / kSynthSamples;
  const int s = blockIdx.x * kSynthSamples + lane;
  const int l = blockIdx.y;
  const float s_f = static_cast<float>(s);
  const float r = __fmul_rn(s_f, inv_n);
  const float base = __fadd_rn(s_f, static_cast<float>(dry.wd - n));
  const float top = static_cast<float>(dry.wd - 1);
  float acc = 0.0f;
  for (int a = group; a < rows.n_r && s < n; a += kSynthSplit) {
    const long long la = static_cast<long long>(l) * rows.n_r + a;
    if (!rows.valid[la]) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float off = static_cast<float>(d - 1);
      for (int k = 0; k < n_k; ++k) {
        float t0, t1;
        if (rows.tau_scalar) {
          t0 = __fadd_rn(rows.tau0[la], off);
          t1 = __fadd_rn(rows.tau1[la], off);
        } else {
          const long long ti = (la * 3 + d) * rows.n_kt
                               + (rows.n_kt == 1 ? 0 : k);
          t0 = rows.tau0[ti];
          t1 = rows.tau1[ti];
        }
        const long long gi = (la * 3 + d) * rows.n_kg
                             + (rows.n_kg == 1 ? 0 : k);
        const float g0 = rows.g0[gi], g1 = rows.g1[gi];
        const float tau = __fadd_rn(t0, __fmul_rn(__fsub_rn(t1, t0), r));
        const float g = __fadd_rn(g0, __fmul_rn(__fsub_rn(g1, g0), r));
        const float p = __fsub_rn(base, tau);
        const float lo = floorf(p);
        const float frac = __fsub_rn(p, lo);
        // lo as an index, clamped (NaN to 0, as the read is masked off)
        const int lo_i = lo >= 0.0f ? (lo < top ? static_cast<int>(lo)
                                                : dry.wd - 1)
                                    : 0;
        const int hi_i = min(lo_i + 1, dry.wd - 1);
        const int kb = dry.n_rows == 1 ? 0 : k;
        float y = __fadd_rn(__fmul_rn(dry.at(kb, lo_i), __fsub_rn(1.0f,
                                                                  frac)),
                            __fmul_rn(dry.at(kb, hi_i), frac));
        if (!(p >= 0.0f && p <= top)) y = 0.0f;
        acc = __fadd_rn(acc, __fmul_rn(g, y));
      }
    }
  }
  part[group][lane] = acc;
  __syncthreads();
  if (group == 0 && s < n) {
    float sum = part[0][lane];
#pragma unroll
    for (int i = 1; i < kSynthSplit; ++i) sum = __fadd_rn(sum, part[i][lane]);
    out[static_cast<long long>(l) * n + s] = sum;
  }
}

}  // namespace

extern "C" {

// The binaural ear-tap table (see the top of this file) of this chunk's
// table (idx_c [L, A] i64, val_c [L, A] u8, g3_c / x3_c / y3_c [L, A, 3, K]
// f32, all contiguous) and the previous chunk's (the same shapes). facing
// and prev_facing: the device f32 at *_p, else the host value. max_shift:
// from the device speed of sound at `speed` (f32, or f64 with speed_f64),
// head_radius and sample_rate, else max_shift_h. sign_l / sign_r: each
// ear's [T] decorrelation signs, both null for none. Writes rows [4, 2L,
// 4A, 3, K] f32 (tau0, tau1, g0, g1), flags [2L * 4A + 2 L A] u8 (valid
// [2L, 4A], mutual [L, A], vanished [L, A]) and j [L, A] i64. One block,
// one launch on `stream`, no host sync. Returns a cudaError_t code (0 =
// launched).
int art_ear_taps(const long long* idx_c, const unsigned char* val_c,
                 const float* g3_c, const float* x3_c, const float* y3_c,
                 const long long* idx_p, const unsigned char* val_p,
                 const float* g3_p, const float* x3_p, const float* y3_p,
                 int n_l, int n_a, int n_k, int n_t, const float* facing_p,
                 float facing_h, const float* prev_facing_p,
                 float prev_facing_h, const void* speed, int speed_f64,
                 double head_radius, double sample_rate, float max_shift_h,
                 float shadow, const float* sign_l, const float* sign_r,
                 float match_bins, float* rows, unsigned char* flags,
                 long long* j, void* stream) {
  if (n_l < 1 || n_a < 1 || n_k < 1 || n_t < 1 ||
      (sign_l == nullptr) != (sign_r == nullptr) ||
      2LL * n_l * 4 * n_a * 3 * n_k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Table cur{idx_c, val_c, g3_c, x3_c, y3_c};
  const Table prev{idx_p, val_p, g3_p, x3_p, y3_p};
  ear_taps_kernel<<<1, kTableThreads, 0, static_cast<cudaStream_t>(
                                             stream)>>>(
      cur, prev, n_l, n_a, n_k, n_t, facing_p, facing_h, prev_facing_p,
      prev_facing_h, speed, speed_f64, head_radius, sample_rate,
      max_shift_h, shadow, sign_l, sign_r, match_bins, rows, flags, j);
  return static_cast<int>(cudaGetLastError());
}

// The taps [L, n] f32 of the tap rows (see the top of this file): tau0 /
// tau1 [L, R] (tau_scalar) or [L, R, 3, n_kt], g0 / g1 [L, R, 3, n_kg],
// valid [L, R] u8; the dry source `dry` [n_dry_rows, total] f32 read at
// window positions 0 .. wd - 1 from `start` (prefix / cut / loop:
// _device_window's rule; gate: cv.gate_input's at eps). n_k: the bands
// summed (each of n_kt, n_kg, n_dry_rows is 1 or n_k). inv_n: f32(1 / n).
// One launch on `stream`, no host sync. Returns a cudaError_t code (0 =
// launched).
int art_tap_synthesis(const float* dry, int n_dry_rows, long long total,
                      int wd, long long start, int prefix, int cut, int loop,
                      int gate, float eps, const float* tau0,
                      const float* tau1, int tau_scalar, int n_kt,
                      const float* g0, const float* g1, int n_kg,
                      const unsigned char* valid, int n_l, int n_r, int n_k,
                      int n, float inv_n, float* out, void* stream) {
  if (n_l < 1 || n_l > 65535 || n_r < 0 || n_k < 1 || n < 1 || wd < 1 ||
      total < 1 || n_dry_rows < 1 || (loop && start < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Dry src;
  src.src = dry;
  src.total = total;
  src.start = start;
  src.wd = wd;
  src.prefix = prefix;
  src.cut = cut;
  src.n_rows = n_dry_rows;
  src.loop = loop != 0;
  src.gate = gate != 0;
  src.eps = eps;
  Rows r;
  r.tau0 = tau0;
  r.tau1 = tau1;
  r.g0 = g0;
  r.g1 = g1;
  r.valid = valid;
  r.n_r = n_r;
  r.n_kt = n_kt;
  r.n_kg = n_kg;
  r.tau_scalar = tau_scalar != 0;
  const dim3 grid((n + kSynthSamples - 1) / kSynthSamples, n_l);
  tap_synthesis_kernel<<<grid, kSynthThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      src, r, n_k, n, inv_n, out);
  return static_cast<int>(cudaGetLastError());
}

// The registers and local (stack) bytes per thread of ear_taps_kernel
// (which 0) or tap_synthesis_kernel (which 1) into out[2]
// (cudaFuncGetAttributes). Returns a cudaError_t code.
int art_arrival_taps_attributes(int which, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&attr, ear_taps_kernel)
                 : cudaFuncGetAttributes(&attr, tap_synthesis_kernel);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

}  // extern "C"
