// Ray physics shared by the bounce kernels (bounce_kernel.cu: K3, K4, K9,
// K6 as K3/K4 at one frame, and K5's hit rows), the cluster kernels
// (accel_kernel.cu: K7, K8) and the wall sweeps (trace_kernel.cu: K1, K2).
//
// What is here: the constants of the reference kernel, Philox-4x32-10 and
// its 24-bit uniforms, the ray-segment test (filter + wall_exact) and
// the two scans built on it (scan_nearest, scan_blocker), the emission of
// a ray, the fixed-point IR deposit, the u64 -> f32 conversion kernel, and
// the whole bounce after the nearest-wall search (finish_bounce): direct
// listener capture, advance, NEE with occlusion, absorption and cutoff,
// transmission with refraction, and the specular/diffuse reflection.
// The kernels differ only in how they find the nearest wall and run the
// occlusion sweep (a full scan of a shared-memory table, or a two-level
// box early-out over a global one), where their random numbers come from,
// where a ray's state lives between bounces (registers, or the cluster
// kernels' buffers between their launches), and where a hit goes: into
// the fixed-point IR (Sink) or, as a raw record, into hit rows (RowSink).
//
// Directive sources and microphones (ops/directivity.py) are one template
// flag, kDirective, of emit_ray and finish_bounce, as kHostUniforms is one
// of the bounce kernel: the omni instantiations compile to the code they
// had before it. A directive kernel weights a ray's energy at emission by
// the source pattern at its direction, and each hit by the listener's
// microphone pattern at the direction the sound arrives from (-d at
// direct capture, bounce point - listener at NEE, after the NEE cutoff,
// which tests the path and not the pickup). The series is evaluated from
// the direction's cosine and sine by the angle-addition recurrence of
// fourier_gain, the operations of ops/directivity.py::fourier_gain in its
// order; the kernels stage the coefficients in shared memory.
//
// The semantics are those of the plain oracle ops/trace.py::_bounce +
// ops/ir.py::scatter_hits, in its IEEE operation order: '/', sqrtf,
// sincosf, asinf, no fast math, and the build passes --fmad=false, so a
// hit here is the plain path's hit. The wrappers hand over a wall table as
// struct-of-arrays rows [rows, stride] (see WallField; banded tables
// append the absorption of bands 1 .. K-1 as rows 11 .. 9 + K); a kernel
// reads it as a WallTable: the four geometry rows of a wall as one float4
// (16-byte load), cc beside it, the attribute rows as they are. An IR
// accumulator is u64 [L, T, K] fixed point: each hit adds llrint(e * S),
// and integer addition is associative, so the IR of a seed is
// bit-identical whatever order the atomics land in.
//
// Bands. A ray carries K energies; the physics is the same for every band
// but the wall absorption (keep = 1 - absorption of the hit wall's band
// k), and the NEE and energy cutoffs look at the loudest band. The
// energies of a ray live in registers (Ray<kMaxK>, kMaxK one of the
// buckets the kernels instantiate, of which n_bands are used) or, past the
// largest bucket, in a device scratch (Ray<kWideK>: WideBands, band k of
// the thread at scratch[k * stride + thread], coalesced), for any K. The
// absorption of bands k >= 1 is read once per bounce, for the hit wall
// only, from the global rows the wrapper passes (WallTable::band_rows), so
// a shared-memory table holds six attribute rows at any K. Both forms make
// the same IEEE operations per band in the same order, so a bucket and the
// scratch give the same bits.
//
// Design of the wall test. The exact test costs two IEEE divides, each a
// sequence of a dozen or more instructions around a reciprocal, and a
// ray's line crosses the extent of only a few walls of a scene. So a scan
// first runs a division-free filter over up to 32 walls (wall_straddles):
// the numerator n2 and the denominator dotp of the exact test, in its
// operation order, compared by sign and magnitude with a one-sided
// relative slack of 1e-6, so that it rejects only walls the exact test
// would reject too. The survivors' bits form a mask, and a lane loops over
// its own set bits, lowest index first: a second division-free step
// (wall_in_reach: the numerator n1 against the caller's bound, the running
// closest hit or the occlusion limit) and then the exact test with its two
// divides (wall_exact, the operation order of geometry.py::
// pairwise_ray_segment_t). A warp's lanes then loop over their own few
// survivors instead of dragging each other through the divides of every
// wall, and the bits a kept hit is made of do not move. ops/geometry.py::
// ray_segment_maybe mirrors the two steps for the CPU tests.
//
// What bounds it: instruction rate. Step 1 costs ~18 instructions per
// wall against the 13 FP32 operations the bound counts, a survivor ~15
// more and ~40 for its divides, a warp runs as many survivor rounds as its
// busiest lane needs, and with --fmad=false no multiply-add is contracted,
// so this arithmetic can reach at most half of the card's 67 TFLOP/s.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-4f;
constexpr float kInf = 1e8f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265);
constexpr float kEnergyCutoff = 1e-3f;
constexpr float kNeeCutoff = 1e-5f;
constexpr float kOcclusionSlack = 0.1f;
constexpr int kWallFields = 11;
constexpr int kScalFields = 5;
// kMaxK of the instantiation that keeps a ray's energies in a device
// scratch instead of registers (any K).
constexpr int kWideK = 0;

// Rows of the wrappers' wall table, and of its attribute part alone.
enum WallField { AX, AY, V2X, V2Y, CC, NX, NY, ABS, SCAT, TRANS, IOR };
enum WallAttr { A_NX, A_NY, A_ABS, A_SCAT, A_TRANS, A_IOR };

// A wall table as the kernels read it: geo[i] = (ax, ay, v2x, v2y) and
// cc[i] of wall i, the attribute rows attr[row * n + i] (WallAttr), and
// the absorption of band k >= 1 at band_rows[(5 + k) * n + i]. In shared
// memory the first three parts are packed by load_wall_table (44 B per
// wall) and band_rows points at the attribute rows of the wrapper's
// global table; the cluster kernels read a global table whose geo plane
// the wrapper built, and band_rows == attr.
struct WallTable {
  const float4* geo;
  const float* cc;
  const float* attr;
  int n;
  const float* band_rows = nullptr;
};

// What a sweep knows of its ray before it meets a wall.
struct Probe {
  float ox, oy, dx, dy;
  float cross;  // oy * dx - ox * dy
};

__device__ __forceinline__ Probe make_probe(float ox, float oy, float dx,
                                            float dy) {
  return {ox, oy, dx, dy, oy * dx - ox * dy};
}

struct Uniforms {
  float u0, u1, u2;
};

// What one ray did: wall tests, the sweeps (nearest or occlusion) they
// belong to, and box slab tests (cluster kernels only).
struct Work {
  unsigned long long tests = 0, sweeps = 0, slabs = 0;
};

// One ray between bounces; kMaxK energy bands, of which n_bands are used.
template <int kMaxK>
struct Ray {
  float px, py, dx, dy, tm, ds, sp;
  float en[kMaxK];
  int dep;
};

// Call f(std::integral_constant<int, kMaxK>) with the instantiation a
// launch of n_bands takes: the smallest register bucket that holds it (1,
// 8 and kLargest: 32 for the bounce kernel, 8 for K7, where 128 registers
// and their spills made bucket 32 slower than the scratch), or the
// scratch, kWideK (the wrappers' BAND_BUCKETS mirror it).
template <int kLargest, class F>
cudaError_t by_bucket(int n_bands, F f) {
  if (n_bands == 1) return f(std::integral_constant<int, 1>{});
  if (n_bands <= 8) return f(std::integral_constant<int, 8>{});
  if (n_bands <= kLargest) return f(std::integral_constant<int, kLargest>{});
  return f(std::integral_constant<int, kWideK>{});
}

// The energies of one ray in a device scratch: band k at p[k * stride].
struct WideBands {
  float* p;
  size_t stride;
  __device__ __forceinline__ float& operator[](int k) const {
    return p[static_cast<size_t>(k) * stride];
  }
};

// A ray whose energies live in the scratch (any number of bands).
template <>
struct Ray<kWideK> {
  float px, py, dx, dy, tm, ds, sp;
  WideBands en;
  int dep;
};

// Where hits go: the u64 accumulator [L, T, K] of one entry and its scale.
struct Sink {
  unsigned long long* acc;
  int ir_length;
  int n_bands;
  float sr;
  double scale;
};

// Where hits go instead when the caller wants the records themselves (K5):
// the rows [B, 8, R] f32 of one frame, one listener, one band; per bounce
// direct delay, energy, valid, then NEE delay, energy, valid, then two
// rows of padding. A RowSink serves one ray: `col` is the ray's column of
// the current bounce (rows + bounce * 8 * R + ray) and `stored` the slots
// (bit 0 direct, bit 1 NEE) deposited there. end_bounce stores zeros in
// the rest of the column and moves on to the next bounce, and, when the
// ray dies, stores zeros in the columns of every later bounce: each
// element of the rows is written once, and the rows of a hit that did not
// happen are zeros.
struct RowSink {
  mutable float* col;
  int n_rays;
  int n_bounces;
  mutable unsigned stored;
  static constexpr int n_bands = 1;
};
constexpr int kHitRows = 8;

// The listeners of one entry: xy [L, 2], radius^2, rest-frame speed c,
// and (directive kernels only) the microphone patterns mic [L, n_mic].
struct Listeners {
  const float* xy;
  int n;
  float r2;
  float c;
  const float* mic = nullptr;
  int n_mic = 0;
};

// The clamped Fourier power-gain series c[0] + sum_n c[2n-1] cos(n a) +
// c[2n] sin(n a) of n_c = 2M + 1 coefficients, from c1 = cos a and s1 =
// sin a by the angle-addition recurrence: ops/directivity.py::fourier_gain,
// the same operations in the same order.
__device__ __forceinline__ float fourier_gain(float c1, float s1,
                                             const float* c, int n_c) {
  float g = c[0];
  const int m = (n_c - 1) / 2;
  float cn = c1, sn = s1;
  for (int n = 1; n <= m; ++n) {
    g = g + c[2 * n - 1] * cn + c[2 * n] * sn;
    if (n < m) {
      const float cn_next = cn * c1 - sn * s1;
      sn = sn * c1 + cn * s1;
      cn = cn_next;
    }
  }
  return fmaxf(g, 0.0f);
}

// Copy `n` floats from global `src` into shared `dst`; every thread of
// the block calls it, the caller synchronises.
__device__ __forceinline__ void stage(const float* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

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

// The three uniforms of counter (ray, frame, bounce, entry); bounce = B
// gives the emission jitter in u0 (ops/rng.py::philox_uniforms).
__device__ __forceinline__ Uniforms philox_uniforms(uint32_t ray,
                                                   uint32_t frame,
                                                   uint32_t bounce,
                                                   uint32_t entry,
                                                   uint32_t key0,
                                                   uint32_t key1) {
  uint32_t ctr[4] = {ray, frame, bounce, entry};
  philox4x32_10(ctr, key0, key1);
  return {u24(ctr[0]), u24(ctr[1]), u24(ctr[2])};
}

// Ray-segment distance of one wall, the operation order of geometry.py::
// pairwise_ray_segment_t (cc = v2x * ay - v2y * ax precomputed). 16 FP32
// operations (two of them divides); oy * dx - ox * dy (3) is the same for
// every wall of a sweep, so a test costs 13 beside 3 per sweep.
__device__ __forceinline__ float wall_exact(float4 g, float cc,
                                           const Probe& q) {
  const float dotp = g.w * q.dx - g.z * q.dy;
  const bool parallel = fabsf(dotp) < kEps;
  const float safe = parallel ? 1.0f : dotp;
  const float t1 = (g.z * q.oy - g.w * q.ox - cc) / safe;
  const float t2 = (q.cross - (g.y * q.dx - g.x * q.dy)) / safe;
  return (!parallel && t1 >= kEps && t2 >= 0.0f && t2 <= 1.0f) ? t1 : kInf;
}

// The filter's slacks. A rounded quotient n / d is <= 1 up to n / d = 1 +
// 2^-24, is >= 0 down to an underflow to -0, and is >= kEps down to half
// an ulp under it; each limit below is 1e-6 (relative) or more outside
// the exact one, far more than the rounding of the products it is
// compared with (6e-8), so no wall the exact test accepts is rejected.
constexpr float kSlackHi = 1.000001f;   // t2 <= 1, t1 <= tmax
constexpr float kSlackLo = -1e-6f;      // t2 >= 0
constexpr float kEpsLo = 9.9999e-5f;    // t1 >= kEps

// The filter, in two steps that share the exact test's numerators and
// denominator (the same operations in the same order, no divide). With a =
// |dotp| and a numerator given dotp's sign (m = n * sign(dotp), so n /
// dotp = m / a exactly), t2 in [0, 1] needs m2 in [0, a] and t1 in [kEps,
// tmax] needs m1 in [kEps * a, tmax * a]. A NaN fails every comparison and
// passes on to the exact test.
//
// Step 1, for every wall: can the ray's line cross the wall's extent?
// False only if wall_exact would return kInf (parallel, or t2 outside
// [0, 1]). It needs the wall's float4 alone.
__device__ __forceinline__ bool wall_straddles(float4 g, const Probe& q) {
  const float dotp = g.w * q.dx - g.z * q.dy;
  const float n2 = q.cross - (g.y * q.dx - g.x * q.dy);
  const float a = fabsf(dotp);
  const float m2 = dotp < 0.0f ? -n2 : n2;
  const bool miss = a < kEps || m2 < a * kSlackLo || m2 > a * kSlackHi;
  return !miss;
}

// Step 2, for a wall that passed step 1, before dividing: can its distance
// lie in [kEps, tmax]? False only if wall_exact would return kInf or a
// distance above tmax. tmax_s = max(tmax, 0) * kSlackHi.
__device__ __forceinline__ bool wall_in_reach(float4 g, float cc,
                                              const Probe& q, float tmax_s) {
  const float dotp = g.w * q.dx - g.z * q.dy;
  const float n1 = g.z * q.oy - g.w * q.ox - cc;
  const float a = fabsf(dotp);
  const float m1 = dotp < 0.0f ? -n1 : n1;
  const bool miss = m1 < a * kEpsLo || m1 > a * tmax_s;
  return !miss;
}

// Bit j set: the ray's line can cross wall lo + j (j < count <= 32).
__device__ __forceinline__ unsigned wall_candidates(const WallTable& w,
                                                    int lo, int count,
                                                    const Probe& q) {
  unsigned mask = 0;
#pragma unroll 4
  for (int j = 0; j < count; ++j)
    mask |= static_cast<unsigned>(wall_straddles(w.geo[lo + j], q)) << j;
  return mask;
}

// Nearest wall among walls lo .. lo + count - 1, folded into (closest,
// best): the smallest distance, and among equal distances the lowest
// index, whatever order the ranges of a table are scanned in. A caller
// starts from (kInf, INT_MAX) and reads best only if closest < kInf.
__device__ __forceinline__ void scan_nearest(const WallTable& w, int lo,
                                             int count, const Probe& q,
                                             float& closest, int& best) {
  for (int base = lo; base < lo + count; base += 32) {
    unsigned m = wall_candidates(w, base, min(32, lo + count - base), q);
    while (m) {
      const int i = base + __ffs(m) - 1;
      m &= m - 1;
      const float4 g = w.geo[i];
      const float cc = w.cc[i];
      if (!wall_in_reach(g, cc, q, closest * kSlackHi)) continue;
      const float t = wall_exact(g, cc, q);
      if (t < closest || (t == closest && i < best)) {
        closest = t;
        best = i;
      }
    }
  }
}

// The lowest index among walls lo .. lo + count - 1 that cuts the ray
// before `limit`, or -1. A sweep that stops there has tested the walls up
// to and including it.
__device__ __forceinline__ int scan_blocker(const WallTable& w, int lo,
                                            int count, const Probe& q,
                                            float limit) {
  const float limit_s = fmaxf(limit, 0.0f) * kSlackHi;
  for (int base = lo; base < lo + count; base += 32) {
    unsigned m = wall_candidates(w, base, min(32, lo + count - base), q);
    while (m) {
      const int i = base + __ffs(m) - 1;
      m &= m - 1;
      const float4 g = w.geo[i];
      const float cc = w.cc[i];
      if (wall_in_reach(g, cc, q, limit_s) && wall_exact(g, cc, q) < limit)
        return i;
    }
  }
  return -1;
}

// Floats of a shared-memory WallTable of `count` walls (load_wall_table).
__host__ __device__ constexpr size_t wall_table_floats(size_t count,
                                                       size_t n_attr) {
  return (5 + n_attr) * count;
}

// Pack `count` walls of the wrappers' row table (rows[field * stride +
// first + i]) into shared memory at `smem` as a WallTable of stride
// `count`: geo, then cc, then the n_attr attribute rows. Every thread of
// the block calls it; the caller synchronises. smem must be 16-byte
// aligned and hold wall_table_floats(count, n_attr) floats.
__device__ __forceinline__ WallTable load_wall_table(const float* rows,
                                                     size_t stride,
                                                     int first, int count,
                                                     int n_attr,
                                                     float* smem) {
  float4* geo = reinterpret_cast<float4*>(smem);
  float* cc = smem + 4 * count;
  float* attr = cc + count;
  const float* r = rows + first;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    geo[i] = make_float4(r[AX * stride + i], r[AY * stride + i],
                         r[V2X * stride + i], r[V2Y * stride + i]);
    cc[i] = r[CC * stride + i];
  }
  for (int i = threadIdx.x; i < n_attr * count; i += blockDim.x) {
    const int row = i / count, col = i - row * count;
    attr[i] = r[(NX + row) * stride + col];
  }
  return {geo, cc, attr, count};
}

// Safe normalize (geometry.py::normalize).
__device__ __forceinline__ void normalize2(float& x, float& y) {
  const float n2 = x * x + y * y;
  const float inv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  x *= inv;
  y *= inv;
}

// Absorption of band k of wall i (attribute row A_ABS for band 0, row
// 5 + k of band_rows after).
__device__ __forceinline__ float band_absorption(const WallTable& w, int i,
                                                 int k) {
  return (k == 0 ? w.attr : w.band_rows)[(k == 0 ? A_ABS : 5 + k) * w.n + i];
}

// Add each band's energy e[k] of one hit at `delay` to listener l's bin.
// `slot` (0 direct capture, 1 NEE) matters only to the row sink. One
// atomic per hit and band: summing first among the lanes of a warp that
// hit the same bin (__match_any_sync, then an integer reduction) was
// tried and cost more than the atomics it saved (PERF.md).
template <int kMaxK>
__device__ __forceinline__ void deposit(const Sink& s, int /*slot*/, int l,
                                        float delay, const float* e) {
  const float fb = floorf(delay * s.sr);
  if (!(fb >= 0.0f && fb < static_cast<float>(s.ir_length))) return;
  unsigned long long* bin =
      s.acc + (static_cast<size_t>(l) * s.ir_length + static_cast<int>(fb)) *
                  s.n_bands;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= s.n_bands) break;
    const unsigned long long q = static_cast<unsigned long long>(
        llrint(static_cast<double>(e[k]) * s.scale));
    if (q) atomicAdd(bin + k, q);
  }
}

// deposit for a ray whose energies live in the scratch: band(k) gives band
// k's energy of the hit, computed as the register form computes e[k].
template <class Band>
__device__ __forceinline__ void deposit_bands(const Sink& s, int l,
                                              float delay, Band band) {
  const float fb = floorf(delay * s.sr);
  if (!(fb >= 0.0f && fb < static_cast<float>(s.ir_length))) return;
  unsigned long long* bin =
      s.acc + (static_cast<size_t>(l) * s.ir_length + static_cast<int>(fb)) *
                  s.n_bands;
  for (int k = 0; k < s.n_bands; ++k) {
    const unsigned long long q = static_cast<unsigned long long>(
        llrint(static_cast<double>(band(k)) * s.scale));
    if (q) atomicAdd(bin + k, q);
  }
}

// Store one hit as a record: rows 3 * slot .. 3 * slot + 2 of the ray's
// column of this bounce (one listener, band 0).
template <int kMaxK>
__device__ __forceinline__ void deposit(const RowSink& s, int slot, int /*l*/,
                                        float delay, const float* e) {
  float* col = s.col + static_cast<size_t>(3 * slot) * s.n_rays;
  col[0] = delay;
  col[s.n_rays] = e[0];
  col[2 * static_cast<size_t>(s.n_rays)] = 1.0f;
  s.stored |= 1u << slot;
}

// The end of a ray's bounce `bounce`, after which it lives on (alive) or
// is dead: the IR sink has nothing to do.
__device__ __forceinline__ void end_bounce(const Sink&, int, bool) {}

// The row sink completes the bounce's column (zeros where no hit was
// stored, and the padding) and moves on; a ray that died leaves zeros in
// the columns of the bounces it does not reach.
__device__ __forceinline__ void end_bounce(const RowSink& s, int bounce,
                                           bool alive) {
  const size_t n = s.n_rays;
#pragma unroll
  for (int row = 0; row < 6; ++row)
    if (!(s.stored >> (row / 3) & 1u)) s.col[row * n] = 0.0f;
  s.col[6 * n] = 0.0f;
  s.col[7 * n] = 0.0f;
  s.col += kHitRows * n;
  s.stored = 0;
  if (alive) return;
  for (int b = bounce + 1; b < s.n_bounces; ++b, s.col += kHitRows * n) {
#pragma unroll
    for (int row = 0; row < kHitRows; ++row) s.col[row * n] = 0.0f;
  }
}

// The sink of a lane group (bounce_kernel.cu, kLanes > 1) around a Sink or
// a RowSink: the lanes of a group carry the same ray and make the same
// hits; only the group's lead lane deposits them and stores its rows.
template <class S>
struct GroupSink : S {
  bool lead;
};

template <int kMaxK, class S>
__device__ __forceinline__ void deposit(const GroupSink<S>& s, int slot,
                                        int l, float delay, const float* e) {
  if (s.lead) deposit<kMaxK>(static_cast<const S&>(s), slot, l, delay, e);
}

template <class S, class Band>
__device__ __forceinline__ void deposit_bands(const GroupSink<S>& s, int l,
                                              float delay, Band band) {
  if (s.lead) deposit_bands(static_cast<const S&>(s), l, delay, band);
}

template <class S>
__device__ __forceinline__ void end_bounce(const GroupSink<S>& s, int bounce,
                                           bool alive) {
  if (s.lead) end_bounce(static_cast<const S&>(s), bounce, alive);
}

// Lanes per ray of a launch too small to fill the card (K3/K4/K9, K5 and
// the brute wall sweep; the wrappers' LANE_GROUP); groups of 2 and 8 and
// 64-thread blocks without groups were slower at the stream's 15,000 rays
// (PERF.md).
constexpr int kLaneGroup = 4;

// kLanes (4) neighbouring lanes of a warp that carry one ray. Each scans
// its own contiguous 1 / kLanes of a wall table, [lo, lo + count); the
// group then combines the results with shuffles over its own lanes, so the
// other groups of the warp may be elsewhere. Every lane of the group holds
// the same ray and so takes the same branches around the calls; only the
// lead lane deposits (sink) and counts work.
template <int kLanes>
struct LaneGroup {
  unsigned mask;  // the group's lanes in the warp
  int rank;       // this lane's place in the group
  int lo, count;  // this lane's walls of the table

  // The group of the calling lane, over a table of n walls.
  __device__ __forceinline__ static LaneGroup mine(int n) {
    const int lane = static_cast<int>(threadIdx.x & 31);
    const int rank = lane & (kLanes - 1);
    const int per = (n + kLanes - 1) / kLanes;
    const int lo = min(n, rank * per);
    return {((1u << kLanes) - 1u) << (lane & ~(kLanes - 1)), rank, lo,
            min(n, lo + per) - lo};
  }

  __device__ __forceinline__ bool lead() const { return rank == 0; }

  template <class S>
  __device__ __forceinline__ GroupSink<S> sink(const S& s) const {
    return {s, lead()};
  }

  // (closest, best) of the group: the smallest distance, and among equal
  // distances the lowest index, the result of one ascending scan of the
  // whole table (each wall's distance is the same whichever lane tests
  // it).
  __device__ __forceinline__ void min_hit(float& closest, int& best) const {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float t = __shfl_xor_sync(mask, closest, off, kLanes);
      const int i = __shfl_xor_sync(mask, best, off, kLanes);
      if (t < closest || (t == closest && i < best)) {
        closest = t;
        best = i;
      }
    }
  }

  // The lowest of the group's blocker indices (-1: none), the first
  // blocker of one ascending scan of the whole table.
  __device__ __forceinline__ int min_blocker(int blocker) const {
    unsigned u = static_cast<unsigned>(blocker);  // -1 sorts last
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      u = min(u, __shfl_xor_sync(mask, u, off, kLanes));
    return static_cast<int>(u);
  }
};

// One lane per ray (no lane group): it scans the whole table itself and
// deposits through the plain sink.
template <>
struct LaneGroup<1> {
  __device__ __forceinline__ static LaneGroup mine(int) { return {}; }
  __device__ __forceinline__ static constexpr bool lead() { return true; }
  template <class S>
  __device__ __forceinline__ static const S& sink(const S& s) {
    return s;
  }
};

// A ray leaving the source (ops/trace.py::_emit): stratified angle
// (ray + jitter) / R * 2pi, energy `gain` in every band; a directive
// source weights it by its pattern src_c[n_src] at the ray's direction.
// A wide ray (kMaxK == kWideK) takes its scratch `wide` and fills its
// n_bands energies there.
template <int kMaxK, bool kDirective = false>
__device__ __forceinline__ Ray<kMaxK> emit_ray(int ray, int n_rays,
                                               float jitter, float src_x,
                                               float src_y, float c,
                                               float gain,
                                               const float* src_c = nullptr,
                                               int n_src = 0,
                                               WideBands wide = {},
                                               int n_bands = 1) {
  Ray<kMaxK> r;
  const float angle =
      (static_cast<float>(ray) + jitter) / static_cast<float>(n_rays) *
      kTwoPi;
  r.px = src_x;
  r.py = src_y;
  sincosf(angle, &r.dy, &r.dx);
  if constexpr (kDirective) gain = gain * fourier_gain(r.dx, r.dy, src_c,
                                                       n_src);
  if constexpr (kMaxK == kWideK) {
    r.en = wide;
    for (int k = 0; k < n_bands; ++k) r.en[k] = gain;
  } else {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) r.en[k] = gain;
  }
  r.tm = 0.0f;
  r.ds = 0.0f;
  r.sp = c;
  r.dep = 0;
  return r;
}

// The bounce after the nearest-wall search found `closest` and `hit`
// (-1: escaped) on wall table `w`. occluded(sx, sy, vdx, vdy,
// dist, limit) runs one occlusion sweep and returns true when a wall
// blocks the shadow ray before `limit`; draw() gives this bounce's three
// uniforms; `sink` (Sink or RowSink) takes the hits, each weighted by the
// listener's microphone pattern when kDirective. Returns false when the
// ray dies (escaped, or every band under the energy cutoff); the ray is
// then left as it was.
template <int kMaxK, bool kDirective = false, class SinkT, class Occluded,
          class Draw>
__device__ __forceinline__ bool finish_bounce(Ray<kMaxK>& r, float closest,
                                              int hit, const WallTable& w,
                                              const Listeners& lis,
                                              const SinkT& sink,
                                              Occluded occluded, Draw draw) {
  const int nk = sink.n_bands;
  const float c = lis.c;
  constexpr int kRegK = kMaxK == kWideK ? 1 : kMaxK;  // register arrays
  // --- direct listener capture, outside walls only -------------------------
  if (r.dep == 0) {
    for (int l = 0; l < lis.n; ++l) {
      const float lx = lis.xy[2 * l] - r.px, ly = lis.xy[2 * l + 1] - r.py;
      const float tca = lx * r.dx + ly * r.dy;
      const float d2 = (lx * lx + ly * ly) - tca * tca;
      if (!(tca >= 0.0f && d2 <= lis.r2)) continue;
      const float thc = (lis.r2 - d2) > 0.0f ? sqrtf(lis.r2 - d2) : 0.0f;
      const float t0 = tca - thc, t1 = tca + thc;
      const float t_lis = t0 > kEps ? t0 : (t1 > kEps ? t1 : kInf);
      if (!(t_lis < closest && t_lis < kInf)) continue;
      const float total_d = r.ds + t_lis;
      const float att = fmaxf(total_d * total_d, 1.0f);
      if constexpr (kMaxK == kWideK) {
        float g = 1.0f;  // the sound arrives from -d
        if constexpr (kDirective)
          g = fourier_gain(-r.dx, -r.dy, lis.mic + l * lis.n_mic, lis.n_mic);
        deposit_bands(sink, l, r.tm + t_lis / r.sp, [&](int k) {
          float e = r.en[k] / att;
          if constexpr (kDirective) e = e * g;
          return e;
        });
      } else {
        float e[kRegK];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) e[k] = r.en[k] / att;
        if constexpr (kDirective) {  // the sound arrives from -d
          const float g = fourier_gain(-r.dx, -r.dy, lis.mic + l * lis.n_mic,
                                       lis.n_mic);
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) e[k] = e[k] * g;
        }
        deposit<kMaxK>(sink, 0, l, r.tm + t_lis / r.sp, e);
      }
    }
  }
  if (hit < 0) return false;  // escaped: dead from here on

  // --- advance to the wall --------------------------------------------------
  const float npx = r.px + r.dx * closest, npy = r.py + r.dy * closest;
  const float ntm = r.tm + closest / r.sp, nds = r.ds + closest;
  const int n = w.n;
  const float w_nx = w.attr[A_NX * n + hit];
  const float w_ny = w.attr[A_NY * n + hit];
  const float w_scat = w.attr[A_SCAT * n + hit];
  const float w_trans = w.attr[A_TRANS * n + hit];
  const float w_ior = w.attr[A_IOR * n + hit];
  float keep[kRegK];  // 1 - absorption, per band (registers)
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    keep[k] = k < nk ? 1.0f - band_absorption(w, hit, k) : 0.0f;
  // the same for a wide ray, read when needed
  const auto keep_of = [&](int k) {
    return 1.0f - band_absorption(w, hit, k);
  };
  const float d_dot_n = r.dx * w_nx + r.dy * w_ny;

  // --- NEE with occlusion (shadow ray offset along the UNflipped normal,
  //     direction normalized by the unoffset distance: reference quirks) ----
  if (r.dep == 0) {
    const float sx = npx + w_nx * kEps, sy = npy + w_ny * kEps;
    const float eff_sign = d_dot_n > 0.0f ? -1.0f : 1.0f;
    const float enx = w_nx * eff_sign, eny = w_ny * eff_sign;
    for (int l = 0; l < lis.n; ++l) {
      const float lx = lis.xy[2 * l], ly = lis.xy[2 * l + 1];
      const float tx = lx - npx, ty = ly - npy;
      const float dist_l = sqrtf(fmaxf(tx * tx + ty * ty, 1e-20f));
      const float cos_t = fmaxf(enx * (tx / dist_l) + eny * (ty / dist_l),
                                0.0f);
      const float total_dn = nds + dist_l;
      const float geom = cos_t * 0.5f / (total_dn * total_dn);
      float e[kRegK];
      float e_max = 0.0f;
      if constexpr (kMaxK == kWideK) {
        for (int k = 0; k < nk; ++k) {
          const float ek = r.en[k] * keep_of(k) * geom;
          e_max = k == 0 ? ek : fmaxf(e_max, ek);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          e[k] = r.en[k] * keep[k] * geom;
          if (k < nk) e_max = k == 0 ? e[k] : fmaxf(e_max, e[k]);
        }
      }
      if (!(e_max > kNeeCutoff)) continue;
      const float vdx = (lx - sx) / dist_l, vdy = (ly - sy) / dist_l;
      // The listener leg uses the rest-frame speed c, not the current one.
      if (!occluded(sx, sy, vdx, vdy, dist_l, dist_l - kOcclusionSlack)) {
        // the pickup, only for a hit that lands: the sound arrives from
        // the bounce point, -(t / dist_l)
        if constexpr (kMaxK == kWideK) {
          float g = 1.0f;
          if constexpr (kDirective)
            g = fourier_gain(-(tx / dist_l), -(ty / dist_l),
                             lis.mic + l * lis.n_mic, lis.n_mic);
          deposit_bands(sink, l, ntm + dist_l / c, [&](int k) {
            float ek = r.en[k] * keep_of(k) * geom;
            if constexpr (kDirective) ek = ek * g;
            return ek;
          });
        } else {
          if constexpr (kDirective) {
            const float g = fourier_gain(-(tx / dist_l), -(ty / dist_l),
                                         lis.mic + l * lis.n_mic, lis.n_mic);
#pragma unroll
            for (int k = 0; k < kMaxK; ++k) e[k] = e[k] * g;
          }
          deposit<kMaxK>(sink, 1, l, ntm + dist_l / c, e);
        }
      }
    }
  }

  // --- absorption + cutoff (on the loudest band) ----------------------------
  float nen[kRegK];
  float n_max = 0.0f;
  if constexpr (kMaxK == kWideK) {
    for (int k = 0; k < nk; ++k) {
      const float nk_e = r.en[k] * keep_of(k);
      n_max = k == 0 ? nk_e : fmaxf(n_max, nk_e);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      nen[k] = r.en[k] * keep[k];
      if (k < nk) n_max = k == 0 ? nen[k] : fmaxf(n_max, nen[k]);
    }
  }
  if (!(n_max >= kEnergyCutoff)) return false;

  const Uniforms uv = draw();

  // --- transmission / refraction --------------------------------------------
  const bool entering = d_dot_n < 0.0f;
  const float nex = entering ? w_nx : -w_nx;
  const float ney = entering ? w_ny : -w_ny;
  const float wall_speed = c / w_ior;
  const float next_speed =
      entering ? wall_speed : (r.dep <= 1 ? c : wall_speed);
  const float eta = next_speed / r.sp;
  const float cosi = -(r.dx * nex + r.dy * ney);
  const float cost2 = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const bool refr_ok = cost2 > 0.0f;
  const bool transmit = (uv.u0 < w_trans) && refr_ok;

  float ndx, ndy;
  if (transmit) {
    const float coef = eta * cosi - sqrtf(fabsf(cost2));
    const float rx = eta * r.dx + coef * nex, ry = eta * r.dy + coef * ney;
    float sj, cj;
    sincosf((uv.u1 - 0.5f) * 2.0f * w_scat, &sj, &cj);
    ndx = rx * cj - ry * sj;
    ndy = rx * sj + ry * cj;
    normalize2(ndx, ndy);
  } else {
    // --- reflection: specular/diffuse lerp ----------------------------------
    const float dn2 = 2.0f * (r.dx * nex + r.dy * ney);
    const float spx = r.dx - dn2 * nex, spy = r.dy - dn2 * ney;
    float sd, cd;
    sincosf(asinf(fminf(fmaxf(2.0f * uv.u2 - 1.0f, -1.0f), 1.0f)), &sd,
            &cd);
    const float ddx = nex * cd - ney * sd, ddy = nex * sd + ney * cd;
    ndx = spx + (ddx - spx) * w_scat;
    ndy = spy + (ddy - spy) * w_scat;
    normalize2(ndx, ndy);
  }

  r.px = npx + (transmit ? ndx * kEps : nex * kEps);
  r.py = npy + (transmit ? ndy * kEps : ney * kEps);
  r.dx = ndx;
  r.dy = ndy;
  if constexpr (kMaxK == kWideK) {
    for (int k = 0; k < nk; ++k) r.en[k] = r.en[k] * keep_of(k);
  } else {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) r.en[k] = nen[k];
  }
  r.tm = ntm;
  r.ds = nds;
  if (transmit) {
    r.sp = next_speed;
    r.dep = entering ? r.dep + 1 : max(0, r.dep - 1);
  }
  return true;
}

// Sum each thread's work over its warp and add it to work_out[3] (tests,
// sweeps, slab tests) with one atomic per warp and counter. Every thread
// of the warp must call it.
__device__ __forceinline__ void add_work(Work work,
                                         unsigned long long* work_out) {
  for (int off = 16; off > 0; off >>= 1) {
    work.tests += __shfl_down_sync(0xffffffffu, work.tests, off);
    work.sweeps += __shfl_down_sync(0xffffffffu, work.sweeps, off);
    work.slabs += __shfl_down_sync(0xffffffffu, work.slabs, off);
  }
  if ((threadIdx.x & 31) == 0 && work.sweeps) {
    atomicAdd(work_out, work.tests);
    atomicAdd(work_out + 1, work.sweeps);
    if (work.slabs) atomicAdd(work_out + 2, work.slabs);
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

inline cudaError_t launch_fixed_to_float(const unsigned long long* acc,
                                         const double* scales, float* out,
                                         size_t n, size_t per_entry,
                                         cudaStream_t stream) {
  fixed_to_float_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0,
                          stream>>>(acc, scales, out, n, per_entry);
  return cudaGetLastError();
}

}  // namespace
