// Edge diffraction of orders 1 and 2 in three or four launches: the
// segments, a visibility sweep an order (K2, trace_kernel.cu, unchanged)
// and the binned paths (the art.addenda.diffraction span of streaming.py).
//
// It replaces no TPU kernel: the JAX package's diffraction is jnp, which
// XLA fuses into the jitted chunk step. It was added because on the card
// ops/diffraction.py's chain is some 270 PyTorch launches an order-2 call:
// the edge table's [E, E] tests (twice), the visibility segments' broadcasts
// and norms, two K2 sweeps that hold the source -> edge, source ->
// listener and edge -> listener families twice, the [L, E] and [L, E, E,
// K] path arithmetic, and two binnings, each a dense [L, T + 1, K] zero
// fill, a boolean gather that waits for the host and a sort-accumulate.
// Each launch costs the card about 2 us whatever it does; the work (some
// 650 segments against a dozen walls, a few hundred paths) is small.
//
// Every float32 operation is the card chain's, in its order, each rounded
// on its own (explicit _rn intrinsics; the library builds with
// --fmad=false; the same libdevice sqrtf / atan2f / cosf / sinf as
// PyTorch's CUDA kernels call), so the result equals
// diffraction_ir(..., use_kernels=False) on the card bit for bit:
//
// diffraction_segments_kernel (E = 2 W edges: the walls' starts, then
// their ends):
//   the edge table: into = b - a (a start) or a - b (an end), len = |into|,
//     valid0 = mask and len > EPS, n = into / max(len, EPS); e and j
//     coincide where |p_e - p_j|^2 < tol^2 and valid0[j]; e lies on a
//     straight seam where a coincident j != e has |n_e x n_j| < collinear
//     and n_e . n_j < 0; valid = valid0 and not on a seam; its
//     multiplicity m counts the coincident valid j (itself included);
//     weight = 1 / f32(m) where valid and m > 0, else 0;
//   K2's packed wall table, the layout of trace_kernel.py::pack_walls,
//   which both must match (a test holds the two equal): ax, ay,
//     v2x = bx - ax, v2y = by - ay, v2x ay - v2y ax;
//   each visibility segment once, as _segment_clear builds it: origin p,
//     d = q - p, len = |d|, direction d / max(len, EPS), limit len - slack;
//     in the order source -> edge [E], source -> listener [L], edge ->
//     listener [L, E], and at order 2 edge -> edge [E, E] (row-major).
// Its threads stride over the segments and the walls; block 0 also builds
// the edge table, in three passes with __syncthreads between them.
//
// diffraction_bin_kernel (a block a listener): a segment is clear where
// K2's distance is not below its limit (order 1's segments from the first
// sweep, the edge pairs from the second). A listener whose direct segment is
// clear hears no path. Else each candidate path is judged as the chain
// judges it, order 1 over the edges, then order 2 over the edge pairs
// (e1, e2) row-major:
//   order 1: d1 = |p_e - s|, d2 = |l - p_e|, d = d1 + d2, kept where
//     weight > 0, source -> edge and edge -> listener clear;
//     delta = max(d - |l - s|, 0), base = gain / max(d d, 1),
//     energy_k = ((weight base) / (3 + 20 (((2 delta) f_k) / c))) w,
//     w = (1 g_src(p_e - s)) g_mic(p_e - l) (each where set);
//   order 2: d12 = |p_e1 - p_e2|, d = (d1[e1] + d12) + d2[e2], kept where
//     weight[e1] weight[e2] > 0, d12 > tol, source -> e1, e1 -> e2 and
//     e2 -> listener clear; delta1 = max((d1[e1] + d12) - d1[e2], 0),
//     delta2 = max((d12 + d2[e2]) - d2[e1], 0),
//     n_i = ((2 delta_i) f_k) / c, att = 1 / ((3 + 20 n1) (3 + 20 n2)),
//     energy_k = (((w2d base) att) g_src(p_e1 - s)) g_mic(p_e2 - l);
//   the delay d / c lands in bin floor(f32(d / c) * f32(sample_rate)),
//     kept only in [0, T); gain / x is (1 / x) gain for a Python number
//     (Tensor.__rtruediv__), else a true division.
// g(angle) = max(((c0 + c1 cos(a)) + c2 sin(a)) + ..., 0) of
// atan2(y, x), with n a as f32(n) a (ops/directivity.py::evaluate). x / c
// is a true division by a speed of sound on the card and a product with
// the host's f32(1 / c) for a host number, as PyTorch divides a CUDA
// tensor by a Python number.
// The kept paths are compacted in their order (a block-wide scan a tile of
// kThreads candidates), their keys bin << 32 | position sorted (bitonic;
// in shared memory up to kSharedKeys keys, else in the caller's scratch),
// and the first path of each bin sums, for each band, its bin's order-1
// energies from 0 in path order, and apart from them its order-2 ones, as
// the chain's sort-accumulate (index_put_ under deterministic algorithms)
// sums each row, and adds ir[l, bin, k] + (s1 + s2) in place: the
// chain's cur_ir + (ir1 + ir2). Nothing is atomic, so a rerun gives the
// same bits.
//
// Bound: a launch's fixed cost. SampleScene at order 2 (16 walls, 4 of
// them masked padding: E = 32, one listener) is 1,089 segments and 1,056
// candidate paths a call; the four launches replace the chain's ~270.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the bin kernel sorts up to this many kept paths in shared memory
constexpr int kSharedKeys = 2048;
// a kept path's record: w base, delta (delta1), delta2, g_src (w at order
// 1), g_mic
constexpr int kRecord = 5;

struct Pt {
  float x, y;
};

// PyTorch's clamp(v, min=lo) with a scalar limit: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float norm(float x, float y) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
}

// edge e of E = 2 W: wall e's start, or wall e - W's end
__device__ __forceinline__ Pt edge_point(const float* a, const float* b,
                                         int n_w, int e) {
  const float* p = e < n_w ? a + 2 * e : b + 2 * (e - n_w);
  return Pt{p[0], p[1]};
}

__device__ __forceinline__ Pt load_pt(const float* p) {
  return Pt{p[0], p[1]};
}

// _segment_clear's ray of the open segment p -> q, written at row i
__device__ __forceinline__ void write_segment(Pt p, Pt q, float eps,
                                              float slack, float* o,
                                              float* d, float* limit,
                                              long long i) {
  const float dx = __fsub_rn(q.x, p.x), dy = __fsub_rn(q.y, p.y);
  const float len = norm(dx, dy);
  const float den = clamp_min(len, eps);
  o[2 * i] = p.x;
  o[2 * i + 1] = p.y;
  d[2 * i] = __fdiv_rn(dx, den);
  d[2 * i + 1] = __fdiv_rn(dy, den);
  limit[i] = __fsub_rn(len, slack);
}

struct Edges {
  const float* __restrict__ a;  // [W, 2]
  const float* __restrict__ b;  // [W, 2]
  const unsigned char* __restrict__ mask;  // [W]
  int n_w;
};

// edge points p (of e) and q (of j) are one corner: |p - q|^2 < tol^2
__device__ __forceinline__ bool coincide(Pt p, Pt q, float tol2) {
  const float dx = __fsub_rn(p.x, q.x), dy = __fsub_rn(p.y, q.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < tol2;
}

__global__ void __launch_bounds__(kThreads) diffraction_segments_kernel(
    Edges s, const float* __restrict__ src, const float* __restrict__ lis,
    int n_l, int order, int n_blocks, float eps, float slack, float tol2,
    float collinear, float* __restrict__ packed, float* edge,
    float* __restrict__ o, float* __restrict__ d,
    float* __restrict__ limit) {
  const int n_w = s.n_w, n_e = 2 * n_w;
  const long long n_le = static_cast<long long>(n_l) * n_e;
  const long long n_seg =
      n_e + n_l + n_le + (order == 2 ? static_cast<long long>(n_e) * n_e : 0);
  const long long start =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long step = static_cast<long long>(n_blocks) * kThreads;
  const Pt sp = load_pt(src);

  for (long long i = start; i < n_seg; i += step) {
    if (i < n_e) {
      write_segment(sp, edge_point(s.a, s.b, n_w, static_cast<int>(i)), eps,
                    slack, o, d, limit, i);
    } else if (i < n_e + n_l) {
      write_segment(sp, load_pt(lis + 2 * (i - n_e)), eps, slack, o, d,
                    limit, i);
    } else if (i < n_e + n_l + n_le) {
      const long long j = i - n_e - n_l;
      write_segment(edge_point(s.a, s.b, n_w, static_cast<int>(j % n_e)),
                    load_pt(lis + 2 * (j / n_e)), eps, slack, o, d, limit,
                    i);
    } else {
      const long long j = i - n_e - n_l - n_le;
      write_segment(edge_point(s.a, s.b, n_w, static_cast<int>(j / n_e)),
                    edge_point(s.a, s.b, n_w, static_cast<int>(j % n_e)),
                    eps, slack, o, d, limit, i);
    }
  }
  for (long long w = start; w < n_w; w += step) {
    const float ax = s.a[2 * w], ay = s.a[2 * w + 1];
    const float v2x = __fsub_rn(s.b[2 * w], ax);
    const float v2y = __fsub_rn(s.b[2 * w + 1], ay);
    packed[w] = ax;
    packed[n_w + w] = ay;
    packed[2 * n_w + w] = v2x;
    packed[3 * n_w + w] = v2y;
    packed[4 * n_w + w] = __fsub_rn(__fmul_rn(v2x, ay), __fmul_rn(v2y, ax));
  }
  if (blockIdx.x != 0) return;

  // the edge table: edge [5, E] rows nx, ny, valid0, valid, weight
  float* nx = edge;
  float* ny = edge + n_e;
  float* valid0 = edge + 2 * n_e;
  float* valid = edge + 3 * n_e;
  float* weight = edge + 4 * n_e;
  for (int e = threadIdx.x; e < n_e; e += kThreads) {
    const int w = e % n_w;
    const Pt pa = load_pt(s.a + 2 * w), pb = load_pt(s.b + 2 * w);
    const float ix = e < n_w ? __fsub_rn(pb.x, pa.x) : __fsub_rn(pa.x, pb.x);
    const float iy = e < n_w ? __fsub_rn(pb.y, pa.y) : __fsub_rn(pa.y, pb.y);
    const float len = norm(ix, iy);
    const float den = clamp_min(len, eps);
    nx[e] = __fdiv_rn(ix, den);
    ny[e] = __fdiv_rn(iy, den);
    valid0[e] = (s.mask[w] && len > eps) ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_e; e += kThreads) {
    const Pt p = edge_point(s.a, s.b, n_w, e);
    bool seam = false;
    for (int j = 0; j < n_e; ++j) {
      if (j == e || valid0[j] == 0.0f ||
          !coincide(p, edge_point(s.a, s.b, n_w, j), tol2))
        continue;
      const float cross = __fsub_rn(__fmul_rn(nx[e], ny[j]),
                                    __fmul_rn(ny[e], nx[j]));
      const float dot = __fadd_rn(__fmul_rn(nx[e], nx[j]),
                                  __fmul_rn(ny[e], ny[j]));
      seam = seam || (fabsf(cross) < collinear && dot < 0.0f);
    }
    valid[e] = (valid0[e] != 0.0f && !seam) ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_e; e += kThreads) {
    const Pt p = edge_point(s.a, s.b, n_w, e);
    int m = 0;
    for (int j = 0; j < n_e; ++j)
      m += (valid[j] != 0.0f && coincide(p, edge_point(s.a, s.b, n_w, j),
                                         tol2))
               ? 1
               : 0;
    weight[e] = (valid[e] != 0.0f && m > 0)
                    ? __fdiv_rn(1.0f, static_cast<float>(m))
                    : 0.0f;
  }
}

struct Paths {
  Edges s;
  const float* __restrict__ weight;  // [E]
  const float* __restrict__ src;     // [2]
  const float* __restrict__ lis;     // [L, 2]
  const float* __restrict__ tmin;    // [E + L + L E] K2's distances
  const float* __restrict__ tmin_pair;  // [E E] the second sweep's
  const float* __restrict__ limit;   // [N]
  const float* __restrict__ freqs;   // [K]
  const float* __restrict__ speed;   // the card's speed of sound, or null
  const float* __restrict__ gain;    // the card's input gain, or null
  const float* __restrict__ src_pat;  // [Cs] or null
  const float* __restrict__ mic_pat;  // [Cm] or [L, Cm], or null
  float inv_speed_h;  // f32(1 / c) of a host speed of sound
  float gain_h;       // a host input gain
  int gain_number;    // gain_h is a Python number: 1 / x times it
  float sample_rate;
  float tol;          // distinct edges: d12 > tol
  int n_l, n_k, n_t, order, n_src_c, n_mic_c, mic_per_listener;
  int key_cap;        // the scratch's keys a listener (a power of 2)
};

// x / c: a true division by the card's speed of sound, or the product
// with the host's reciprocal
__device__ __forceinline__ float over_c(const Paths& in, float x) {
  return in.speed != nullptr ? __fdiv_rn(x, *in.speed)
                             : __fmul_rn(x, in.inv_speed_h);
}

// gain / x: a true division by the card's gain or a host tensor's, and
// for a Python number the reciprocal times it (Tensor.__rtruediv__)
__device__ __forceinline__ float gain_over(const Paths& in, float x) {
  if (in.gain != nullptr) return __fdiv_rn(*in.gain, x);
  return in.gain_number ? __fmul_rn(__fdiv_rn(1.0f, x), in.gain_h)
                        : __fdiv_rn(in.gain_h, x);
}

// ops/directivity.py::evaluate of coefficients c [n_c] at atan2(y, x)
__device__ float pattern(const float* c, int n_c, float x, float y) {
  const float angle = atan2f(y, x);
  float g = c[0];
  for (int n = 1; 2 * n < n_c; ++n) {
    const float na = __fmul_rn(static_cast<float>(n), angle);
    g = __fadd_rn(__fadd_rn(g, __fmul_rn(c[2 * n - 1], cosf(na))),
                  __fmul_rn(c[2 * n], sinf(na)));
  }
  return clamp_min(g, 0.0f);
}

// segment i of the first sweep, or edge pair i - (E + L + L E)
__device__ __forceinline__ bool clear(const Paths& in, long long i) {
  const long long n_first =
      2LL * in.s.n_w + in.n_l + 2LL * in.s.n_w * in.n_l;
  const float t = i < n_first ? in.tmin[i] : in.tmin_pair[i - n_first];
  return !(t < in.limit[i]);
}

// Judges candidate c of listener l (order 1: c < E an edge; order 2: c -
// E a pair, row-major); where it is kept, writes its bin and record.
__device__ bool judge(const Paths& in, int l, int c, const Pt& sp,
                      const Pt& lp, float d_dir, int* bin, float* rec) {
  const int n_w = in.s.n_w, n_e = 2 * n_w;
  const long long leg = static_cast<long long>(n_e) + in.n_l +
                        static_cast<long long>(l) * n_e;
  float d, wb, da, db = 0.0f, ga = 1.0f, gb = 1.0f;
  int e_src, e_lis;  // the edges the source and the listener see
  if (c < n_e) {
    const int e = c;
    const float w = in.weight[e];
    if (!(w > 0.0f) || !clear(in, e) || !clear(in, leg + e)) return false;
    const Pt p = edge_point(in.s.a, in.s.b, n_w, e);
    const float d1 = norm(__fsub_rn(p.x, sp.x), __fsub_rn(p.y, sp.y));
    const float d2 = norm(__fsub_rn(lp.x, p.x), __fsub_rn(lp.y, p.y));
    d = __fadd_rn(d1, d2);
    const float base = gain_over(in, clamp_min(__fmul_rn(d, d), 1.0f));
    wb = __fmul_rn(w, base);
    da = clamp_min(__fsub_rn(d, d_dir), 0.0f);
    e_src = e_lis = e;
  } else {
    const int e1 = (c - n_e) / n_e, e2 = (c - n_e) % n_e;
    const float w2d = __fmul_rn(in.weight[e1], in.weight[e2]);
    const Pt p1 = edge_point(in.s.a, in.s.b, n_w, e1);
    const Pt p2 = edge_point(in.s.a, in.s.b, n_w, e2);
    const float d12 = norm(__fsub_rn(p1.x, p2.x), __fsub_rn(p1.y, p2.y));
    const long long pair = static_cast<long long>(n_e) + in.n_l +
                           static_cast<long long>(in.n_l) * n_e +
                           static_cast<long long>(e1) * n_e + e2;
    if (!(w2d > 0.0f) || !(d12 > in.tol) || !clear(in, e1) ||
        !clear(in, pair) || !clear(in, leg + e2))
      return false;
    const float d1a = norm(__fsub_rn(p1.x, sp.x), __fsub_rn(p1.y, sp.y));
    const float d1b = norm(__fsub_rn(p2.x, sp.x), __fsub_rn(p2.y, sp.y));
    const float d2a = norm(__fsub_rn(lp.x, p1.x), __fsub_rn(lp.y, p1.y));
    const float d2b = norm(__fsub_rn(lp.x, p2.x), __fsub_rn(lp.y, p2.y));
    const float s1 = __fadd_rn(d1a, d12);
    d = __fadd_rn(s1, d2b);
    const float base = gain_over(in, clamp_min(__fmul_rn(d, d), 1.0f));
    wb = __fmul_rn(w2d, base);
    da = clamp_min(__fsub_rn(s1, d1b), 0.0f);
    db = clamp_min(__fsub_rn(__fadd_rn(d12, d2b), d2a), 0.0f);
    e_src = e1;
    e_lis = e2;
  }
  const float f = floorf(__fmul_rn(over_c(in, d), in.sample_rate));
  const int b = static_cast<int>(f);
  if (b < 0 || b >= in.n_t) return false;
  const Pt ps = edge_point(in.s.a, in.s.b, n_w, e_src);
  const Pt pl = edge_point(in.s.a, in.s.b, n_w, e_lis);
  if (in.src_pat != nullptr)
    ga = __fmul_rn(ga, pattern(in.src_pat, in.n_src_c, __fsub_rn(ps.x, sp.x),
                               __fsub_rn(ps.y, sp.y)));
  if (in.mic_pat != nullptr) {
    const float* cm = in.mic_pat + (in.mic_per_listener ? l * in.n_mic_c : 0);
    const float g = pattern(cm, in.n_mic_c, __fsub_rn(pl.x, lp.x),
                            __fsub_rn(pl.y, lp.y));
    // order 1 multiplies the two patterns into one weight; order 2 each
    // into the energy in turn
    if (c < n_e)
      ga = __fmul_rn(ga, g);
    else
      gb = g;
  }
  *bin = b;
  rec[0] = wb;
  rec[1] = da;
  rec[2] = db;
  rec[3] = ga;
  rec[4] = gb;
  return true;
}

// band k's energy of a kept path's record
__device__ __forceinline__ float energy(const Paths& in, const float* rec,
                                        bool first_order, int k) {
  const float f = in.freqs[k];
  if (first_order) {
    const float fres = over_c(in, __fmul_rn(__fmul_rn(2.0f, rec[1]), f));
    const float den = __fadd_rn(3.0f, __fmul_rn(20.0f, fres));
    return __fmul_rn(__fdiv_rn(rec[0], den), rec[3]);
  }
  const float n1 = over_c(in, __fmul_rn(__fmul_rn(2.0f, rec[1]), f));
  const float n2 = over_c(in, __fmul_rn(__fmul_rn(2.0f, rec[2]), f));
  const float att = __fdiv_rn(
      1.0f, __fmul_rn(__fadd_rn(3.0f, __fmul_rn(20.0f, n1)),
                      __fadd_rn(3.0f, __fmul_rn(20.0f, n2))));
  return __fmul_rn(__fmul_rn(__fmul_rn(rec[0], att), rec[3]), rec[4]);
}

__global__ void __launch_bounds__(kThreads) diffraction_bin_kernel(
    Paths in, unsigned long long* keys_g, float* recs, float* ir) {
  __shared__ unsigned long long keys_s[kSharedKeys];
  __shared__ int scan[kThreads];
  const int l = blockIdx.x, t = threadIdx.x;
  const int n_e = 2 * in.s.n_w;
  const Pt sp = load_pt(in.src), lp = load_pt(in.lis + 2 * l);
  // every path needs the direct segment blocked
  if (clear(in, static_cast<long long>(n_e) + l)) return;
  const float d_dir = norm(__fsub_rn(lp.x, sp.x), __fsub_rn(lp.y, sp.y));
  const int n_cand = n_e + (in.order == 2 ? n_e * n_e : 0);
  unsigned long long* keys = keys_g + static_cast<long long>(l) * in.key_cap;
  float* rec_l = recs + static_cast<long long>(l) * n_cand * kRecord;

  // 1. judge the candidates a tile at a time and compact the kept ones in
  // their order: order 1's edges (n1 kept), then order 2's pairs
  int n_kept = 0, n1 = 0;
  for (int order = 1; order <= in.order; ++order) {
    const int lo = order == 1 ? 0 : n_e, hi = order == 1 ? n_e : n_cand;
    for (int c0 = lo; c0 < hi; c0 += kThreads) {
      const int c = c0 + t;
      int b = 0;
      float rec[kRecord];
      const bool kept = c < hi && judge(in, l, c, sp, lp, d_dir, &b, rec);
      scan[t] = kept ? 1 : 0;
      __syncthreads();
      for (int off = 1; off < kThreads; off <<= 1) {
        const int v = t >= off ? scan[t - off] : 0;
        __syncthreads();
        scan[t] += v;
        __syncthreads();
      }
      if (kept) {
        const int pos = n_kept + scan[t] - 1;
        keys[pos] = (static_cast<unsigned long long>(b) << 32) |
                    static_cast<unsigned int>(pos);
        for (int i = 0; i < kRecord; ++i)
          rec_l[static_cast<long long>(pos) * kRecord + i] = rec[i];
      }
      n_kept += scan[kThreads - 1];
      __syncthreads();
    }
    if (order == 1) n1 = n_kept;
  }
  if (n_kept == 0) return;

  // 2. sort the keys: by bin, then by position
  int m = 1;
  while (m < n_kept) m <<= 1;
  unsigned long long* k_s = keys;
  if (m <= kSharedKeys) {
    k_s = keys_s;
    for (int i = t; i < m; i += kThreads)
      keys_s[i] = i < n_kept ? keys[i] : ~0ULL;
  } else {
    for (int i = n_kept + t; i < m; i += kThreads) keys[i] = ~0ULL;
  }
  __syncthreads();
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < m; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = k_s[i], y = k_s[j];
          if ((x > y) == ((i & size) == 0)) {
            k_s[i] = y;
            k_s[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // 3. the first path of each bin sums the bin, band by band
  const long long n_work = static_cast<long long>(n_kept) * in.n_k;
  for (long long w = t; w < n_work; w += kThreads) {
    const int p = static_cast<int>(w / in.n_k);
    const int k = static_cast<int>(w % in.n_k);
    const unsigned long long bin = k_s[p] >> 32;
    if (p > 0 && (k_s[p - 1] >> 32) == bin) continue;
    float s1 = 0.0f, s2 = 0.0f;
    for (int q = p; q < n_kept && (k_s[q] >> 32) == bin; ++q) {
      const unsigned int pos = static_cast<unsigned int>(k_s[q]);
      const float e = energy(in, rec_l + static_cast<long long>(pos) * kRecord,
                             static_cast<int>(pos) < n1, k);
      if (static_cast<int>(pos) < n1)
        s1 = __fadd_rn(s1, e);
      else
        s2 = __fadd_rn(s2, e);
    }
    float* out = ir + (static_cast<long long>(l) * in.n_t +
                       static_cast<long long>(bin)) * in.n_k + k;
    *out = __fadd_rn(*out, __fadd_rn(s1, s2));
  }
}

}  // namespace

extern "C" {

// The edge table, K2's packed wall table and the visibility segments (see
// the top of this file) of walls a / b [W, 2] f32 with mask [W] u8, the
// source src [2] and listeners lis [L, 2] f32, at order 1 or 2. Writes
// packed [5, W], edge [5, E] (nx, ny, valid0, valid, weight), o / d [N, 2]
// and limit [N], N = E + L + L E (+ E E at order 2), all f32. One launch on
// `stream`, no host sync. Returns a cudaError_t code (0 = launched).
int art_diffraction_segments(const float* a, const float* b,
                             const unsigned char* mask, int n_w,
                             const float* src, const float* lis, int n_l,
                             int order, float eps, float slack, float tol2,
                             float collinear, float* packed, float* edge,
                             float* o, float* d, float* limit,
                             void* stream) {
  if (n_w < 1 || n_l < 1 || (order != 1 && order != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_e = 2LL * n_w;
  const long long n_seg = n_e + n_l + n_l * n_e + (order == 2 ? n_e * n_e : 0);
  long long work = n_seg > n_w ? n_seg : n_w;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  const int n_blocks = static_cast<int>(blocks);
  const Edges s{a, b, mask, n_w};
  diffraction_segments_kernel<<<n_blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      s, src, lis, n_l, order, n_blocks, eps, slack, tol2, collinear, packed,
      edge, o, d, limit);
  return static_cast<int>(cudaGetLastError());
}

// The paths of the segments above, judged with K2's distances: tmin [E +
// L + L E] of order 1's segments and, at order 2, tmin_pair [E E],
// binned and added into ir [L, T, K] f32 in place (see the top of this
// file). weight: the edge table's [E] row; freqs [K] f32; speed / gain:
// the card's f32 speed of sound and input gain, or null for the host's
// inv_speed_h = f32(1 / c) and gain_h (gain_number: a Python number);
// src_pat [Cs] and mic_pat [Cm] or [L,
// Cm] (mic_per_listener) f32, or null. Scratch: keys [L, key_cap] u64
// (key_cap a power of 2 at least the candidates, E (+ E E)) and recs [L,
// candidates, 5] f32. A block a listener, one launch on `stream`, no host
// sync. Returns a cudaError_t code (0 = launched).
int art_diffraction_bin(const float* a, const float* b, int n_w,
                        const float* weight, const float* src,
                        const float* lis, int n_l, const float* tmin,
                        const float* tmin_pair, const float* limit,
                        const float* freqs, int n_k, const float* speed,
                        float inv_speed_h,
                        const float* gain, float gain_h, int gain_number,
                        const float* src_pat, int n_src_c,
                        const float* mic_pat, int n_mic_c,
                        int mic_per_listener, float sample_rate, int n_t,
                        int order, float tol, unsigned long long* keys,
                        int key_cap, float* recs, float* ir, void* stream) {
  if (n_w < 1 || n_l < 1 || n_k < 1 || n_t < 1 ||
      (order != 1 && order != 2) || (order == 2 && tmin_pair == nullptr) ||
      (src_pat != nullptr && n_src_c < 1) ||
      (mic_pat != nullptr && n_mic_c < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Paths in{Edges{a, b, nullptr, n_w}, weight, src, lis, tmin,
                 tmin_pair, limit, freqs, speed, gain, src_pat, mic_pat,
                 inv_speed_h, gain_h, gain_number, sample_rate, tol, n_l,
                 n_k, n_t, order, n_src_c, n_mic_c, mic_per_listener,
                 key_cap};
  diffraction_bin_kernel<<<n_l, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, keys, recs, ir);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
