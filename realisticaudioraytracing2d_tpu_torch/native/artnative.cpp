// Native host runtime: scene flattening + real-time audio ring buffer.
//
// These are the host-side (non-TPU) components of the framework whose
// reference counterparts are C# host code:
//  * scene flattening  — SceneToData2D.GetSegmentsFromColliders
//    (Assets/Script/Helpers/SceneHelper.cs:29-98): collider loops ->
//    transformed edge soup with winding-signed outward normals. At 60 Hz
//    with dynamic obstacles this runs every frame (RayTraceManager.cs:67),
//    so it must be allocation-free and cache-friendly.
//  * streaming ring buffer — AudioManager's lock-protected overlap-add
//    buffer drained by the audio thread (Assets/Script/AudioManager.cs:
//    45-69). Here a mutex-protected additive ring with add-then-zero
//    drain, usable from a real audio callback thread.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Scene flattening
// ---------------------------------------------------------------------------

// Each box: transform (x, y, angle, sx, sy) + size (w, h) + offset (ox, oy).
// Output per edge: start.xy, end.xy, normal.xy  (6 floats), 4 edges per box.
// Returns number of edges written.
int art_flatten_boxes(const float* boxes, int n_boxes, float* out) {
  static const float cx[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
  static const float cy[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  int e = 0;
  for (int i = 0; i < n_boxes; ++i) {
    const float* b = boxes + i * 9;
    const float px = b[0], py = b[1], ang = b[2], sx = b[3], sy = b[4];
    const float w = b[5], h = b[6], ox = b[7], oy = b[8];
    const float c = std::cos(ang), s = std::sin(ang);
    const float winding = (sx * sy) < 0.f ? -1.f : 1.f;
    float wx[4], wy[4];
    for (int k = 0; k < 4; ++k) {
      const float lx = (cx[k] * w + ox) * sx;
      const float ly = (cy[k] * h + oy) * sy;
      wx[k] = c * lx - s * ly + px;
      wy[k] = s * lx + c * ly + py;
    }
    for (int k = 0; k < 4; ++k) {
      const int k2 = (k + 1) & 3;
      float dx = wx[k2] - wx[k], dy = wy[k2] - wy[k];
      const float len = std::sqrt(dx * dx + dy * dy);
      if (len > 0.f) { dx /= len; dy /= len; } else { dx = dy = 0.f; }
      float* o = out + (e++) * 6;
      o[0] = wx[k]; o[1] = wy[k];
      o[2] = wx[k2]; o[3] = wy[k2];
      o[4] = dy * winding; o[5] = -dx * winding;
    }
  }
  return e;
}

// Flatten a closed polygon loop of n points under (x, y, angle, sx, sy).
// points: n*2 floats (local space). out: n edges * 6 floats.
int art_flatten_loop(const float* points, int n_pts, const float* transform,
                     float* out) {
  const float px = transform[0], py = transform[1], ang = transform[2];
  const float sx = transform[3], sy = transform[4];
  const float c = std::cos(ang), s = std::sin(ang);
  const float winding = (sx * sy) < 0.f ? -1.f : 1.f;
  std::vector<float> wx(n_pts), wy(n_pts);
  for (int i = 0; i < n_pts; ++i) {
    const float lx = points[i * 2] * sx;
    const float ly = points[i * 2 + 1] * sy;
    wx[i] = c * lx - s * ly + px;
    wy[i] = s * lx + c * ly + py;
  }
  for (int i = 0; i < n_pts; ++i) {
    const int j = (i + 1) % n_pts;
    float dx = wx[j] - wx[i], dy = wy[j] - wy[i];
    const float len = std::sqrt(dx * dx + dy * dy);
    if (len > 0.f) { dx /= len; dy /= len; } else { dx = dy = 0.f; }
    float* o = out + i * 6;
    o[0] = wx[i]; o[1] = wy[i];
    o[2] = wx[j]; o[3] = wy[j];
    o[4] = dy * winding; o[5] = -dx * winding;
  }
  return n_pts;
}

// ---------------------------------------------------------------------------
// Morton-order wall clustering (host side)
// ---------------------------------------------------------------------------
// Sorts walls by the Morton (Z-order) code of their centroid and emits
// per-cluster AABBs over runs of `cluster_size` sorted walls — the input
// of the TPU chunk-early-out kernel (ops/accel.py): phase 1 slab-tests the
// cluster AABBs, phase 2 only runs the dense wall pass for clusters some
// ray in the tile can hit. Degenerate segments (a == b: the scene's
// padding) sort last and clusters holding only padding get an inverted
// AABB (+inf, -inf) no slab test can pass, so they are always skipped.
// Returns the cluster count (= ceil(n_segs / cluster_size)).

static inline uint32_t art_part1by1(uint32_t x) {
  x &= 0x0000ffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

int art_morton_clusters(const float* segs /*n*6*/, int n_segs,
                        int cluster_size, int32_t* out_order /*n*/,
                        float* out_aabb /*ceil(n/cs)*4*/) {
  const float inf = 1e30f;
  float xmin = inf, ymin = inf, xmax = -inf, ymax = -inf;
  std::vector<uint8_t> degen(n_segs);
  for (int i = 0; i < n_segs; ++i) {
    const float* s = segs + i * 6;
    degen[i] = (s[0] == s[2] && s[1] == s[3]);
    if (degen[i]) continue;
    xmin = std::fmin(xmin, std::fmin(s[0], s[2]));
    xmax = std::fmax(xmax, std::fmax(s[0], s[2]));
    ymin = std::fmin(ymin, std::fmin(s[1], s[3]));
    ymax = std::fmax(ymax, std::fmax(s[1], s[3]));
  }
  const float sx = (xmax > xmin) ? 65535.f / (xmax - xmin) : 0.f;
  const float sy = (ymax > ymin) ? 65535.f / (ymax - ymin) : 0.f;
  std::vector<uint64_t> keyed(n_segs);
  for (int i = 0; i < n_segs; ++i) {
    uint64_t key;
    if (degen[i]) {
      key = 0x1FFFFFFFFull;  // > any 32-bit Morton code: padding sorts last
    } else {
      const float* s = segs + i * 6;
      const float cx = 0.5f * (s[0] + s[2]);
      const float cy = 0.5f * (s[1] + s[3]);
      const uint32_t qx = (uint32_t)((cx - xmin) * sx);
      const uint32_t qy = (uint32_t)((cy - ymin) * sy);
      key = art_part1by1(qx) | (art_part1by1(qy) << 1);
    }
    // key fits 33 bits (sentinel 0x1FFFFFFFF), leaving 31 for the index:
    // stable sort with no wall-count ceiling (n_segs is int <= 2^31-1)
    keyed[i] = (key << 31) | (uint64_t)(uint32_t)i;
  }
  std::sort(keyed.begin(), keyed.end());
  const int n_clusters = (n_segs + cluster_size - 1) / cluster_size;
  for (int c = 0; c < n_clusters; ++c) {
    float* bb = out_aabb + c * 4;
    bb[0] = inf; bb[1] = inf; bb[2] = -inf; bb[3] = -inf;
  }
  for (int i = 0; i < n_segs; ++i) {
    const int src = (int)(keyed[i] & 0x7fffffffu);
    out_order[i] = src;
    if (degen[src]) continue;
    const float* s = segs + src * 6;
    float* bb = out_aabb + (i / cluster_size) * 4;
    bb[0] = std::fmin(bb[0], std::fmin(s[0], s[2]));
    bb[1] = std::fmin(bb[1], std::fmin(s[1], s[3]));
    bb[2] = std::fmax(bb[2], std::fmax(s[0], s[2]));
    bb[3] = std::fmax(bb[3], std::fmax(s[1], s[3]));
  }
  return n_clusters;
}

// ---------------------------------------------------------------------------
// Real-time ring buffer
// ---------------------------------------------------------------------------

struct ArtRing {
  std::vector<float> data;
  std::mutex lock;
  int64_t read_head = 0;
  int channels = 1;
  int size = 0;
};

void* art_ring_create(int channels, int size) {
  ArtRing* r = new ArtRing();
  r->channels = channels;
  r->size = size;
  r->data.assign((size_t)channels * size, 0.f);
  return r;
}

void art_ring_destroy(void* h) { delete static_cast<ArtRing*>(h); }

// Overlap-add n samples per channel at absolute sample offset
// (PushSamples semantics: AudioManager.cs:45-54).
void art_ring_push(void* h, const float* samples, int n, int64_t offset) {
  ArtRing* r = static_cast<ArtRing*>(h);
  std::lock_guard<std::mutex> g(r->lock);
  for (int c = 0; c < r->channels; ++c) {
    float* base = r->data.data() + (size_t)c * r->size;
    const float* src = samples + (size_t)c * n;
    int64_t w = offset % r->size;
    if (w < 0) w += r->size;
    for (int i = 0; i < n; ++i) {
      base[w] += src[i];
      if (++w == r->size) w = 0;
    }
  }
}

// Drain n samples per channel from the read head, zeroing consumed slots
// (OnAudioFilterRead semantics: AudioManager.cs:56-69).
void art_ring_drain(void* h, float* out, int n) {
  ArtRing* r = static_cast<ArtRing*>(h);
  std::lock_guard<std::mutex> g(r->lock);
  int64_t head = r->read_head % r->size;
  for (int c = 0; c < r->channels; ++c) {
    float* base = r->data.data() + (size_t)c * r->size;
    float* dst = out + (size_t)c * n;
    int64_t p = head;
    for (int i = 0; i < n; ++i) {
      dst[i] = base[p];
      base[p] = 0.f;
      if (++p == r->size) p = 0;
    }
  }
  r->read_head = (r->read_head + n) % r->size;
}

int64_t art_ring_read_head(void* h) {
  ArtRing* r = static_cast<ArtRing*>(h);
  std::lock_guard<std::mutex> g(r->lock);
  return r->read_head;
}

}  // extern "C"
