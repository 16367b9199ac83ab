// mp3 read/write for the host runtime, via the system codecs
// (libmpg123 for decode, libmp3lame for encode), bound at runtime with
// dlopen so the framework carries no build-time codec dependency and
// degrades gracefully (art_mp3_probe reports what resolved).
//
// Parity note: the reference ships its dry clips as mp3
// (Assets/Script/bruh.mp3, my-leg_2.mp3, ambient-wandering-wind-*.mp3)
// and decodes them with Unity's asset importer (AudioClip.GetData in
// AudioManager.cs) — it does not implement MPEG decoding, it borrows
// the engine's. This file is the same call: borrow the host codec,
// expose float32 PCM to the framework.
//
// The mpg123/lame prototypes and constants below are declared from the
// libraries' public C ABI (we cannot include their headers — not in
// the image). Constants are pinned by tests/test_native.py's
// encode->decode round trip against the real libraries.

#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// ---- mpg123 public ABI subset --------------------------------------
constexpr int MPG123_OK = 0;
constexpr int MPG123_DONE = -12;        // track ended
constexpr int MPG123_NEW_FORMAT = -11;  // output format changed
constexpr int ENC_FLOAT_32 = 0x200;     // MPG123_ENC_FLOAT_32
// signed|16bit|signed16 bits: MPG123_ENC_SIGNED_16 = 0x10|0x40|0x80
constexpr int ENC_SIGNED_16 = 0xD0;

struct Mpg123Api {
  int (*init)(void);
  void *(*newh)(const char *, int *);
  int (*open)(void *, const char *);
  int (*getformat)(void *, long *, int *, int *);
  int (*format_none)(void *);
  int (*format)(void *, long, int, int);
  int (*read)(void *, unsigned char *, size_t, size_t *);
  int (*close)(void *);
  void (*del)(void *);
  bool ok = false;
};

Mpg123Api *mpg123() {
  static Mpg123Api api;
  static bool tried = false;
  if (tried) return api.ok ? &api : nullptr;
  tried = true;
  void *so = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
  if (!so) so = dlopen("libmpg123.so", RTLD_NOW | RTLD_LOCAL);
  if (!so) return nullptr;
  api.init = (int (*)(void))dlsym(so, "mpg123_init");
  api.newh = (void *(*)(const char *, int *))dlsym(so, "mpg123_new");
  api.open = (int (*)(void *, const char *))dlsym(so, "mpg123_open");
  api.getformat =
      (int (*)(void *, long *, int *, int *))dlsym(so, "mpg123_getformat");
  api.format_none = (int (*)(void *))dlsym(so, "mpg123_format_none");
  api.format = (int (*)(void *, long, int, int))dlsym(so, "mpg123_format");
  api.read = (int (*)(void *, unsigned char *, size_t, size_t *))dlsym(
      so, "mpg123_read");
  api.close = (int (*)(void *))dlsym(so, "mpg123_close");
  api.del = (void (*)(void *))dlsym(so, "mpg123_delete");
  api.ok = api.init && api.newh && api.open && api.getformat &&
           api.format_none && api.format && api.read && api.close && api.del;
  if (!api.ok) return nullptr;
  if (api.init() != MPG123_OK) {  // no-op since mpg123 1.27, still polite
    api.ok = false;
    return nullptr;
  }
  return &api;
}

// ---- lame public ABI subset ----------------------------------------
struct LameApi {
  void *(*init)(void);
  int (*set_in_samplerate)(void *, int);
  int (*set_num_channels)(void *, int);
  int (*set_brate)(void *, int);
  int (*set_quality)(void *, int);
  int (*init_params)(void *);
  int (*encode_float)(void *, const float *, const float *, int,
                      unsigned char *, int);  // planar ieee [-1,1]
  int (*flush)(void *, unsigned char *, int);
  int (*close)(void *);
  bool ok = false;
};

LameApi *lame() {
  static LameApi api;
  static bool tried = false;
  if (tried) return api.ok ? &api : nullptr;
  tried = true;
  void *so = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_LOCAL);
  if (!so) so = dlopen("libmp3lame.so", RTLD_NOW | RTLD_LOCAL);
  if (!so) return nullptr;
  api.init = (void *(*)(void))dlsym(so, "lame_init");
  api.set_in_samplerate = (int (*)(void *, int))dlsym(so, "lame_set_in_samplerate");
  api.set_num_channels = (int (*)(void *, int))dlsym(so, "lame_set_num_channels");
  api.set_brate = (int (*)(void *, int))dlsym(so, "lame_set_brate");
  api.set_quality = (int (*)(void *, int))dlsym(so, "lame_set_quality");
  api.init_params = (int (*)(void *))dlsym(so, "lame_init_params");
  api.encode_float =
      (int (*)(void *, const float *, const float *, int, unsigned char *,
               int))dlsym(so, "lame_encode_buffer_ieee_float");
  api.flush = (int (*)(void *, unsigned char *, int))dlsym(so,
                                                           "lame_encode_flush");
  api.close = (int (*)(void *))dlsym(so, "lame_close");
  api.ok = api.init && api.set_in_samplerate && api.set_num_channels &&
           api.set_brate && api.set_quality && api.init_params &&
           api.encode_float && api.flush && api.close;
  return api.ok ? &api : nullptr;
}

struct DecodedClip {
  std::vector<float> pcm;  // interleaved [frames * channels]
  long rate = 0;
  int channels = 0;
};

}  // namespace

extern "C" {

// Bitmask of available codec paths: 1 = decode (mpg123), 2 = encode (lame).
int art_mp3_probe() {
  int m = 0;
  if (mpg123()) m |= 1;
  if (lame()) m |= 2;
  return m;
}

// Decode a whole mp3 file to interleaved float32. Returns an opaque
// handle (read size/rate/channels via out-params, copy via
// art_mp3_copy, release via art_mp3_free) or nullptr on failure.
void *art_mp3_decode(const char *path, int *rate, int *channels,
                     long long *frames) {
  static const long kRates[] = {8000,  11025, 12000, 16000, 22050,
                                24000, 32000, 44100, 48000};
  Mpg123Api *m = mpg123();
  if (!m) return nullptr;
  void *h = m->newh(nullptr, nullptr);
  if (!h) return nullptr;
  DecodedClip *clip = nullptr;
  long r = 0;
  int ch = 0;
  bool as_float = true;
  // Format restrictions apply to the NEXT track's negotiation, so lock
  // the output encoding BEFORE open: float32 at every standard MPEG
  // rate/channel combo (signed16 fallback for float-less builds). The
  // first read then reports MPG123_NEW_FORMAT with the negotiated
  // rate/channels.
  for (int pass = 0; pass < 2; ++pass) {
    const int enc = pass == 0 ? ENC_FLOAT_32 : ENC_SIGNED_16;
    bool all_ok = true;
    m->format_none(h);
    for (long rt : kRates)
      for (int c = 1; c <= 2; ++c)
        all_ok &= m->format(h, rt, c, enc) == MPG123_OK;
    if (all_ok) {
      as_float = pass == 0;
      break;
    }
    if (pass == 1) goto fail;
  }
  if (m->open(h, path) != MPG123_OK) goto fail;
  {
    clip = new DecodedClip();
    std::vector<unsigned char> buf(65536);
    for (;;) {
      size_t done = 0;
      int rc = m->read(h, buf.data(), buf.size(), &done);
      if (done) {
        if (as_float) {
          const float *p = reinterpret_cast<const float *>(buf.data());
          clip->pcm.insert(clip->pcm.end(), p, p + done / sizeof(float));
        } else {
          const int16_t *p = reinterpret_cast<const int16_t *>(buf.data());
          size_t n = done / sizeof(int16_t);
          size_t at = clip->pcm.size();
          clip->pcm.resize(at + n);
          for (size_t i = 0; i < n; ++i)
            clip->pcm[at + i] = static_cast<float>(p[i]) / 32768.0f;
        }
      }
      if (rc == MPG123_DONE) break;
      if (rc == MPG123_NEW_FORMAT) {
        long r2 = 0;
        int ch2 = 0, enc2 = 0;
        if (m->getformat(h, &r2, &ch2, &enc2) != MPG123_OK) goto fail;
        // first NEW_FORMAT announces the track format; a LATER one
        // changing rate/channels (mid-stream switch) is unsupported
        if (r != 0 && (r2 != r || ch2 != ch)) goto fail;
        r = r2;
        ch = ch2;
        continue;
      }
      if (rc != MPG123_OK) {
        if (clip->pcm.empty()) goto fail;  // nothing decoded: error out
        break;  // tail error after valid audio (e.g. truncated file)
      }
    }
    if (ch < 1 || clip->pcm.empty()) goto fail;
    clip->rate = r;
    clip->channels = ch;
  }
  m->close(h);
  m->del(h);
  *rate = static_cast<int>(clip->rate);
  *channels = clip->channels;
  *frames = static_cast<long long>(clip->pcm.size() / clip->channels);
  return clip;
fail:
  delete clip;
  m->close(h);
  m->del(h);
  return nullptr;
}

void art_mp3_copy(void *handle, float *out) {
  DecodedClip *clip = static_cast<DecodedClip *>(handle);
  std::memcpy(out, clip->pcm.data(), clip->pcm.size() * sizeof(float));
}

void art_mp3_free(void *handle) {
  delete static_cast<DecodedClip *>(handle);
}

// Encode interleaved float32 ([-1,1]) to an mp3 file at `kbps` CBR.
// Returns 0 on success, negative on failure.
int art_mp3_encode(const char *path, const float *pcm, long long frames,
                   int channels, int rate, int kbps) {
  LameApi *l = lame();
  if (!l) return -1;
  if (channels < 1 || channels > 2 || frames < 1) return -2;
  void *g = l->init();
  if (!g) return -3;
  l->set_in_samplerate(g, rate);
  l->set_num_channels(g, channels);
  l->set_brate(g, kbps);
  l->set_quality(g, 2);
  if (l->init_params(g) < 0) {
    l->close(g);
    return -4;
  }
  // lame wants planar channels
  std::vector<float> left(frames), right;
  const float *rp = nullptr;
  if (channels == 2) {
    right.resize(frames);
    for (long long i = 0; i < frames; ++i) {
      left[i] = pcm[2 * i];
      right[i] = pcm[2 * i + 1];
    }
    rp = right.data();
  } else {
    std::memcpy(left.data(), pcm, frames * sizeof(float));
  }
  FILE *f = std::fopen(path, "wb");
  if (!f) {
    l->close(g);
    return -5;
  }
  std::vector<unsigned char> out(frames * 5 / 4 + 7200);
  int rc = -6;
  int n = l->encode_float(g, left.data(), rp, static_cast<int>(frames),
                          out.data(), static_cast<int>(out.size()));
  if (n >= 0 && std::fwrite(out.data(), 1, n, f) == size_t(n)) {
    n = l->flush(g, out.data(), static_cast<int>(out.size()));
    if (n >= 0 && std::fwrite(out.data(), 1, n, f) == size_t(n)) rc = 0;
  }
  std::fclose(f);
  l->close(g);
  return rc;
}

}  // extern "C"
