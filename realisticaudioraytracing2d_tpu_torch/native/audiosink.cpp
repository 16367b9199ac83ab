// OS audio-device sink for the live pipeline, via ALSA (libasound),
// bound at runtime with dlopen so the framework carries no build-time
// audio dependency and degrades gracefully where no sound system
// exists (art_sink_probe reports what resolved).
//
// Parity note: this is the last stretch of the reference's audio path —
// Unity's audio thread hands the drained ring buffer to the sound card
// (AudioManager.OnAudioFilterRead, AudioManager.cs:56-69; the engine
// owns the device). Here the LivePlayer consumer thread plays each
// drained DSP buffer through the default ALSA PCM device. Same move as
// native/mp3dec.cpp: borrow the host's codec/device stack at runtime.
//
// The ALSA prototypes and constants below are declared from alsa-lib's
// public C ABI (headers are not in this image):
//   SND_PCM_STREAM_PLAYBACK = 0, SND_PCM_FORMAT_FLOAT_LE = 14,
//   SND_PCM_ACCESS_RW_INTERLEAVED = 3.

#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int STREAM_PLAYBACK = 0;
constexpr int FORMAT_FLOAT_LE = 14;
constexpr int ACCESS_RW_INTERLEAVED = 3;

struct AlsaApi {
  int (*open)(void **, const char *, int, int);
  int (*set_params)(void *, int, int, unsigned, unsigned, int, unsigned);
  long (*writei)(void *, const void *, unsigned long);
  int (*recover)(void *, int, int);
  int (*drain)(void *);
  int (*close)(void *);
  const char *(*strerror_)(int);
  bool ok = false;
};

AlsaApi *alsa() {
  static AlsaApi api;
  static bool tried = false;
  if (tried) return api.ok ? &api : nullptr;
  tried = true;
  void *so = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
  if (!so) so = dlopen("libasound.so", RTLD_NOW | RTLD_LOCAL);
  if (!so) return nullptr;
  api.open = (int (*)(void **, const char *, int, int))dlsym(so,
                                                             "snd_pcm_open");
  api.set_params = (int (*)(void *, int, int, unsigned, unsigned, int,
                            unsigned))dlsym(so, "snd_pcm_set_params");
  api.writei = (long (*)(void *, const void *, unsigned long))dlsym(
      so, "snd_pcm_writei");
  api.recover = (int (*)(void *, int, int))dlsym(so, "snd_pcm_recover");
  api.drain = (int (*)(void *))dlsym(so, "snd_pcm_drain");
  api.close = (int (*)(void *))dlsym(so, "snd_pcm_close");
  api.strerror_ = (const char *(*)(int))dlsym(so, "snd_strerror");
  api.ok = api.open && api.set_params && api.writei && api.recover &&
           api.drain && api.close && api.strerror_;
  return api.ok ? &api : nullptr;
}

char g_err[256];

void set_err(const char *what, int code) {
  AlsaApi *a = alsa();
  snprintf(g_err, sizeof(g_err), "%s: %s", what,
           (a && a->strerror_) ? a->strerror_(code) : "alsa error");
}

}  // namespace

extern "C" {

// 1 = libasound resolved (a device may still fail to open), 0 = no ALSA
// runtime on this host.
int art_sink_probe() { return alsa() ? 1 : 0; }

// Last error string (valid after a failed open/write).
const char *art_sink_error() { return g_err; }

// Open the playback device ("default" when name is null/empty) at
// float32 interleaved `channels` x `rate`, software latency
// `latency_us`. Returns an opaque handle or null (art_sink_error).
void *art_sink_open(const char *name, unsigned rate, unsigned channels,
                    unsigned latency_us) {
  AlsaApi *a = alsa();
  if (!a) {
    snprintf(g_err, sizeof(g_err), "libasound.so.2 not found");
    return nullptr;
  }
  void *pcm = nullptr;
  const char *dev = (name && name[0]) ? name : "default";
  int rc = a->open(&pcm, dev, STREAM_PLAYBACK, 0);
  if (rc < 0) {
    set_err("snd_pcm_open", rc);
    return nullptr;
  }
  rc = a->set_params(pcm, FORMAT_FLOAT_LE, ACCESS_RW_INTERLEAVED, channels,
                     rate, /*soft_resample=*/1, latency_us);
  if (rc < 0) {
    set_err("snd_pcm_set_params", rc);
    a->close(pcm);
    return nullptr;
  }
  return pcm;
}

// Blocking interleaved write of `frames` frames of `channels`-channel
// audio; recovers from underrun/suspend (an xrun here = late producer,
// already counted upstream as an underrun). Returns frames written, or
// <0 (art_sink_error).
long art_sink_write(void *pcm, const float *interleaved, long frames,
                    int channels) {
  AlsaApi *a = alsa();
  if (!a || !pcm) return -1;
  long done = 0;
  while (done < frames) {
    long n = a->writei(pcm, interleaved + done * channels,
                       (unsigned long)(frames - done));
    if (n < 0) {
      int rc = a->recover(pcm, (int)n, /*silent=*/1);
      if (rc < 0) {
        set_err("snd_pcm_writei", rc);
        return -1;
      }
      continue;
    }
    if (n == 0) break;  // defensive: never spin on a stuck device
    done += n;
  }
  return done;
}

void art_sink_close(void *pcm) {
  AlsaApi *a = alsa();
  if (!a || !pcm) return;
  a->drain(pcm);
  a->close(pcm);
}

}  // extern "C"
