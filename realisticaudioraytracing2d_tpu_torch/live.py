"""Live audio pipeline: sim-clock producer + audio-clock consumer thread
(PyTorch).

Port of ``realisticaudioraytracing2d_tpu/live.py``. The reference plays
its wet audio: ``ProcessChunk`` pushes each convolved chunk into a
mutex-protected ring buffer on the main thread
(``RayTraceManager.cs:91-123`` -> ``AudioManager.PushSamples``,
``AudioManager.cs:45-54``) while Unity's audio thread drains it 1,024
samples per callback (``AudioManager.OnAudioFilterRead``,
``AudioManager.cs:56-69``), copying mono to every channel and zeroing
what it consumed.

A producer thread runs the stream's own chunk loop: the dry feed and
controls, the settings and the carried-state step that
:class:`..streaming.Streamer` runs (``streaming._StreamSettings``), around
the chunk step :func:`..streaming.wet_chunk` (the trace through the hand
kernels on the card, the crossfaded convolution, per-arrival Doppler's
taps). It overlap-adds each wet chunk, then its taps, into the host
:class:`~.native.NativeRingBuffer` in the stream's order of additions
(so integrity-mode output equals ``Streamer.stream_clip``'s bit for
bit); a consumer thread drains fixed DSP buffers on the audio clock. A
sample is *drainable* once the chunk whose head covers it has been
pushed (later chunks only add reverb tail into already-final regions:
the overlap-add identity); draining past that frontier is an
**underrun** (the real callback would play the partial sum), which is
counted, not hidden.

The producer reads each wet chunk back to the host once (``.cpu()``,
which waits for the device): ``(N + T) x L`` floats, 307 KB a listener at
4,800 + 72,000 samples. On the card it works on the player's device
explicitly, and the CUDA kernels are built before the threads start, so
a first build (nvcc, tens of seconds) never runs inside the audio clock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .config import EngineConfig
from .device import resolve
from .models.scene import Scene
from .native import NativeRingBuffer
from .ops.trace import TraceParams
from .streaming import (_ARRIVAL_MATCH_BINS, _ARRIVAL_TAPS,
                        _ARRIVAL_WINDOW_S, _advance, _StreamSettings,
                        wet_chunk)


@dataclass
class LiveReport:
    """What happened during a live run (the observability the reference
    lacks: it plays partial buffers silently)."""

    audio: np.ndarray            # [L, consumed] what the audio thread heard
    underruns: int = 0           # callbacks that outran the producer
    callbacks: int = 0           # total audio-thread drains
    chunks: int = 0              # producer chunks pushed
    producer_seconds: float = 0.0
    realtime_factor: float = 0.0  # produced audio seconds / producer wall s
    max_lead_samples: int = 0    # peak producer lead over the consumer
    late_samples: int = 0        # tail energy dropped: consumer already past
    # per chunk, the producer's ms from the chunk's start to its push,
    # the backpressure wait left out (allocated once per run: [chunks])
    step_ms: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def summary(self) -> str:
        return (f"{self.chunks} chunks, {self.callbacks} callbacks "
                f"({self.underruns} underruns), producer "
                f"{self.realtime_factor:.2f}x realtime, peak lead "
                f"{self.max_lead_samples} samples, "
                f"{self.late_samples} late samples dropped")


class LivePlayer(_StreamSettings):
    """Producer/consumer driver of the live pipeline.

    ``realtime=True`` paces the consumer on the wall clock (one drain per
    ``dsp_buffer / sample_rate`` seconds, like the audio thread):
    underruns happen whenever the producer is slower than real time.
    ``realtime=False`` paces the consumer on the producer's frontier
    (integrity mode: every sample is final when read), which shows that
    the threaded path loses nothing.

    ``device`` (default: the package's :data:`..device.DEFAULT_DEVICE`,
    the card) must be the scene's device; on a torch without CUDA the
    default raises. ``seed``, ``uniforms_fn`` and ``backend`` are
    :class:`..streaming.Streamer`'s: chunk ``i`` draws under
    ``mix_seed(seed, i)`` unless ``uniforms_fn(i)`` gives its uniforms,
    and ``backend="plain"`` runs the plain versions; ``band_split`` is
    the streamer's too. The other arguments are the JAX player's (and the
    streamer's)."""

    def __init__(self, scene: Scene, config: EngineConfig, seed: int = 0,
                 n_listeners: int = 1, frames_per_chunk: int = 1,
                 dsp_buffer: int = 1024, ring_size: Optional[int] = None,
                 diffraction: bool = False, air_alpha=None,
                 binaural: bool = False, head_radius: float = 0.0875,
                 shadow: float = 0.6, decorrelate: bool = True,
                 arrival_taps: int = _ARRIVAL_TAPS,
                 arrival_window_s: float = _ARRIVAL_WINDOW_S,
                 arrival_match_bins: float = _ARRIVAL_MATCH_BINS,
                 uniforms_fn=None, backend: str = "auto", device=None,
                 band_split: str = "linear"):
        super().__init__(scene, config, seed, n_listeners, frames_per_chunk,
                         uniforms_fn, backend, diffraction, air_alpha,
                         binaural, head_radius, shadow, decorrelate,
                         arrival_taps, arrival_window_s, arrival_match_bins,
                         band_split)
        device = resolve(device)
        if device.type == "cuda":
            # an explicit index: the producer thread does not inherit the
            # caller's current device
            device = torch.device("cuda", device.index
                                  if device.index is not None
                                  else torch.cuda.current_device())
        if scene.device != device:
            raise ValueError(f"the scene lies on {scene.device}, the "
                             f"player on {device}")
        self.device = device
        self.dsp_buffer = dsp_buffer
        n = config.audio.chunk_samples
        t = config.audio.ir_length
        if ring_size is None:
            # ring sized like the reference: reverb + 1 s of slack
            # (AudioManager.cs:30-32), floored to hold chunk + tail + buffer
            ring_size = max(t + 2 * n + dsp_buffer,
                            t + config.audio.sample_rate)
        # below this the producer's backpressure wait and the consumer's
        # frontier wait could interlock
        min_size = n + t + dsp_buffer
        if ring_size < min_size:
            raise ValueError(f"ring_size {ring_size} < chunk+tail+dsp "
                             f"minimum {min_size}")
        self.ring = NativeRingBuffer(ring_size, self.n_listeners)
        if device.type == "cuda":
            # build (or load) the kernels now, outside the audio clock
            from .ops.cuda.build import load_library
            load_library()

    def run(self, dry: torch.Tensor, total_chunks: int,
            loop: Optional[bool] = None, realtime: bool = False,
            params_fn: Optional[Callable[[int], TraceParams]] = None,
            params: Optional[TraceParams] = None,
            on_chunk: Optional[Callable[[int, torch.Tensor], None]] = None,
            prime: int = 1,
            facing_fn: Optional[Callable[[int], float]] = None,
            doppler=False, sink=None, control_fn=None,
            scene_fn=None, record: bool = True) -> LiveReport:
        """Play ``total_chunks`` chunks of ``dry`` (a mono clip on the
        player's device) and return the :class:`LiveReport`.

        ``on_chunk(i, ir)`` (optional) runs on the producer thread after
        chunk ``i`` is pushed, with that chunk's normalized IR ``[L, T,
        K]``: the live-feedback hook (the reference blits the DrawIR
        texture every frame while audio plays, RayTraceManager.cs:
        252-258). ``ir`` is the player's IR buffer, which the next chunk
        overwrites in place: copy what you keep. Keep the hook cheap: it
        runs inside the producer's chunk budget.

        ``prime``: in realtime mode the audio clock starts once the first
        ``prime`` chunks are final (a prebuffer), so underruns measure the
        producer's lag, not its start. 0 restores the bare clock.

        ``params_fn``, ``facing_fn``, ``scene_fn`` (per-chunk geometry of
        the same padded wall count), ``doppler`` and ``control_fn`` (the
        reference's runtime verbs, ``RayTraceManager.cs:55-61``) are
        :meth:`..streaming.Streamer.stream_clip`'s: the player runs the
        stream's own dry feed, controls and carried-state step, so
        integrity-mode live output equals the stream's. A ``"stop"`` ends
        the run after flushing the reverb tail (the report's audio is
        shorter).

        ``sink`` (an object with ``write(block[C, N]) -> frames``, e.g.
        :class:`..native.AudioSink`) receives every drained DSP buffer on
        the consumer thread. A device sink's blocking write IS the audio
        clock, so the consumer skips the wall-clock sleep in realtime
        mode (underrun accounting unchanged).

        ``record=False`` drops the drained audio instead of keeping the
        session in the report (~0.2 MB/s a listener at 48 kHz): sink
        playback and every other report field are unaffected, and
        ``report.audio`` comes back empty.

        ``self.report`` is the report of the run in progress: its counters
        (chunks, callbacks, underruns, step_ms) can be read while it
        plays, as a long session's monitor does."""
        cfg = self.config
        n = cfg.audio.chunk_samples
        sr = cfg.audio.sample_rate
        dev = self.device
        loop = cfg.audio.loop if loop is None else loop
        if params_fn is None:
            if params is None:
                raise ValueError("pass params or params_fn")
            params_fn = lambda i: params  # noqa: E731

        frontier = 0                      # samples final & drainable
        consumed = 0                      # samples the audio thread drained
        frontier_lock = threading.Condition()
        stop = threading.Event()
        report = LiveReport(audio=np.zeros((self.n_listeners, 0),
                                           np.float32),
                            step_ms=np.zeros(total_chunks))
        self.report = report   # readable while the run plays
        total_samples = total_chunks * n
        # the consumer's goal in samples; shrinks when a control stop
        # ends the run early (read/written under frontier_lock)
        goal = [total_samples]
        producer_err = []

        # each run carries a fresh state, updated in place chunk by chunk
        # (the player overlap-adds into its host ring: the state's tensor
        # ring stays unused)
        state = self.state = self._init_state()

        def on_stop(end_step):
            with frontier_lock:
                goal[0] = min(goal[0], end_step * n)
                frontier_lock.notify_all()

        def produce():
            nonlocal frontier
            t_step = time.perf_counter()
            for i, piece, params, scene, facing, window in self._chunks(
                    state, dry, params_fn, total_chunks, loop, doppler,
                    control_fn, scene_fn, facing_fn, on_stop):
                kw = self._chunk_kw(state, facing, window)
                wet, taps, cur_ir, new_carry = wet_chunk(
                    scene, params, state.prev_ir, piece, state.chunk_index,
                    arrival=state.arrival, prev_facing=state.prev_facing,
                    **kw)
                _advance(state, cur_ir, new_carry, kw["binaural_facing"])
                wet_np = wet.cpu().numpy()    # device->host readback
                taps_np = taps.cpu().numpy() if taps is not None else None
                head = i * n
                span_end = head + wet_np.shape[-1]
                report.step_ms[i] = (time.perf_counter() - t_step) * 1e3
                with frontier_lock:
                    # Backpressure: a push may only cover live ring cells
                    # [consumed, consumed + size). Without this a fast
                    # producer wraps around and overlap-adds on top of
                    # undrained audio (silent corruption).
                    while (span_end - consumed > self.ring.size
                           and not stop.is_set()):
                        frontier_lock.wait(timeout=1.0)
                    if stop.is_set():
                        break
                    # Clip energy the consumer already played past:
                    # pushing behind the read head would resurface it one
                    # ring cycle later as ghost audio. The real callback
                    # played the partial sum; drop the rest.
                    off = max(0, consumed - head)
                    if off < wet_np.shape[-1]:
                        self.ring.push(wet_np[:, off:], head + off)
                    if taps_np is not None and off < n:
                        self.ring.push(taps_np[:, off:], head + off)
                    report.late_samples += min(off, wet_np.shape[-1])
                    frontier = (i + 1) * n
                    frontier_lock.notify_all()
                report.chunks = i + 1
                if on_chunk is not None:
                    on_chunk(i, state.prev_ir)
                if stop.is_set():
                    break
                t_step = time.perf_counter()

        def producer():
            t0 = time.perf_counter()
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        produce()
                else:
                    produce()
            except Exception as e:    # re-raised by run() on the caller
                producer_err.append(e)
            finally:
                report.producer_seconds = time.perf_counter() - t0
                with frontier_lock:
                    frontier_lock.notify_all()

        out = []

        def consumer():
            nonlocal consumed
            if realtime and prime > 0:
                # prebuffer: hold the audio clock until the first chunks
                # are final (bounded wait; a dead producer releases us
                # via the notify in its finally block)
                with frontier_lock:
                    while (frontier < min(prime * n, goal[0])
                           and not producer_err):
                        if not frontier_lock.wait(timeout=60.0):
                            break
            next_tick = time.perf_counter()
            period = self.dsp_buffer / sr
            while consumed < goal[0] and not producer_err:
                if realtime:
                    if sink is None:
                        next_tick += period
                        delay = next_tick - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    # else: the device's blocking write paces us: the
                    # drained-audio write below, or the silence write on
                    # a skipped tick
                    skip = False
                    with frontier_lock:
                        if frontier < min(consumed + self.dsp_buffer,
                                          goal[0]):
                            report.underruns += 1
                            skip = frontier <= consumed
                    if skip:
                        # nothing final yet: the real callback plays one
                        # DSP period of silence. The device write blocks
                        # for that period (outside the lock), so a lagging
                        # producer sees a paced consumer, not a busy-spin
                        # counting an underrun per spin; without a sink
                        # the wall-clock sleep above paced this tick.
                        if sink is not None:
                            sink.write(np.zeros(
                                (self.ring.channels, self.dsp_buffer),
                                np.float32))
                        continue
                else:
                    with frontier_lock:
                        while (frontier < min(consumed + self.dsp_buffer,
                                              goal[0])
                               and not producer_err):
                            frontier_lock.wait(timeout=60.0)
                with frontier_lock:
                    # drain under the lock so a concurrent push can never
                    # straddle the advancing read head mid-copy
                    want = min(self.dsp_buffer, goal[0] - consumed)
                    if want <= 0:     # a control stop shrank the goal
                        break
                    buf = self.ring.drain(want)  # read + zero
                    consumed += want
                    report.callbacks += 1
                    report.max_lead_samples = max(
                        report.max_lead_samples, frontier - consumed)
                    frontier_lock.notify_all()
                if record:
                    out.append(buf)
                if sink is not None:
                    # outside the lock: a blocking device write must not
                    # stall the producer's push
                    sink.write(buf)

        tp = threading.Thread(target=producer, name="sim-producer")
        tc = threading.Thread(target=consumer, name="audio-consumer")
        tp.start()
        tc.start()
        tc.join()
        stop.set()
        with frontier_lock:
            frontier_lock.notify_all()
        tp.join()
        if producer_err:
            raise producer_err[0]
        report.audio = (np.concatenate(out, axis=-1) if out
                        else report.audio)
        report.step_ms = report.step_ms[:report.chunks]
        produced_s = report.chunks * n / sr
        report.realtime_factor = (produced_s / report.producer_seconds
                                  if report.producer_seconds > 0 else 0.0)
        return report
