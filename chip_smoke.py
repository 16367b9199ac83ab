#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Drives the port's paths through the hand-written bounce kernel and holds
every kernel against its plain PyTorch version:

* the stream, ``Streamer.stream_clip`` on SmollRoom at the shipped
  configuration (15,000 rays x 5 bounces, 48 kHz, 1.5 s IR of 72,000 bins,
  0.1 s chunks of 4,800 samples), through K3 and K4;
* the room-dataset sweep, ``cli sweep --rooms 1024`` at the CLI's defaults
  (BASELINE.json config #5: 1,024 random rooms of 28 walls, 15,000 rays x
  5 bounces x 8 frames, 72,000 bins), through one launch of K9;
* the 64-source stereo mixdown in SmollRoom (BASELINE.json config #4),
  through one launch of K9;
* large scenes, the JAX package's large-scene bench (bench.py:249-301):
  the procedural city of 40,008 and 100,016 walls at 131,072 rays x 6
  bounces x 4 frames, 16 kHz, 24,000 bins, gain 100, through
  ``trace_accumulate(backend="auto")`` and the cluster kernel K8, the
  8-band city through K7 (the banded instantiations of K8's kernel), and the
  stream on a 10,008-wall city through K8;
* the hit-record path, ``cli trace`` and ``cli bake [--legacy]`` at their
  defaults (SmollRoom 15,000 rays x 5 bounces x 8 frames, 72,000 bins, 100
  debug rays; Big Room; the legacy IR of 562 time bins x 128 slots),
  through the wall sweeps K1/K2, K5's hit rows (the bounce loop of K3 with
  a row sink, one launch a frame) and K6 (K3/K4's launch at one frame).
* frequency bands, many listeners and batches of large scenes: the stream
  and ``cli bake`` at 8 octave bands, ``cli sweep --rooms 1024 --bands
  8``, a grid of 64 listeners, the 40,008-wall city at 32 bands through
  K7, and a sweep and a mixdown of 10,008-wall cities through K8.
* spatial IRs and the binaural stream: the three- and five-microphone
  capture (``spatial.trace_spatial``) through the directive K4 and K3 on
  SmollRoom, K8 and K7 on the 10,008-wall city; the binaural stream with
  a turning head; ``cli bake --binaural``, ``trace --spatial-out``,
  ``stream --binaural``, ``analyze`` and ``sweep --metrics-out``; the
  binaural decode kernel beside its plain chain (13e); per-arrival
  Doppler's ear-tap table and tap synthesis kernels beside theirs (13f);
  edge diffraction's kernels beside their chain at the barrier cell's
  call (13g).
* Doppler streams: ``Streamer.stream_clip(doppler="per_arrival")`` on
  SmollRoom (mono, and binaural at 8 bands) through K4, the tap tables,
  matching and synthesis plain tensor code on the card;
  ``doppler=True`` (the shared-rate dry feed); ``cli stream
  --doppler-per-arrival`` and ``--doppler``.
* the live pipeline: ``LivePlayer`` (a producer thread pushing each wet
  chunk into the native host ring, an audio thread draining it) on
  SmollRoom in mono, binaural and per-arrival modes through K4 and on
  the 10,008-wall city through K8, in integrity and realtime mode,
  steered by a pose feed written while it plays; ``cli live``, ``cli
  stream --pose-feed``, ``--scene-json`` and the bundled clip.
* differentiable acoustics (``diff.py``): the plain trace under autograd
  on the card at ``cli fit``'s width (SmollRoom 15,000 x 5, 72,000 bins),
  ``fit_materials``, the transmission surrogate through K1/K2, and ``cli
  trace --ir-out`` (K4) -> ``cli fit`` -> ``cli locate``.
* the device-mesh paths (``parallel/``) on a virtual mesh of the card
  (``[cuda:0] * 8``): the sharded sweep at ``cli sweep``'s defaults
  (8 K9 launches), a sweep of 10,008-wall cities through K8, the
  64-source mixdown (8 K9 launches), frame- and ray-sharded traces (K4
  with ``frame_offset`` and ``entry``, K3 on host uniforms), the
  time-sharded convolution, ``localize_source(mesh=)``, ``cli sweep
  --sharded``, ``utils/profiling.device_trace`` and the pytree
  checkpoint.
* the twins of the JAX package's twelve examples and the sharded dataset
  sweep (``examples/torch/``), each by its ``main(argv)`` at its default
  width, the depth of the inverse ones cut: the trace, the debug rays,
  bakes and streams of ``demo``, a microphone grid, a steered speaker
  array, direction of arrival, the occlusion, Doppler and binaural
  walk-bys, live steering through a pose feed, material fitting, source
  localization, the obstacle-pose negative result (source tracking only
  in ``scripts/torch_examples_phase.py --full``).
* the port's bench (``realisticaudioraytracing2d_tpu_torch/bench.py``, the
  JAX bench suite's measurements through the port) at the JAX sizes: the
  trace at 131,072 x 8 x 50 frames and 15,000 x 5, four listeners, the IR
  scatter, the streaming convolution, the stream chunk in four modes, the
  1,024-room sweep and the 40,008- and 100,016-wall cities, through K4,
  K9 and K8.

Phases:

0. device: the card's name and power limit (nvidia-smi);
1. build the kernels from ``realisticaudioraytracing2d_tpu_torch/csrc``;
2. K3 (host uniforms) vs plain, the same uniforms (torch-drawn and
   Philox), SmollRoom and Big Room, 15k x 5, 4 frames: energy and per-bin
   L1 within 1e-5 (SAME_ENERGY, SAME_L1), first nonzero bin equal;
3. K4 (in-kernel Philox) vs plain at 131,072 rays x 8 bounces x 8 frames:
   statistically against independent draws (energy 2%, first arrival 4
   bins, 5 ms envelope 5%, decay slope 10%), within the limits of 2
   against the plain path fed the same Philox numbers, and bit-identical
   on a rerun;
4. the stream: K4 and K3 against plain at the stream's own shape (one
   frame of 15k x 5), then 2.0 s of clicks = 20 chunks + 15 tail chunks
   through K4, and the same stream with one fixed IR through K3, which
   must equal the offline bake; the launch counts are reset before and
   read after each stream, the argument kernel's too (one a chunk);
4b. K3/K4/K6's argument kernel (``k4_args``, ``k4_args_kernel``): its
   wall table, scalars and fixed-point scale against the plain chain
   (``k4_args_plain``) bit for bit at the stream's and the bench's
   shapes, 1 and 8 bands, 1 to 64 listeners, omni and directive, one
   launch a call; its device time against the chain's (``[5]``-style
   profiler readings), registers and ptxas line;
6. the sweep: the CLI into a temporary directory (launch counts reset
   before and read after: one K9 launch), its npz read back; K9 over the
   1,024 rooms directly, which must equal the npz times 8 frames, rerun
   bit-identical; room 0 through K9 alone (E = 1) and as entry 0 of the
   sweep equals K4 on room 0 bit for bit; rooms 0, 1, 511 and 1023 within
   the limits of 2 against the plain version on the same Philox numbers;
   >= 90% of the rooms carry energy; the smallest per-room fixed-point
   scale;
7. the mixdown: 64 sources, two ears (counts reset and read: one K9
   launch), within the limits of 2 against the plain sum over sources on
   the same numbers, the ears differ;
8a. bit parity on a scene K4 can take: ``city_scene(1200)`` (4,808 walls)
   Morton-sorted, 131,072 x 6 x 4 frames: K4, K7 (K = 1) and K8 equal
   bit for bit, and K7 and K8 equal themselves with ``early_out=False``;
8b. the 40,008-wall city, K = 1, through ``trace_accumulate(backend=
   "auto")`` (counts reset and read: 6 K8 launches, nothing else); a
   rerun and ``early_out=False`` bit-identical; that IR against K8's
   plain version within SAME_ENERGY / SAME_L1 at the same full shape and
   Philox numbers, the plain version run over slices of rays (a plain
   [131072, 40008] f32 temporary would be 21 GB; PLAIN_ELEMENTS); timings
   with ``early_out`` on and off, the tests, sweeps and slab tests made
   (held against the counts of the kernels before their redesign:
   PARENT_WORK), brute-equivalent tests/s ``R * B * 2 * W * F / time`` and
   the bound; the sort keys the kernel leaves after every bounce equal
   ``morton_ray_keys`` of the state it leaves; one call under the
   profiler: its device kernels by kind (6 K8 launches, 5 sorts, no
   gather), ``prepare`` builds nothing, and the device-busy share;
8c. the 100,016-wall city: the same, its listener enclosed (an IR of
   zeros), then with a second listener in the open: ``early_out=False``
   bit-identical and K8 against its plain version at full shape;
8d. the 8-band 40,008-wall city through ``backend="auto"``: 6 K7
   launches (one per bounce, the rays re-sorted between them),
   ``early_out`` off bit-identical, K7 against its plain version at full
   shape, its sweeps those of the kernel before the redesign
   (PARENT_WORK), the highest band quieter than the lowest;
9. the stream on ``city_scene(2500)`` (10,008 walls) at the shipped audio
   settings (15,000 x 5, 48 kHz, 72,000 bins, 4,800-sample chunks): 20
   chunks of clicks + 15 tail chunks through K8 (5 launches per chunk, no
   K3/K4; ``prepare`` sorts the walls once for the whole stream), K8
   against its plain version at the stream's shape, the chunk time and
   the device-busy share of a chunk;
10. the hit-record path. 10a: K1 and K2 on both routes (the brute sweep
   and the box walk over ``prepare``'s sorted tables) against their plain
   versions on the rays of a real trace at 131,072 rays, bounce 0 and
   before bounce 3 (SmollRoom, Big Room, and the 10,008-, 40,008- and
   100,016-wall cities with two listeners; the plain versions over slices
   of rays), without and with ``alive`` and K2's ``limit``: distances,
   indices and minima equal; the box walk's ray keys equal
   ``morton_ray_keys``. 10a': ``engine.trace_hits`` on the 10,008-wall
   city with two listeners (counts reset and read: 5 box-walk launches of
   K1 and of K2, nothing else), its hits == the plain trace's. 10b:
   ``trace(use_kernels=True)`` against the plain trace at 15,000 x 5 and
   131,072 x 8, one and two listeners: ``valid`` equal, delays and
   energies equal under it, the debug paths of 100 rays equal. 10c: K5's
   rows equal the plain rows and its hits the plain hits; its rows binned
   in float against K3's IR within SAME_ENERGY / SAME_L1; reruns
   bit-identical; one launch per frame. 10d: K6 == K3 bit for bit (one and
   two listeners, and at 131,072 x 8), with a seed == K4, and against its
   plain version; one launch a call, counted as K6's and not as K3's or
   K4's. 10e: ``cli trace --room smoll`` at its defaults with
   every output, resumed with ``--ir-in`` (16 frames, held against a fresh
   16-frame run: energy within 2%), ``cli trace --room big``, ``--stereo``,
   ``cli bake`` and ``cli bake --legacy`` (twice: the same bytes) on a
   click clip, ``trace_accumulate_fused`` with and without
   ``exact_scatter``; the launch counts are reset before and read after
   each (K5 and K6 one launch a frame); the float scatters of the path
   rerun bit-identical;
11. directive sources and microphones, diffraction and air. 11a: each of
   K3, K4 (stream shape and 131,072 x 8 x 8), K9 (the 64-source mixdown,
   each source aimed its own way), K7 (the 8-band 4,808-wall city at full
   shape), K8 (the city stream's shape), K5 and K6 with a cardioid source
   (padded to C = 5) and a figure-eight microphone against its plain twin
   on the same numbers, within the limits of the phase that covers its
   omni form (K5 and K6 one launch each); K4 == K7 == K8 on a sorted city,
   directive; K6 == K3. 11b:
   omni-coded patterns ([1.]) through each directive kernel give the omni
   bits. 11c: registers and local bytes per thread
   (cudaFuncGetAttributes) of the omni kernels equal the parent's
   (PARENT_REGS), the directive ones printed, and the ptxas registers and
   spills of every one-band instantiation the parent built equal its
   (PARENT_PTXAS), K5's frame_rows_kernel printed beside K3's; in [5],
   each kernel's device time omni vs directive. 11d: the directive
   mixdown equals the sum of 64 single-source launches (E = 1, entry offset s; source 0's is K4 bit
   for bit). 11e: 2.0 s of clicks through ``Streamer.stream_clip`` on
   SmollRoom with an opaque barrier below the source, a cardioid source,
   an XY cardioid pair and a third listener in the barrier's shadow,
   diffraction order 1 and ISO 9613-1 air (counts reset and read: 35 K4
   and 35 K2 launches, one a chunk for all its visibility sweeps, and 35
   of each diffraction kernel, D3seg and D3bin) against
   its ``backend="plain"`` twin; diffraction
   adds energy in the shadow. 11f: ``diffraction_ir`` through its
   kernels equals its plain version bit for bit, orders 1 and 2 (one and
   two K2 launches, one of each diffraction kernel). 11g: ``cli trace`` and ``cli bake``
   with ``--directivity --stereo --stereo-aim --diffraction --air``, and
   ``cli bake --legacy`` with patterns, their launch counts;
12. bands, any listener count and batches past 5,280 walls. 12a: K3, K4
   and K9 at 8, 32 and 512 bands (the register buckets 8 and 32, and the
   scratch past them) against their plain twins on the same numbers, and
   K4 at the bench frame (131,072 x 8) at 8 and 32; a K-band scene whose
   bands all carry band 0's absorption gives K copies of the one-band IR
   bit for bit (K4; K7 against K8); K4 == K7 bit for bit on the sorted
   4,808-wall city at 8 and 32 bands; registers and local bytes of every
   bucket. 12b: ``Streamer.stream_clip`` on SmollRoom at 8 octave bands
   with ISO 9613-1 air per band, omni and with a cardioid source (35 K4
   launches each), against its ``backend="plain"`` twin, with its ms per
   chunk (median, p99). 12c: ``cli bake --bands 8`` (one K4 launch) and
   ``cli sweep --rooms 1024 --bands 8`` (one K9 launch, 2.2 GiB of f32
   IRs; the rooms' materials are broadband, so every band equals band 0
   bit for bit). 12d: a grid of 64 listeners on SmollRoom at 8 bands
   through ``trace_accumulate`` (one K4 launch) and on the 10,008-wall
   city through K8 and K7 (8 bands); where 16 fit a block (SmollRoom
   padded to 5,280 walls: ``trace_accumulate`` launches K4 4 times; the
   city with a ~3,600-coefficient microphone pattern), the 4 listener
   blocks == the calls on their slices of 16, bit for bit; K4 and K8
   against their plain twins. 12f: entry e of K8/K7
   draws entry e of K9 (bit for bit on the sorted 4,808-wall city);
   ``sweep_rooms`` over 8 copies of the 10,008-wall city with distinct
   listeners (8 K8 calls) and a 16-source ``trace_sources_mixdown`` in it
   (16 K8 calls, the scene sorted once) against single K8 calls with the
   same entry ids, bit for bit, and against the plain twin. 12e: the
   32-band 40,008-wall city through ``trace_accumulate(auto)`` (6 K7
   launches) as in 8d, at full shape against its plain version. [12t]:
   device times of K3, K4, K9 and K7 at 1, 8 and 32 bands, and of K4 and
   K8 with 64 listeners beside their bounds; K7 at 1, 8 and 32 bands on
   the 40,008-wall city and at the city stream's shape (8 bands) beside
   the times of the kernel it replaced (PARENT_K7_MS) and its bound; K3
   and K4 at the stream's shape and the 64-listener K4 call with lane
   groups of 1 and 4 beside the parent's (PARENT_K4_MS); K5 and K6 at
   15,000 x 5 and 131,072 x 8 (one frame, SmollRoom) beside the
   per-bounce step kernel they replaced (PARENT_K5_MS, PARENT_K6_MS) and
   their bounds;
13. spatial IRs and the binaural stream. 13a: the capture of SmollRoom at
   15,000 x 5 x 1 frame through K4 at orders 1 and 2 and at 8 bands, and
   through K3 on host uniforms, each microphone's row against the plain
   version on the same numbers (SAME_ENERGY / SAME_L1; one launch each).
   13b: 2.0 s of clicks through ``Streamer(binaural=True)`` with the head
   turning 0.5 rad/s (35 K4 launches): rerun bit-identical; against its
   ``backend="plain"`` twin, the decoded IRs within ``decode_limit`` (a
   float32 target bin rounded one spacing over) and the audio within what
   that IR gap explains; a degenerate head (radius 0, shadow 0) against
   the mono stream within the fixed-point limit of the two scales (S3 =
   S1 / 2 under the cardioids); 220 chunks each of the mono and binaural
   streams timed (median, p99), device-busy ms, cudaLaunchKernel calls and
   device kernels per chunk, and K4's device time at L = 3 directive
   against L = 1 omni. 13c: 3 chunks on the 10,008-wall city (15 K8
   launches), chunk 0's capture against the plain version, and the
   8-band city's capture through K7 (5 launches). 13d: ``cli bake
   --binaural 30``, ``trace --spatial-out``, ``stream --binaural 0
   --head-turn 90 --diffraction --duration 1`` (10 K4, 10 K2 and 10 of
   each diffraction kernel), ``analyze --edc-out`` and ``sweep --rooms 64
   --metrics-out``, each timed and its launches counted. 13e, 13f: the
   binaural decode and the tap kernels beside their chains. 13g: edge
   diffraction at the barrier cell's call (SampleScene, ``[1, 88,200,
   8]``, order 2): ``diffraction_ir`` == its card chain bit for bit at
   16 poses of the walk's circle; one ``add_diffraction`` call, counts
   reset just before, launches K2 twice and D3seg and D3bin once, makes
   no sync or copy, and equals the chain's bits in place; each kernel's
   device ms, bound and share, and its ptxas registers;
14. Doppler streams. 14a: 2.0 s of clicks through ``Streamer.stream_clip(
   doppler="per_arrival")`` with the source approaching at 2 m/s (35 K4
   launches): rerun bit-identical; against its ``backend="plain"`` twin,
   the tap tables equal chunk by chunk and the audio within
   ``per_arrival_limit`` (the residual gap through the convolution, the
   tap windows' gaps through the taps); the taps glide (the stream is not
   the one without Doppler). 14b: 4 chunks of the binaural x 8-band
   per-arrival stream (4 K4 launches) against its plain twin: tap tables
   equal, decoded residuals within ``decode_limit``, the audio within
   ``per_arrival_limit``. 14c: ``doppler=True`` on a 400 Hz tone, the
   source receding at 0.1 c: the peak at 360 Hz (400 without Doppler),
   the JAX test's check. 14d: 220 chunks each of the mono, per-arrival
   mono and per-arrival binaural streams timed (median, p99), device-busy
   ms, cudaLaunchKernel calls and device kernels per chunk. 14e: ``cli
   stream --doppler-per-arrival`` and ``cli stream --doppler`` with
   ``--move-source 2,0 --duration 1`` (10 K4 launches each), timed;
15. the live pipeline. 15a: the native library built by g++ into
   ``build/torch_native/``; its ring against a NumPy twin
   (``RingTwin``) over 200 push/drain pairs across the wrap, 2 channels,
   bit for bit; what ``mp3_probe`` and ``sink_probe`` find. 15b:
   integrity mode (``realtime=False``), counts reset before each run:
   2.0 s of clicks + the tail (35 chunks) through ``LivePlayer`` equal
   ``stream_clip`` of the same seed within 1e-6 (and say whether bit
   for bit), mono, the binaural head turning 0.5 rad/s and per-arrival
   Doppler (35 K4 launches each), and 10 chunks on the 10,008-wall city
   (50 K8 launches). 15c: realtime mode, 3 s each (prime 1), mono,
   binaural and per-arrival: mono must show no underrun after the
   prebuffer; each prints its realtime factor, the producer's step ms
   (p50, p99), peak lead, late samples, and per chunk
   ``cudaLaunchKernel`` calls, device kernels and busy ms (profiler, 10
   chunks). 15d: a writer thread appends a pose feed while an integrity
   run plays (a source move at chunk 5, a listener move at 8, Wall (4)
   dragged at 10, reset_ir at 12, stop at 20); the run equals
   ``stream_clip`` under a feed replayed from the finished file. 15e:
   ``cli live --duration 1`` (mono; ``--binaural 0 --doppler-per-arrival``),
   ``cli stream --pose-feed``, ``cli bake`` without ``--in`` (the bundled
   clip), ``cli stream --scene-json`` of SmollRoom exported by the phase
   (its walls equal SmollRoom's; its WAV equals ``cli live``'s), and
   ``cli live --play``, which plays or exits with the ALSA message;
16. differentiable acoustics. 16a: SmollRoom's d(sum IR)/d(absorption,
   scattering) at 15,000 x 5 x 72,000 bins finite and nonzero on the card
   and against the CPU's on the same Philox draws (value within 1e-2,
   gradients within 10% of the largest: a few razor-edge rays part the
   two: ROADMAP section 3, the plain trace on the CPU and on the card);
   the shoebox's absorption gradient against a central difference of
   the card's forward (rtol 5e-2, JAX's check); the blur on the card against the CPU at 72,000 bins (1e-7 of
   the largest: float64 sums, no TF32). 16b: ``fit_materials`` recovers
   the shoebox's absorption (0.12 -> 0.45 within 0.08, JAX's test), a
   rerun bit-identical. 16c: ``trace(use_kernels=True,
   transmission_surrogate=True)`` == the plain surrogate trace bit for bit
   (SmollRoom; the divider at t = 0.5), 5 launches of K1 and of K2 a
   call. 16d: ``cli trace --ir-out`` (one K4 launch) -> ``cli fit`` at
   its defaults (100 steps) -> ``cli locate`` (8 starts, 25 of the CLI's
   200 steps, cut for time), no hand kernel in the last two, their JSON
   keys. 16e: one ``fit_materials`` step at the CLI defaults, median and
   p99 over 30, its ``cudaLaunchKernel`` calls and device-busy ms
   (profiler), peak memory at 4 frames with and without ``remat``;
17. the device-mesh paths, each launch count read. 17a: ``make_mesh()``
   on the card (every CUDA device). 17b: ``sweep_rooms_sharded`` at
   ``cli sweep``'s defaults (1,024 rooms, 15,000 x 5 x 8 frames, 72,000
   bins) over 8 shards: 8 K9 launches, == ``sweep_rooms`` bit for bit
   and bit-identical on a rerun, both timed. 17c: 8 copies of the
   10,008-wall city over 2 shards (40 K8 launches) == the unsharded
   sweep. 17d: the 64-source stereo mixdown over a (1, 8) rooms x rays
   mesh (8 K9 launches) within 1e-6 of the peak of the unsharded one,
   both timed. 17e: ``accumulate_frames_sharded``, SmollRoom 131,072 x 8,
   8 frames over 8 shards (8 K4 launches, ``frame_offset`` d) against
   ``trace_accumulate(n_frames=8)`` within the fixed point (n / S +
   1e-6 of the value); K4 at ``frame_offset`` 0 keeps the parent's bits
   (PARENT_BITS), at 5 equals K3 on those frames' numbers and its plain
   version. 17f: ``trace_rays_sharded``, 131,072 rays over 8 shards:
   shard 0 == K4 at 16,384 rays, the sum == the 8 launches, a rerun and
   the ``uniforms=`` route (8 K3 launches) the same bits, 8 runs against
   K4 over 8 frames within phase 3's limits (the first arrival at 2% of
   the peak). 17g: ``convolve_seq_sharded``, 10 s at 48 kHz against a
   72,000-bin IR over 8 shards, within 1e-5 of the peak of
   ``convolve_fft``. 17h: ``localize_source(mesh=)``, 8 starts over 8
   shards == ``mesh=None`` start by start. 17i: ``cli sweep --rooms 64
   --sharded`` on a one-card host writes the npz of the run without the
   flag. 17j: ``profiling.device_trace`` around one K4 call writes a
   trace that names ``frames_ir_kernel``. 17k: a pytree checkpoint
   written and read back on the card. 17l: ``accumulate_frames_sharded``
   on the cities past 5,280 walls (``LARGE_FRAMES``): the 10,008-wall
   city at 15,000 x 5, 48 kHz, 72,000 bins, 8 frames over 8 shards (40
   K8 launches), the 40,008-wall city at 131,072 x 6, 16 kHz, 24,000
   bins, 4 frames over 4 shards through K8 and, at 8 bands, through K7
   (24 launches each), and their unsharded calls (5, 6, 6 launches):
   within n / S + 1e-6 of the value, no K3/K4 launched, the device time
   of each (every launch held); the unsharded calls keep PARENT_BITS; on
   the sorted 4,808-wall city K8 and K7 (K = 1), early_out on and off,
   at frame_offset 5 == K4 at frame_offset 5 bit for bit; K8 and the
   8-band K7 at frame_offset 5 against their plain twin (SAME_ENERGY /
   SAME_L1) on the 10,008-wall city at 15,000 x 5 x 1 frame;
18. the example twins (run after 5, last): each of ``examples/torch/``
   by its ``main(argv)`` in this process, in a temporary directory, at
   ``EXAMPLE_CUTS`` (the inverse twins' steps, starts and chunks cut,
   ``track_source`` left to ``scripts/torch_examples_phase.py --full``;
   the line lists the cuts), counts reset before and read after each: it
   returns 0 with its claims (asserts and thresholds of its JAX twin)
   holding, and launches exactly ``EXAMPLE_KERNELS`` (K4, K1/K2, K9,
   the diffraction kernels D3seg/D3bin;
   none for the four inverse twins, which differentiate the plain trace);
   its seconds and its claim line are printed;
19. the port's bench (run before 18): ``bench.main()`` in this process at
   the JAX sizes, its stdout captured (the bench's JSON line is not one
   of the smoke's): the line has exactly the JAX bench's four keys,
   ``value > 0`` and ``vs_baseline`` its value over 100e6 at 4
   significant figures; its stderr summary is printed on one ``[19]``
   line; counts reset before and read after: K4 140 (10 in the trace
   bench, 2 in the four-listener one, 32 in the stream chunk, 96 in its
   three modes), K8 48 (two cities, early-out off and on, two calls of 6
   bounces each), K9 2, nothing else; then (19b, not counted) the
   bench's launch shapes against their plain versions on the same seed
   (SAME_ENERGY / SAME_L1): K4 through ``trace_accumulate`` at 50 frames,
   131,072 x 8 and 15,000 x 5 with one listener and 15,000 x 5 with
   ``bench_quad``'s four, and K9 through ``sweep_rooms`` at
   ``bench_sweep``'s 1,024 rooms x 4,096 x 6 x 1 frame, 16 kHz, 24,000
   bins, rooms 0, 1, 511 and 1,023;
5. timings with CUDA events after a warm-up, device times from the
   profiler (every reading holds all the launches of its calls, one for
   K1-K6 and K9 and one a bounce for K7/K8, or is retried), and each
   kernel's bound (the larger of its bytes over 3.35
   TB/s and its FP32 operations over 67 TFLOP/s, the operations counted
   from the wall tests, wall sweeps and slab tests the kernel reports it
   made on these inputs). The counts keep one meaning whatever the
   kernels execute: a wall test is counted for a ray whose own box tests
   passed (whether the division-free filter or the exact test settled it,
   and whatever the other rays of its warp dragged it through), a slab
   test as the ray's own walk would make it. The kernels are built with
   ``--fmad=false``, so no multiply-add is contracted and their
   arithmetic can reach at most half of the FP32 peak the bound uses.

In the JSON line, K3 and K4 are timed at the stream's shape, K9 at the
mixdown's, K8 at the city stream's (15,000 x 5 x 1 frame, 10,008 walls)
and K7 at the banded city's (131,072 x 6 x 4 frames, 8 bands, 40,008
walls, 6 launches and 5 sorts a call; its plain time is that of the
comparison over slices of rays), so
that ``ms``, ``plain_ms`` and ``bound_ms`` are of one call; K8's
full-width times are in the [8] lines. K1 and K2 are timed on the rays
``cli trace --scene-out`` gives them (15,000 rays at bounce 3, 24 walls:
the brute sweep), K1b and K2b (their box walk) on 131,072 rays of the
10,008-wall city with two listeners before bounce 3, each as the trace
calls them (its alive rays, each shadow ray up to its listener), K5 and
K6 at one 15,000 x 5 frame; their times at 131,072 rays are in the [5]
and [12t] lines.

Prints one JSON line of kernels, the card line, and last the contract line
``{"ok": true, "device": {...}}``. Any failed check raises (exit code 1).
Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

import contextlib
import ctypes
import hashlib
import io
import json
import os
import re
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "realisticaudioraytracing2d_tpu_torch/csrc/bounce_kernel.cu"
ACCEL_SOURCE = "realisticaudioraytracing2d_tpu_torch/csrc/accel_kernel.cu"
SWEEP_SOURCE = "realisticaudioraytracing2d_tpu_torch/csrc/trace_kernel.cu"
PALLAS = "realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py"
PALLAS_SWEEPS = "realisticaudioraytracing2d_tpu/ops/pallas/trace_kernel.py"
SR, T, CHUNK = 48000, 72000, 4800           # the shipped SmollRoom audio
RAYS, BOUNCES = 15000, 5                     # the shipped SmollRoom trace
# bench.py's frame (131,072 x 8), at 8 frames in [3] (the bench's 50 in
# [19b])
BIG_RAYS, BIG_BOUNCES, BIG_FRAMES = 131072, 8, 8
SWEEP_ROOMS, SWEEP_FRAMES = 1024, 8             # cli sweep defaults, 1k rooms
N_SOURCES = 64                                   # BASELINE.json config #4
# bench.py:249-282 (bench_accel): the city at 131,072 rays x 6 bounces x 4
# frames, 16 kHz, 24,000 bins, input gain 100
CITY_BOUNCES, CITY_FRAMES, CITY_SR, CITY_T, CITY_GAIN = 6, 4, 16000, 24000, \
    100.0
# The cities' plain comparisons run at full shape over slices of rays (the
# rays are independent): a [131072, 40008] f32 temporary would take 21 GB,
# a slice keeps each [rays, listeners, walls] temporary at 1 GiB.
PLAIN_ELEMENTS = 1 << 28
DEVICE = "cuda"
# The card's published peaks (H100 SXM data sheet, at 700 W): FP32 outside
# the tensor cores and device-memory bandwidth. csrc/bounce_kernel.cu::
# wall_t is 16 FP32 operations (two of them divides), 3 of which, the
# ray's own cross product oy * dx - ox * dy, are the same for every wall
# of a sweep: 13 per wall test and 3 per sweep. csrc/accel_kernel.cu::
# slab_hit is 16 (4 subtractions, 4 multiplies, 7 min/max, 1 add;
# comparisons are not counted, as in wall_t).
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
OPS_PER_TEST, OPS_PER_SWEEP, OPS_PER_SLAB = 13, 3, 16
# Kernel vs plain on the same uniforms: relative total energy and per-bin
# L1 over the L1 norm. Both compute every hit in the same IEEE order, so
# only the summation differs (u64 fixed point vs float index_add_): the
# readings on an H100 were <= 7.4e-8 and <= 4.0e-8. The limits sit over
# 100x above them and below what a few hits of average energy moving to
# another bin or flipping validity would add (estimated ~3e-6 each).
SAME_ENERGY, SAME_L1 = 1e-5, 1e-5
# (wall tests, wall sweeps, slab tests) of the kernels before their
# redesign, at this script's seeds and shapes (scripts/
# torch_profile_ablate.py on the parent; NVIDIA H100 80GB HBM3). The
# counts are of the work each ray needs, so a redesign must not move them:
# K9's must be equal; K8's sweeps too, its tests and slab tests within
# WORK_TOLERANCE (each block orders the boxes from a centroid it sums in
# another order than torch.sum did, and near-ties may swap two boxes).
PARENT_WORK = {
    "sweep": (24634418322, 900952967, 0),
    "mixdown": (229654632, 9769042, 0),
    "[8b]": (502510022, 4183180, 778329724),
    "[8c]": (1116307395, 4080241, 900722562),
    "K8": (11022114, 104896, 10667717),
    # the all-bounces K7 the sorted one replaced (the same run as
    # PARENT_K7_MS): the same ray paths at every band count
    "[8d]": (1382343260, 4183180, 1221852587),
    "[12e]": (1382343260, 4183180, 1221852587)}
WORK_TOLERANCE = 0.01
# Registers and local (stack) bytes per thread of the omni one-band
# kernels before the directive flag was added (cudaFuncGetAttributes of
# the commit before it, built by this machine's nvcc for sm_90a; NVIDIA
# H100 80GB HBM3): the later designs must leave them as they were. K3/K4/
# K9's entries are the lane group G = 1; K7 is the banded instantiations
# of K8's kernel, new code with no earlier build to hold, so K8's entry
# covers its one-band instantiation, which K7 at K = 1 launches. K5's and
# K6's per-bounce step kernel went with its template: K6 launches K3's or
# K4's instantiation, and K5's frame_rows_kernel is new code ([11c]
# prints it beside K3's).
PARENT_REGS = {"K3": (64, 48), "K4": (64, 64), "K9": (64, 64),
               "K8": (48, 120)}
# Registers, spill stores and spill loads (bytes) of every one-band
# instantiation that the commit before the K7 / lane-group redesign built
# (its ptxas lines from scripts/torch_redesign_k7_k4.py --parent on
# NVIDIA H100 80GB HBM3), under this build's names: K3/K4/K9 at G = 1
# (frames_ir_kernel<host, directive, 1, 1>; the parent's <host, directive,
# 1>), K8 (accel_bounce_kernel<1, early_out, directive>; the parent's
# <early_out, directive>). The redesign must leave each as it was. The
# lines of the per-bounce step kernel (bounce_step_kernel<rows, host,
# directive>) went with its template. K1/K2's entries are those of their
# redesign's own build (on the same card): the brute sweep at one lane a
# ray and in lane groups of 4 (wall_sweep_kernel<want_index, lanes>), the
# box walk (box_sweep_kernel<want_index>) and its key kernel; the template
# before it (wall_sweep_kernel<want_index>) had 38 registers and no
# spills.
PARENT_PTXAS = {
    "frames_ir_kernel<0,0,1,1>": (64, 28, 32),
    "frames_ir_kernel<0,1,1,1>": (78, 0, 0),
    "frames_ir_kernel<1,0,1,1>": (64, 16, 20),
    "frames_ir_kernel<1,1,1,1>": (77, 0, 0),
    "accel_bounce_kernel<1,0,0>": (64, 12, 16),
    "accel_bounce_kernel<1,0,1>": (80, 0, 0),
    "accel_bounce_kernel<1,1,0>": (48, 120, 184),
    "accel_bounce_kernel<1,1,1>": (64, 96, 156),
    "wall_sweep_kernel<0,1>": (38, 0, 0),
    "wall_sweep_kernel<1,1>": (40, 0, 0),
    "wall_sweep_kernel<0,4>": (39, 0, 0),
    "wall_sweep_kernel<1,4>": (40, 0, 0),
    "box_sweep_kernel<0>": (48, 0, 0),
    "box_sweep_kernel<1>": (48, 0, 0),
    "ray_keys_kernel": (17, 0, 0)}
# Device ms per call of the kernels the sorted K7 and the lane groups of
# K3/K4 replaced, on NVIDIA H100 80GB HBM3, 700.00 W
# (scripts/torch_redesign_k7_k4.py --parent, the mean of its two parent
# runs): the all-bounces K7 at this script's K7 shapes (seed 5), K3/K4
# before lane groups.
PARENT_K7_MS = {"40,008 walls K=1": 30.5659, "40,008 walls K=8": 28.9250,
                "40,008 walls K=32": 29.5611,
                "city stream 15k x 5 x 1, K=8": 1.8062}
PARENT_K4_MS = {"K4 15k x 5 x 1": 0.0322, "K3 15k x 5 x 1": 0.0330,
                "K4 64 listeners K=8": 0.9840}
# Device ms per call of the per-bounce step kernel that K5 and K6 replaced
# (one launch per bounce, the ray state in device memory between them), on
# NVIDIA H100 80GB HBM3, 700.00 W (scripts/torch_redesign_k5_k6.py
# --parent, the mean of its two parent runs): one SmollRoom frame with
# host uniforms.
PARENT_K5_MS = {"15k x 5": 0.0401, "131k x 8": 0.1294}
PARENT_K6_MS = {"15k x 5": 0.0437, "131k x 8": 0.1311}
# sha256 (first 16 hex digits) of the f32 bytes of K4's and K9's IRs built
# by the commit before K4 took a frame offset, on NVIDIA H100 80GB HBM3,
# 700.00 W: SmollRoom at 48 kHz, 72,000 bins, seed 42 over 15,000 x 5 x 2
# frames and seed 2024 over 131,072 x 8 x 8, and the 256-room sweep of
# random_rooms(256, seed=0) at 15,000 x 5 x 8 (seed 0). K4 at
# frame_offset 0 and K9 must keep them.
# The last three: K8's and the 8-band K7's unsharded calls of [17l]
# (LARGE_FRAMES), built by the commit before the cluster kernels took a
# frame offset (scripts/torch_accel_frame_bits.py --root on its checkout;
# NVIDIA H100 80GB HBM3, 700.00 W): K7 and K8 at frame_offset 0 must
# keep them.
PARENT_BITS = {"K4 15k x 5 x 2 seed 42": "2da62d18303cafd5",
               "K4 131k x 8 x 8 seed 2024": "80a38d109abbb197",
               "K9 256 rooms x 8": "d7be775f27ed4d09",
               "K8 10,008 walls 15k x 5 x 8 seed 2024": "489b75a49a4ed1fa",
               "K8 40,008 walls 131k x 6 x 4 seed 2025": "ddceaaf776626875",
               "K7 8-band 40,008 walls 131k x 6 x 4 seed 2026":
                   "c5a81a5a93c444c6"}
# [17l]: the frame-sharded runs of the cities past 5,280 walls, by the
# PARENT_BITS name of their unsharded call: city_scene boxes, bands, rays,
# bounces, frames (= shards, one frame each but the 10,008-wall city's
# 8), sample rate, bins, seed. The first is the city stream's shape (K8),
# the others the JAX bench's large-scene shape ([8b], [8d]).
LARGE_FRAMES = {
    "K8 10,008 walls 15k x 5 x 8 seed 2024":
        (2500, 1, RAYS, BOUNCES, 8, SR, T, 2024),
    "K8 40,008 walls 131k x 6 x 4 seed 2025":
        (10000, 1, BIG_RAYS, CITY_BOUNCES, 4, CITY_SR, CITY_T, 2025),
    "K7 8-band 40,008 walls 131k x 6 x 4 seed 2026":
        (10000, 8, BIG_RAYS, CITY_BOUNCES, 4, CITY_SR, CITY_T, 2026)}
FMAD_NOTE = ("at the 67 TFLOP/s peak; the build's --fmad=false contracts no "
             "multiply-add, so at most half of it is reachable")


class BoxWalkCount:
    """A wall sweep's box-walk launches (``.box_launches``) under the name
    every other wrapper counts in, ``.launches``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.box_launches

    @launches.setter
    def launches(self, n):
        self.fn.box_launches = n


def launch_counters():
    """The kernels' wrappers by name, and two helpers on their launch
    counts: ``only(**n)``, the counts of a run that launched only ``n``,
    and ``counted(run)``, which runs one path and returns its result with
    the launches of that run alone (every count set to 0 just before,
    read just after). K1 and K2 count by route: brute force in
    ``.launches``, the box walk in ``.box_launches`` (K1b, K2b). D3seg and
    D3bin are the diffraction kernels (``diffraction_segments_kernel``,
    ``diffraction_bin_kernel``)."""
    import torch
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import (
        accel_kernel as ak, bounce_kernel as bk, diffraction_kernel as dk,
        trace_kernel as tk)
    wrappers = {"K3": bk.trace_frames_ir_whole, "K4": bk.trace_frames_ir_mega,
                "K9": bk.trace_rooms_ir_mega, "K7": ak.trace_frames_ir_accel,
                "K8": ak.trace_frames_ir_accel_sorted, "K1": tk.nearest_hit,
                "K2": tk.occlusion_min, "K5": bk.trace_fused_rows,
                "K6": bk.trace_frame_ir_fused,
                "K1b": BoxWalkCount(tk.nearest_hit),
                "K2b": BoxWalkCount(tk.occlusion_min),
                "D3seg": dk.segments, "D3bin": dk.bin_paths}

    def only(**n):
        return {k: n.get(k, 0) for k in wrappers}

    def counted(run):
        for fn in wrappers.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {k: fn.launches for k, fn in wrappers.items()}

    return wrappers, only, counted


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed with
    CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, fn, reps, name, launches):
    """Device time per call of ``fn`` of the kernels whose name holds
    ``name``, over ``reps`` calls, from the profiler's CUDA events; None
    if no reading in ten tries holds all of the calls' launches. The
    wrapper's own small launches are left out. ``launches`` is the
    kernel's launches a call (one for K1-K6 and K9, one a bounce for
    K7/K8): a reading that holds another number is dropped and retried,
    since the profiler now and then misses a launch and such a reading
    would read low. Late in the smoke, sessions have lost one launch of
    the kernel in every try, ten running, where the same calls alone
    lost none, for a cause not found. As a workaround the timed calls sit
    between two markers (``torch.cuda._sleep``'s ``spin_kernel``, a
    private PyTorch call), with one untimed call before the first and
    one after the second, and only the launches between the markers
    count; every one of them is still required. Prints the counts of a
    reading it gives up on."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.01)
            fn()                                 # edge: not timed
            torch.cuda._sleep(1000)              # marker
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)              # marker
            fn()                                 # edge: not timed
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = sorted(e.time_range.start for e in events
                       if "spin_kernel" in e.name)
        us = [] if len(marks) != 2 else [
            e.time_range.elapsed_us() for e in events
            if name in e.name and marks[0] < e.time_range.start < marks[1]]
        if len(us) == launches * reps:
            return sum(us) / reps / 1e3
        seen.append((len(us), len(marks)))
    print(f"    ({name}: no reading held {launches * reps} launches; "
          f"(launches, markers) seen {seen})", flush=True)
    return None


def check_work(tag, got, want, exact):
    """Hold one call's work counts against the parent's."""
    if exact:
        check(tuple(got) == tuple(want), f"{tag}: work {got} == {want}")
        return
    check(got[1] == want[1], f"{tag}: sweeps {got[1]} == {want[1]}")
    for g, w in zip(got, want):
        check(abs(g - w) <= WORK_TOLERANCE * w,
              f"{tag}: work {got} within {WORK_TOLERANCE} of {want}")


def profiler_lead_in(torch, n=64):
    """50 ms of host time and ``n`` short spin kernels (``spin_kernel``)
    first in a profiled window: late in a long process (this smoke by
    phase 17) the profiler has dropped the device events of the first
    launches of a session (all of a K4 call's, with 8 spin kernels and
    the sleep before it; the parent's K4 call, 28 launches, kept its
    last), and the lead-in takes the loss, as ``kernel_device_ms``'s
    sleep and edge call do. Leave out ``spin_kernel`` when counting a
    window's kernels."""
    torch.cuda.synchronize()
    time.sleep(0.05)
    for _ in range(n):
        torch.cuda._sleep(1000)


def busy_share(torch, fn, call_ms):
    """One call of ``fn`` under the profiler: (device-busy ms, its share
    of ``call_ms``, the unprofiled time of a call, and the device kernels'
    names)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return busy, busy / call_ms, [e.name for e in events]


def rows_bytes(n_walls, n_rays, n_bounces):
    """The bytes K5 must move, each once: its wall table [11, W], the
    listener and the scalars in, its host uniforms emit [R] and u [B, R, 3]
    in, and its f32 rows [B, 8, R] out."""
    return 4 * (11 * n_walls + 2 + 5 + n_rays * (1 + 3 * n_bounces)
                + 8 * n_rays * n_bounces)


def bound(counts, n_bytes):
    """The least time (ms) the card could take: operations (from
    ``counts`` = (wall tests, wall sweeps, slab tests)) over the FP32 peak
    or bytes over the memory rate, whichever is larger."""
    n_tests, n_sweeps, n_slabs = counts
    ops_ms = (n_tests * OPS_PER_TEST + n_sweeps * OPS_PER_SWEEP
              + n_slabs * OPS_PER_SLAB) / PEAK_FP32 * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def free_spot(scene, near):
    """The point of a 1 m grid around ``near`` (``[2]`` on the scene's
    device) nearest to it that lies inside no box of a city: rays from it
    in two directions each cross an odd number of walls (the border once,
    each box they leave or pass twice)."""
    import torch
    from realisticaudioraytracing2d_tpu_torch.ops.geometry import \
        pairwise_ray_segment_t
    offsets = torch.tensor([[dx, dy] for dx in range(-10, 11)
                            for dy in range(-10, 11)],
                           dtype=torch.float32, device=near.device)
    pts = near[None] + offsets
    free = torch.ones(len(pts), dtype=torch.bool, device=near.device)
    for d in ((1.0, 1e-4), (-1e-4, 1.0)):
        dirs = pts.new_tensor([d]).expand_as(pts)
        hits = (pairwise_ray_segment_t(pts, dirs, scene.a, scene.b)
                < 1e8).sum(-1)
        free &= hits % 2 == 1
    check(bool(free.any()), "a free spot near the source")
    dist = torch.where(free, (offsets ** 2).sum(-1), float("inf"))
    return pts[int(torch.argmin(dist))]


def read_png(path):
    """Decode a PNG as the port writes it (8-bit RGB, filter 0, one IDAT
    chunk) into ``[H, W, 3]`` uint8."""
    with open(path, "rb") as f:
        raw = f.read()
    check(raw[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: PNG signature")
    w, h, depth, color = struct.unpack(">IIBB", raw[16:26])
    n = struct.unpack(">I", raw[33:37])[0]
    check((depth, color) == (8, 2) and raw[37:41] == b"IDAT",
          f"{path}: 8-bit RGB, one IDAT")
    rows = np.frombuffer(zlib.decompress(raw[41:41 + n]), np.uint8
                         ).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def kernel_base(mangled):
    """The kernel's own name in a mangled one: the last length-prefixed
    identifier that ends in ``_kernel`` (an anonymous namespace's prefix
    holds the file's name first, and a hash whose digits may run into the
    length), or the mangled name where there is none."""
    names = []
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            ident = mangled[m.end():m.end() + int(digits[i:])]
            if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", ident):
                names.append(ident)
                break
    return names[-1] if names else mangled


def ptxas_table(log):
    """{kernel<template args>: (registers, spill stores, spill loads)} of
    each kernel instantiation of the build log (frames_ir_kernel<host,
    directive, K, lanes>, K = 0: the scratch instantiation)."""
    out = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            args = re.findall(r"L([bi])(\d+)E", mangled)
            name = kernel_base(mangled) + (
                "<" + ",".join(v for _, v in args) + ">" if args else "")
        elif name and "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln)
            out[name] = [None, int(spill.group(1)), int(spill.group(2))]
        elif name and "Used" in ln and "registers" in ln \
                and out.get(name, [0])[0] is None:
            out[name][0] = int(re.search(r"Used (\d+) registers",
                                         ln).group(1))
    return {k: tuple(v) for k, v in out.items()}


def ptxas_lines(log):
    """One entry per kernel instantiation of the build log: its name with
    its template arguments, registers and spill bytes."""
    return [f"{n} {r} regs, spill {st}/{ld} B"
            for n, (r, st, ld) in ptxas_table(log).items()]


def device_kernels(torch, fn):
    """The names of the device events of one profiled call of ``fn``
    (after a warm call; the lead-in's spin kernels left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_lead_in(torch)
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


def k4_args_phase(c):
    """Phase 4b: the argument kernel of K3/K4/K6 (``bk.k4_args``) against
    its plain twin (``bk.k4_args_plain``, the chain of
    ``pack_walls_banded``, ``pack_scalars`` and ``fixed_point_scale``)
    bit for bit, one launch a call, and both sides' device time at the
    stream's shape. ``c`` holds the objects of main()."""
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
    torch, art, bk, dev = (c[k] for k in ("torch", "art", "bk", "dev"))
    smoll, smoll_p = c["smoll"], c["smoll_p"]

    def bits(x):
        return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                                   else torch.int32)

    rng_np = np.random.default_rng(22)
    cases = 0
    for n_bands, n_l, directive in ((1, 1, False), (8, 64, False),
                                    (1, 3, True), (8, 4, True)):
        room = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        scene = room.scene._replace(absorption=torch.as_tensor(
            rng_np.uniform(0, 1, (room.scene.n_walls, n_bands)).astype(
                np.float32), device=dev))
        lis = (np.asarray(room.source, np.float32)
               + rng_np.uniform(-6, 6, (n_l, 2))).astype(np.float32)
        p = art.TraceParams.make(
            room.source, lis, directivity=dv.cardioid(-0.9) if directive
            else None, mic_directivity=dv.figure_eight(0.3) if directive
            else None, device=dev)
        for shape in ((1, RAYS, BOUNCES), (BIG_FRAMES, BIG_RAYS,
                                           BIG_BOUNCES)):
            before = bk.k4_args.launches
            got = bk.k4_args(scene, p, *shape)
            want = bk.k4_args_plain(scene, p, *shape)
            torch.cuda.synchronize()
            check(bk.k4_args.launches == before + 1,
                  f"4b: one argument launch a call, K={n_bands} L={n_l}")
            check(all(torch.equal(bits(g), bits(w))
                      for g, w in zip(got, want)),
                  f"4b: k4_args == k4_args_plain bit for bit, K={n_bands} "
                  f"L={n_l} directive={directive} shape={shape}")
            cases += 1

    shape = (1, RAYS, BOUNCES)
    kernel = lambda: bk.k4_args(smoll.scene, smoll_p, *shape)  # noqa: E731
    chain = lambda: bk.k4_args_plain(smoll.scene, smoll_p, *shape)  # noqa
    n_kernel = len(device_kernels(torch, kernel))
    n_chain = len(device_kernels(torch, chain))
    ms_kernel = kernel_device_ms(torch, kernel, 50, "k4_args_kernel", 1)
    ms_chain = kernel_device_ms(torch, chain, 50, "", n_chain)
    lib = c["build"].load_library()
    out = (ctypes.c_int * 2)()
    check(lib.art_k4_args_attributes(out) == 0, "4b: attributes")
    line = ptxas_table(c["build"].build_log()).get("k4_args_kernel")
    print(f"[4b] k4_args == k4_args_plain bit for bit in {cases} cases "
          f"(1 and 8 bands, 1-64 listeners, omni and directive, the "
          f"stream's and the bench's shapes), one launch a call; at the "
          f"stream's shape the kernel makes {n_kernel} device launch "
          f"({ms_kernel} ms of device time a call), the chain {n_chain} "
          f"({ms_chain} ms); registers / local bytes {out[0]} / {out[1]} B, "
          f"ptxas (registers, spill stores, spill loads) {line}",
          flush=True)
    check(n_kernel == 1, f"4b: the kernel alone on the card ({n_kernel})")
    check(line is not None, "4b: k4_args_kernel in the build log")


def bands_phase(c):
    """Phase 12a-12c: frequency bands through K3, K4, K9 and K7, the banded
    stream and the banded CLI, at full width. ``c`` holds the objects of
    main(). Returns the launch counts of its paths and its readings."""
    torch, art, bk, ak, rng, cli = (c[k] for k in (
        "torch", "art", "bk", "ak", "rng", "cli"))
    dev, counted, only, same_numbers = (c[k] for k in (
        "dev", "counted", "only", "same_numbers"))
    from realisticaudioraytracing2d_tpu_torch.ops import air
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import \
        click_clip, write_wav
    kw = dict(sample_rate=SR, ir_length=T)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, **kw)
    city_run = dict(n_rays=BIG_RAYS, max_bounces=CITY_BOUNCES,
                    sample_rate=CITY_SR, ir_length=CITY_T)
    slice_launches = {k: 0 for k in ("K3", "K4", "K9", "K7", "K8")}
    readings = {}

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    def smoll(n_bands, listeners=None):
        room = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        return room.scene, art.TraceParams.make(
            room.source, room.listener if listeners is None else listeners,
            device=dev)

    def city(n_boxes, n_bands=1):
        return city_setup(art, dev, n_boxes, n_bands)

    # 12a. K3, K4 and K9 at 8, 32 and 512 bands against their plain twins
    # on the same numbers; registers and spills of every bucket
    gen = torch.Generator(device=dev).manual_seed(12)
    host = rng.bounce_uniforms(gen, 1, BOUNCES, RAYS, dev)
    for n_bands in (8, 32, 512):
        sc, p = smoll(n_bands)
        same_numbers(f"[12a] K3 vs plain K={n_bands}, {RAYS} x {BOUNCES} x 1"
                     " frame", "K3",
                     bk.trace_frames_ir_whole(sc, p, *host, **kw),
                     bk.trace_frames_ir_plain(sc, p, *host, **kw))
        same_numbers(f"[12a] K4 vs plain K={n_bands}, {RAYS} x {BOUNCES} x 2"
                     " frames", "K4",
                     bk.trace_frames_ir_mega(sc, p, 21, 2, **one),
                     bk.trace_frames_ir_mega_plain(sc, p, 21, 2, **one))
        scenes, src, lis = art.rooms.random_rooms(4, seed=12, n_bands=n_bands,
                                                  device=dev)
        k9 = bk.trace_rooms_ir_mega(scenes, src, lis, 22, 2, entry_offset=100,
                                    **one)
        plain9 = bk.trace_rooms_ir_mega_plain(scenes, src, lis, 22, 2,
                                              entry_offset=100, **one)
        for e in range(4):
            if float(plain9[e].sum()) > 0:
                same_numbers(f"[12a] K9 vs plain K={n_bands}, room {e} of 4,"
                             f" {RAYS} x {BOUNCES} x 2 frames", "K9",
                             k9[e], plain9[e])
        del k9, plain9
    # the bench frame (131,072 x 8) at 8 and 32 bands through K4
    for n_bands in (8, 32):
        sc, p = smoll(n_bands)
        big = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES, **kw)
        same_numbers(f"[12a] K4 vs plain K={n_bands}, the bench frame "
                     f"{BIG_RAYS} x {BIG_BOUNCES} x 2 frames", "K4",
                     bk.trace_frames_ir_mega(sc, p, 26, 2, **big),
                     bk.trace_frames_ir_mega_plain(sc, p, 26, 2, **big))
    # equal bands: K copies of the one-band bits (K4; K7 against K8)
    sc1, p1 = smoll(1)
    ir1 = bk.trace_frames_ir_mega(sc1, p1, 23, 2, **one)
    city1, pc1 = city(1200)
    k8_1 = ak.trace_frames_ir_accel_sorted(city1, pc1, 23, CITY_FRAMES,
                                           **city_run)
    equal = {}
    for n_bands in (8, 32, 40):
        same = sc1._replace(absorption=sc1.absorption.expand(
            -1, n_bands).contiguous())
        irk = bk.trace_frames_ir_mega(same, p1, 23, 2, **one)
        csame = city1._replace(absorption=city1.absorption.expand(
            -1, n_bands).contiguous())
        k7k = ak.trace_frames_ir_accel(csame, pc1, 23, CITY_FRAMES,
                                       **city_run)
        torch.cuda.synchronize()
        equal[f"K4 K={n_bands}"] = all(torch.equal(irk[..., k], ir1[..., 0])
                                       for k in range(n_bands))
        equal[f"K7 K={n_bands} vs K8"] = all(
            torch.equal(k7k[..., k], k8_1[..., 0]) for k in range(n_bands))
    print(f"[12a] a K-band scene whose bands all carry band 0's absorption "
          f"== K copies of the one-band IR, bit for bit: {equal}",
          flush=True)
    check(all(equal.values()) and float(ir1.sum()) > 0
          and float(k8_1.sum()) > 0, "12a: equal bands == one band")
    del ir1, k8_1, irk, k7k
    # K4 == K7 bit for bit on the sorted 4,808-wall banded city
    for n_bands in (8, 32):
        cb, pb = city(1200, n_bands)
        sorted_b = ak.prepare(cb).scene
        k4b = bk.trace_frames_ir_mega(sorted_b, pb, 24, CITY_FRAMES,
                                      **city_run)
        k7b = ak.trace_frames_ir_accel(cb, pb, 24, CITY_FRAMES, **city_run)
        torch.cuda.synchronize()
        ok = torch.equal(k4b, k7b)
        print(f"[12a] sorted city_scene(1200), {sorted_b.n_walls} walls, "
              f"K={n_bands}, {BIG_RAYS} x {CITY_BOUNCES} x {CITY_FRAMES} "
              f"frames: K4 == K7 bit for bit: {ok}; energy of band 0 / "
              f"{n_bands - 1}: {float(k4b[..., 0].sum()):.4e} / "
              f"{float(k4b[..., -1].sum()):.4e}", flush=True)
        check(ok and float(k4b[..., -1].sum()) > 0, "12a: K4 == K7 banded")
        del k4b, k7b
    lib = c["build"].load_library()
    regs = {}
    for kname, fn_name, lead in (
            ("K3", "art_frames_attributes", (1,)),
            ("K4/K9", "art_frames_attributes", (0,)),
            ("K7", "art_accel_attributes", ())):
        for n_bands in (1, 8, 32, 512):
            for d in (0, 1):
                out = (ctypes.c_int * 2)()
                args = (lead + (n_bands, d) if kname != "K7"
                        else lead + (n_bands, 1, d))
                check(getattr(lib, fn_name)(*args, out) == 0,
                      f"12a: {fn_name}{args}")
                regs[kname, n_bands, d] = (out[0], out[1])
    print("[12a] registers / local bytes per thread by band bucket (K = 512 "
          "is the scratch instantiation, and so is K7's K = 32, K7's K = 1 "
          "K8's kernel), omni | directive: " + "; ".join(
              f"{k} K={n}: {regs[k, n, 0][0]}/{regs[k, n, 0][1]} B | "
              f"{regs[k, n, 1][0]}/{regs[k, n, 1][1]} B"
              for k in ("K3", "K4/K9", "K7") for n in (1, 8, 32, 512)),
          flush=True)
    readings["regs"] = regs

    # 12b. the banded stream: SmollRoom, 8 octave bands, air per band; and
    # the same with a cardioid source (kDirective x bands)
    clicks = (0.1, 0.7, 1.3)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=clicks),
                          device=dev)
    n_chunks = 20 + 15
    sc8, p8 = smoll(8)
    cfg8 = art.smoll_room_config(n_bands=8, ray_count=RAYS)
    alpha8 = air.iso9613_alpha(air.band_frequencies(8))
    cardioid = np.pad(dv.cardioid(0.7), (0, 2))
    for name, pp in (("omni", p8), ("cardioid source", p8._replace(
            directivity=torch.as_tensor(cardioid, dtype=torch.float32,
                                        device=dev)))):
        chunk_ms = []
        t_last = [0.0]

        def tick(i, st):
            torch.cuda.synchronize()
            now = time.perf_counter()
            chunk_ms.append((now - t_last[0]) * 1e3)
            t_last[0] = now

        def stream(backend, on_chunk=None):
            streamer = art.Streamer(sc8, cfg8, seed=17, air_alpha=alpha8,
                                    backend=backend)
            t_last[0] = time.perf_counter()
            return streamer.stream_clip(dry, lambda i: pp, on_chunk=on_chunk)

        wet, launched = counted(lambda: stream("auto", tick))
        check(launched == only(K4=n_chunks),
              f"12b: banded stream launches {launched}")
        add(launched)
        wet_plain, launched_p = counted(lambda: stream("plain"))
        check(launched_p == only(), f"12b: plain twin launched {launched_p}")
        out, out_p = wet.cpu().numpy(), wet_plain.cpu().numpy()
        gap = float(np.abs(out - out_p).max())
        steady = np.asarray(chunk_ms[1:])
        print(f"[12b] banded stream ({name}): SmollRoom K=8 (octaves "
              f"{air.band_frequencies(8)[0]:.0f}-"
              f"{air.band_frequencies(8)[-1]:.0f} Hz), air per band, "
              f"{n_chunks} chunks -> {out.shape}, launches {launched}; vs its"
              f" plain twin: max abs {gap:.3e} of peak "
              f"{np.abs(out_p).max():.3e}; ms per 100 ms chunk (synced, "
              f"chunks 1..): median {np.median(steady):.3f}, p99 "
              f"{np.percentile(steady, 99):.3f}", flush=True)
        check(out.shape == (1, n_chunks * CHUNK) and np.isfinite(out).all()
              and np.abs(out).max() > 0, "12b: stream finite, peak > 0")
        check(np.allclose(out, out_p, rtol=1e-4,
                          atol=1e-6 * np.abs(out_p).max()),
              "12b: banded stream == its plain twin")
        readings[f"stream {name}"] = (float(np.median(steady)),
                                      float(np.percentile(steady, 99)))

    # 12c. the CLI: bake --bands 8 and sweep --rooms 1024 --bands 8
    with tempfile.TemporaryDirectory() as tmp:
        dry_wav, wet_wav = (os.path.join(tmp, n) for n in ("d.wav", "w.wav"))
        write_wav(dry_wav, click_clip(1.0, 44100, click_times=(0.1, 0.6)),
                  44100)
        t0 = time.perf_counter()
        _, baked = counted(lambda: cli.main(
            ["bake", "--room", "smoll", "--bands", "8", "--in", dry_wav,
             "--out", wet_wav]))
        secs_b = time.perf_counter() - t0
        check(baked == only(K4=1), f"12c: cli bake --bands 8 launches "
              f"{baked}")
        add(baked)
        path = os.path.join(tmp, "irs.npz")
        t0 = time.perf_counter()
        _, swept = counted(lambda: cli.main(
            ["sweep", "--rooms", str(SWEEP_ROOMS), "--bands", "8", "--out",
             path]))
        secs_s = time.perf_counter() - t0
        check(swept == only(K9=1), f"12c: cli sweep --bands 8 launches "
              f"{swept}")
        add(swept)
        with np.load(path) as npz:
            irs = npz["irs"]
        check(irs.shape == (SWEEP_ROOMS, 1, T, 8) and np.isfinite(irs).all()
              and (irs.reshape(SWEEP_ROOMS, -1).sum(-1) > 0).mean() > 0.9,
              f"12c: sweep npz {irs.shape}")
        # random_rooms' materials are broadband, so every band of a room
        # carries band 0's IR: the equal-bands oracle at full width
        copies = all(np.array_equal(irs[..., k], irs[..., 0])
                     for k in range(1, 8))
        print(f"[12c] cli bake --room smoll --bands 8: {secs_b:.2f} s, "
              f"launches {baked}; cli sweep --rooms {SWEEP_ROOMS} --bands 8: "
              f"{secs_s:.2f} s, launches {swept}, irs {irs.shape} "
              f"({irs.nbytes / 2 ** 30:.2f} GiB f32); the rooms' materials "
              f"are broadband: the 8 bands of every room equal band 0 bit "
              f"for bit: {copies}", flush=True)
        check(copies, "12c: broadband rooms give equal bands")
        del irs

    return slice_launches, readings


def listeners_batches_phase(c):
    """Phase 12d and 12f: 64 listeners through K4, K8 and K7, and batches
    of scenes past 5,280 walls through K8 (see bands_phase). Returns the
    launch counts and the readings of the 64-listener runs."""
    torch, art, bk, ak = (c[k] for k in ("torch", "art", "bk", "ak"))
    dev, counted, only, same_numbers = (c[k] for k in (
        "dev", "counted", "only", "same_numbers"))
    Scene = c["Scene"]
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
    from realisticaudioraytracing2d_tpu_torch.parallel.multisource import \
        trace_sources_mixdown
    from realisticaudioraytracing2d_tpu_torch.parallel.sweep import \
        sweep_rooms
    kw = dict(sample_rate=SR, ir_length=T)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, **kw)
    city_run = dict(n_rays=BIG_RAYS, max_bounces=CITY_BOUNCES,
                    sample_rate=CITY_SR, ir_length=CITY_T)
    slice_launches = {k: 0 for k in ("K3", "K4", "K9", "K7", "K8")}
    readings = {}

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    def smoll(n_bands, listeners):
        room = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        return room.scene, art.TraceParams.make(room.source, listeners,
                                                device=dev)

    def city(n_boxes, n_bands=1):
        return city_setup(art, dev, n_boxes, n_bands)

    # 12d. many listeners: a grid of 64 on SmollRoom at K = 8 through K4
    # (one launch), and on the 10,008-wall city through K8 / K7. Where a
    # block's shared memory holds 16 of them (SmollRoom padded to the
    # 5,280-wall limit; the city with a microphone pattern of ~3,600
    # coefficients), the call runs 4 blocks and equals the calls on each
    # block's slice of listeners bit for bit
    grid = torch.stack(torch.meshgrid(torch.linspace(-16, 16, 8),
                                      torch.linspace(-4, 7, 8),
                                      indexing="ij"), -1).reshape(-1, 2)
    sc64, p64 = smoll(8, grid.to(dev))
    st64, launched = counted(lambda: art.trace_accumulate(
        sc64, p64, art.IRState.zeros(T, 64, 8, device=dev), n_frames=1,
        seed=31, n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR))
    check(launched == only(K4=1), f"12d: 64 listeners launches {launched}")
    add(launched)
    ir64 = st64.sum
    same_numbers("[12d] K4 64 listeners K=8 vs plain, 15k x 5 x 1 frame",
                 "K4", ir64, bk.trace_frames_ir_mega_plain(sc64, p64, 31, 1,
                                                           **one))
    heard = int((ir64.sum((1, 2)) > 0).sum())
    padded = sc64.pad_to(bk.MAX_WALLS)
    check(bk.listener_block(padded.n_walls) == 16, "12d: 16 listeners "
          "fit beside 5,280 walls")
    st_pad, launched = counted(lambda: art.trace_accumulate(
        padded, p64, art.IRState.zeros(T, 64, 8, device=dev), n_frames=1,
        seed=31, n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR))
    check(launched == only(K4=4), f"12d: 4 listener blocks launch "
          f"{launched}")
    add(launched)

    def slices(run, params, mic=None):
        return torch.cat([run(params._replace(
            listeners=params.listeners[l0:l0 + 16],
            mic_directivity=None if mic is None else mic[l0:l0 + 16]))
            for l0 in range(0, 64, 16)])

    k4_parts = slices(lambda p: bk.trace_frames_ir_mega(padded, p, 31, 1,
                                                        **one), p64)
    city10, pc10 = city(2500)
    ears = pc10.listeners + grid.to(dev) * 0.5
    pc64 = pc10._replace(listeners=ears)
    k8_64 = ak.trace_frames_ir_accel_sorted(city10, pc64, 32, 1, **one)
    city10b, pc10b = city(2500, 8)
    k7_64 = ak.trace_frames_ir_accel(city10b, pc10b._replace(listeners=ears),
                                     33, 1, **one)
    blocks_ok = {"K4": torch.equal(st_pad.sum, k4_parts)}
    n_mic = {}
    for name, fn, sc, pc, seed in (
            ("K8", ak.trace_frames_ir_accel_sorted, city10, pc64, 32),
            ("K7", ak.trace_frames_ir_accel, city10b,
             pc10b._replace(listeners=ears), 33)):
        prep = ak.prepare(sc)
        boxes = prep.n_clusters // prep.group * 6 + 24
        m = (bk.SMEM_FLOATS - boxes - 1) // 16 - 2
        m -= 1 - m % 2
        n_mic[name] = m
        mic = torch.as_tensor(np.pad(dv.cardioid(0.7), (0, m - 3)),
                              dtype=torch.float32,
                              device=dev).expand(64, -1).contiguous()
        pm = pc._replace(mic_directivity=mic)
        check(ak._listener_step(prep, 1, m) == 16,
              f"12d: 16 {name} listeners fit beside a {m}-term pattern")
        run = (lambda p, fn=fn, sc=sc, seed=seed:  # noqa: E731
               fn(sc, p, seed, 1, **one))
        before = fn.launches
        whole = run(pm)
        check(fn.launches - before == 4 * BOUNCES,
              f"12d: {name} runs 4 listener blocks")
        blocks_ok[name] = torch.equal(whole, slices(run, pm, mic))
        del whole
    torch.cuda.synchronize()
    print(f"[12d] 64 listeners: K4 IR {tuple(ir64.shape)} "
          f"({ir64.numel() * 8 / 1e6:.0f} MB of u64), {heard} listeners hear"
          f" the source; 4 listener blocks == the calls on their slices of "
          f"16, bit for bit: {blocks_ok} (K4 on SmollRoom padded to 5,280 "
          f"walls; K8 and K7 with microphone patterns of {n_mic} "
          f"coefficients); the city's 64 listeners hear "
          f"{int((k8_64.sum((1, 2)) > 0).sum())} (K8) and "
          f"{int((k7_64.sum((1, 2)) > 0).sum())} (K7)", flush=True)
    check(all(blocks_ok.values()) and heard >= 32
          and float(k8_64.sum()) > 0, "12d: listener blocks == slices")
    same_numbers("[12d] K8 64 listeners vs plain, city_scene(2500), "
                 f"{RAYS} x {BOUNCES} x 1 frame", "K8", k8_64,
                 ak.trace_frames_ir_accel_sorted_plain(
                     city10, pc64, 32, 1, ray_chunk=PLAIN_ELEMENTS // (
                         city10.n_walls * 64), **one))
    readings.update(sc=sc64, p=p64, city=city10, pc=pc64)
    del st64, ir64, st_pad, k4_parts, k7_64

    # 12f. batches past 5,280 walls: entry e of K8/K7 draws entry e's
    # numbers of K9 (bit for bit on the sorted 4,808-wall city); a sweep of
    # 8 copies of the 10,008-wall city with distinct listeners; a 16-source
    # mixdown in it
    city1, pc1 = city(1200)
    sorted1 = Scene(*(x[None] for x in ak.prepare(city1).scene))
    k9e = bk.trace_rooms_ir_mega(sorted1, pc1.source[None],
                                 pc1.listeners[None], 25, CITY_FRAMES,
                                 entry_offset=3, input_gain=CITY_GAIN,
                                 listener_radius=pc1.listener_radius,
                                 **city_run)[0]
    k8e = ak.trace_frames_ir_accel_sorted(city1, pc1, 25, CITY_FRAMES,
                                          entry=3, **city_run)
    k7e = ak.trace_frames_ir_accel(city1, pc1, 25, CITY_FRAMES, entry=3,
                                   **city_run)
    k8_0 = ak.trace_frames_ir_accel_sorted(city1, pc1, 25, CITY_FRAMES,
                                           **city_run)
    torch.cuda.synchronize()
    entry_ok = torch.equal(k9e, k8e) and torch.equal(k9e, k7e) \
        and not torch.equal(k8e, k8_0)
    print(f"[12f] entry 3 on the sorted city_scene(1200): K9 (entry_offset "
          f"3) == K8 (entry=3) == K7 (entry=3) bit for bit, != entry 0: "
          f"{entry_ok}", flush=True)
    check(entry_ok and float(k9e.sum()) > 0, "12f: entry ids")
    del k9e, k8e, k7e, k8_0
    n_e, frames = 8, 2
    offsets = torch.tensor([[float(i % 4) - 1.5, float(i // 4) - 0.5]
                            for i in range(n_e)], device=dev)
    sweep_lis = (pc10.listeners + offsets)[:, None]          # [8, 1, 2]
    copies = Scene.stack([city10] * n_e)
    src8 = pc10.source[None].expand(n_e, 2)
    sweep_kw = dict(input_gain=CITY_GAIN, room_offset=40,
                    listener_radius=float(pc10.listener_radius), **one)
    builds = ak.prepare.builds
    t0 = time.perf_counter()
    swept8, launched = counted(lambda: sweep_rooms(
        copies, src8, sweep_lis, 26, n_frames=frames, **sweep_kw))
    secs_8 = time.perf_counter() - t0
    n_builds = ak.prepare.builds - builds
    check(launched == only(K8=n_e * BOUNCES),
          f"12f: large sweep launches {launched}")
    add(launched)
    singles = [ak.trace_frames_ir_accel_sorted(
        city10, pc10._replace(listeners=sweep_lis[e]), 26, frames,
        entry=40 + e, **one) for e in range(n_e)]
    div = torch.tensor(float(frames), device=dev)
    single_ok = all(torch.equal(swept8[e], singles[e] / div)
                    for e in range(n_e))
    heard8 = [float(x) for x in swept8.sum((1, 2, 3))]
    print(f"[12f] sweep of {n_e} copies of city_scene(2500) "
          f"({city10.n_walls} walls) with distinct listeners, {RAYS} x "
          f"{BOUNCES} x {frames} frames: {secs_8:.3f} s, launches {launched}"
          f", prepare built {n_builds} tables; each room == a single K8 "
          f"call with entry 40 + e: {single_ok}; energies {heard8}",
          flush=True)
    check(single_ok and sum(x > 0 for x in heard8) >= n_e // 2,
          "12f: large sweep == single calls")
    plain8 = ak.trace_rooms_ir_accel_plain(
        copies, src8, sweep_lis, 26, frames, entry_offset=40,
        input_gain=CITY_GAIN, listener_radius=float(pc10.listener_radius),
        ray_chunk=PLAIN_ELEMENTS // city10.n_walls, **one)
    for e in range(n_e):
        if heard8[e] > 0:
            same_numbers(f"[12f] large sweep room {e} vs plain", "K8",
                         swept8[e] * div, plain8[e])
    del swept8, singles, plain8
    n_s = 16
    srcs = pc10.source[None] + torch.tensor(
        [[float(i % 4) - 1.5, float(i // 4) - 1.5] for i in range(n_s)],
        device=dev) * 0.5
    ears2 = pc10.listeners + torch.tensor([[-0.2, 0.0], [0.2, 0.0]],
                                          device=dev)
    pmix = art.TraceParams.make(srcs, ears2, input_gain=CITY_GAIN,
                                device=dev)
    ak.prepare(city10)         # the sweep's copies pushed it out of the cache
    builds = ak.prepare.builds
    mix, launched = counted(lambda: trace_sources_mixdown(city10, pmix, 27,
                                                          **one))
    check(launched == only(K8=n_s * BOUNCES) and
          ak.prepare.builds == builds,
          f"12f: large mixdown launches {launched}, prepare builds "
          f"{ak.prepare.builds - builds}")
    add(launched)
    singles = torch.stack([ak.trace_frames_ir_accel_sorted(
        city10, pmix._replace(source=srcs[s]), 27, 1, entry=s, **one)
        for s in range(n_s)]).sum(0)
    mix_plain = ak.trace_rooms_ir_accel_plain(
        city10, srcs, ears2.expand(n_s, 2, 2), 27, 1, input_gain=CITY_GAIN,
        ray_chunk=PLAIN_ELEMENTS // (2 * city10.n_walls), **one).sum(0)
    torch.cuda.synchronize()
    print(f"[12f] {n_s}-source mixdown in city_scene(2500), 2 ears: IR "
          f"{tuple(mix.shape)}, launches {launched}, no new sort; == the sum"
          f" of {n_s} single K8 calls (entry s): {torch.equal(mix, singles)}",
          flush=True)
    check(torch.equal(mix, singles), "12f: large mixdown == single calls")
    same_numbers("[12f] large mixdown vs plain", "K8", mix, mix_plain)
    del mix, singles, mix_plain
    return slice_launches, readings


def bands_timings(c, readings):
    """The [12t] lines: device time of K3, K4, K9 and K7 at 1, 8 and 32
    bands, and K4 and K8 with 64 listeners, each beside its bound (the
    wall tests and sweeps the kernel reports, plus two FP32 operations
    per band of each hit; the K u64 atomics of a hit are counted apart:
    they land in L2)."""
    torch, art, bk, ak, rng = (c[k] for k in ("torch", "art", "bk", "ak",
                                               "rng"))
    from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
    dev, card, work = c["dev"], c["card"], c["work"]
    kw = dict(sample_rate=SR, ir_length=T)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, **kw)
    city_run = dict(n_rays=BIG_RAYS, max_bounces=CITY_BOUNCES,
                    sample_rate=CITY_SR, ir_length=CITY_T)
    gen = torch.Generator(device=dev).manual_seed(13)
    emit, u = rng.bounce_uniforms(gen, 1, BOUNCES, RAYS, dev)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    g = np.random.default_rng(13)
    mix_src = np.stack([g.uniform(-15, 15, N_SOURCES),
                        g.uniform(-3, 8, N_SOURCES)], -1).astype(np.float32)
    cities = c["city_bands"]

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    def device_ms(fn, reps, name="frames_ir_kernel", launches=1):
        """The median of three profiler readings that each hold all the
        launches of their calls."""
        got = [kernel_device_ms(torch, fn, reps, name, launches)
               for _ in range(3)]
        return None if None in got else float(np.median(got))

    rows = {}
    for n_bands in (1, 8, 32):
        room = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        sc = room.scene
        p = art.TraceParams.make(room.source, room.listener, device=dev)
        shared = c["Scene"](*(x[None] for x in sc))
        lis64 = torch.as_tensor(ears, device=dev)[None].expand(N_SOURCES, 2,
                                                               2)
        csc, pc = cities[n_bands]
        rows[n_bands] = {
            "K3": device_ms(lambda: bk.trace_frames_ir_whole(
                sc, p, emit, u, **kw), 10),
            "K4": device_ms(lambda: bk.trace_frames_ir_mega(
                sc, p, 5, 1, **one), 10),
            "K4 131k x 8 x 8": device_ms(
                lambda: bk.trace_frames_ir_mega(
                    sc, p, 6, BIG_FRAMES, n_rays=BIG_RAYS,
                    max_bounces=BIG_BOUNCES, **kw), 3),
            "K9 mixdown": device_ms(
                lambda: bk.trace_rooms_ir_mega(
                    shared, mix_src, lis64, 7, 1, **one), 5),
            "K7 40,008 walls": device_ms(
                lambda: ak.trace_frames_ir_accel(
                    csc, pc, 5, CITY_FRAMES, **city_run), 2,
                "accel_bounce_kernel", CITY_BOUNCES)}
    print(f"[12t] device ms per call on {card} (profiler, the median of "
          "three readings) at K = 1 / 8 / 32 bands: " + "; ".join(
              f"{k} {' / '.join(fmt(rows[n][k]) for n in (1, 8, 32))}"
              for k in rows[1]), flush=True)
    k7 = k7_against_parent(c, rows, device_ms)
    shapes = k4_lane_groups(c, readings, device_ms)
    frame = k5_k6_against_parent(c, device_ms)
    # 64 listeners: K4 on SmollRoom (K = 8), K8 on the 10,008-wall city
    r64 = readings["64"]
    out = {"rows": rows}
    for key, fn, kname, scene, p, seed in (
            ("K4", bk.trace_frames_ir_mega, "frames_ir_kernel", r64["sc"],
             r64["p"], 31),
            ("K8", ak.trace_frames_ir_accel_sorted, "accel_bounce_kernel",
             r64["city"], r64["pc"], 32)):
        n_bands = scene.n_bands
        ms = cuda_ms(torch, lambda: fn(scene, p, seed, 1, **one), 5)
        dev_ms = device_ms(lambda: fn(scene, p, seed, 1, **one), 3, kname,
                           BOUNCES if key == "K8" else 1)
        w = work(lambda n: fn(scene, p, seed, 1, work_counts=n, **one))
        traced = scene if key == "K4" else ak.prepare(scene).scene
        e1, u1 = rng.philox_uniforms(seed, 1, BOUNCES, RAYS, dev)
        hits = tt.trace_hits_only(traced, p, e1[0], u1[0], use_kernels=True)
        n_hits = int(hits.valid.sum())
        n_l = p.listeners.shape[0]
        n_bytes = 4 * ((10 + n_bands) * scene.n_walls + 2 * n_l + 5
                       + n_l * T * n_bands)
        ops_ms = (w[0] * OPS_PER_TEST + w[1] * OPS_PER_SWEEP
                  + w[2] * OPS_PER_SLAB + 2 * n_bands * n_hits) \
            / PEAK_FP32 * 1e3
        bytes_ms = n_bytes / PEAK_BYTES * 1e3
        bnd = (ops_ms, "operations") if ops_ms >= bytes_ms else \
            (bytes_ms, "bytes")
        print(f"[12t] {key} 64 listeners, K={n_bands}, {scene.n_walls} walls,"
              f" {RAYS} x {BOUNCES} x 1 frame on {card}: {ms:.3f} ms per call"
              f" (CUDA events), device {fmt(dev_ms)} ms; {w[0]} wall tests, "
              f"{w[1]} sweeps, {w[2]} slab tests, {n_hits} hits x {n_bands} "
              f"bands ({n_hits * n_bands} u64 atomics, not in the bound); "
              f"bound {bnd[0]:.6f} ms ({bnd[1]}; {FMAD_NOTE}), device at "
              f"{'not measured' if dev_ms is None else f'{bnd[0] / dev_ms * 100:.1f}%'}"
              " of it", flush=True)
        out[key] = dict(ms=ms, device_ms=dev_ms, work=w, hits=n_hits,
                        bound=bnd)
    out.update(k7=k7, shapes=shapes, frame=frame)
    return out


def k7_against_parent(c, rows, device_ms):
    """The [12t] K7 lines: the sorted K7 at 1, 8 and 32 bands on the
    40,008-wall city (``rows``) and at the city stream's shape (8 bands),
    each beside the device time of the all-bounces kernel it replaced
    (PARENT_K7_MS) and its bound from this run's work counts."""
    torch, art, ak = c["torch"], c["art"], c["ak"]
    dev, card, work = c["dev"], c["card"], c["work"]
    city_run = dict(n_rays=BIG_RAYS, max_bounces=CITY_BOUNCES,
                    sample_rate=CITY_SR, ir_length=CITY_T)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
               ir_length=T)
    room = art.rooms.city_scene(2500, n_bands=8, device=dev)
    stream = (room.scene, art.TraceParams.make(
        room.source, room.listener, room.listener_radius, 343.0, CITY_GAIN,
        device=dev))
    calls = {f"40,008 walls K={k}": (*c["city_bands"][k], CITY_FRAMES,
                                     city_run, rows[k]["K7 40,008 walls"])
             for k in (1, 8, 32)}
    calls["city stream 15k x 5 x 1, K=8"] = (*stream, 1, one, None)
    out = {}
    for key, (scene, p, frames, run, dev_ms) in calls.items():
        def call(**a):
            return ak.trace_frames_ir_accel(scene, p, 5, frames, **run, **a)
        if dev_ms is None:
            dev_ms = device_ms(call, 5, "accel_bounce_kernel",
                               run["max_bounces"])
        w = work(lambda n: call(work_counts=n))
        prep = ak.prepare(scene)
        n_k, n_l = scene.n_bands, p.listeners.shape[0]
        n_bytes = 4 * (prep.walls.numel() + prep.aabb.numel()
                       + prep.saabb.numel() + 2 * n_l + 5
                       + n_l * run["ir_length"] * n_k)
        bnd = bound(w, n_bytes)
        parent = PARENT_K7_MS[key]
        # the old kernel's bound, from its work counts on the same call
        old = ("" if key.startswith("city") else
               f", its bound {bound(PARENT_WORK['[8d]'], n_bytes)[0]:.4f}")
        check(dev_ms is not None, f"[12t] K7 {key}: device time read")
        print(f"[12t] K7 {key} on {card}: device {dev_ms:.4f} ms per call "
              f"({run['max_bounces']} launches; the kernel it replaced: "
              f"{parent:.4f}, {parent / dev_ms:.2f}x{old}); {w[0]} wall "
              f"tests, {w[1]} sweeps, {w[2]} slab tests -> bound "
              f"{bnd[0]:.6f} ms "
              f"({bnd[1]}), device at {bnd[0] / dev_ms * 100:.1f}% of it",
              flush=True)
        check(dev_ms <= parent * 1.05, f"[12t] K7 {key}: {dev_ms:.4f} ms no "
              f"slower than the kernel it replaced ({parent:.4f})")
        out[key] = dict(device_ms=dev_ms, parent_ms=parent, work=w,
                        bound=bnd)
    return out


def k5_k6_against_parent(c, device_ms):
    """The [12t] K5/K6 lines: device ms per call of K5 (frame_rows_kernel)
    and K6 (K3's frames_ir_kernel at one frame) on one SmollRoom frame
    with host uniforms at 15,000 x 5 and 131,072 x 8, beside the
    per-bounce step kernel they replaced (PARENT_K5_MS, PARENT_K6_MS) and
    their bounds from this run's work counts; each at most 1.05x the
    parent's."""
    torch, art, bk, rng = (c[k] for k in ("torch", "art", "bk", "rng"))
    dev, card, work = c["dev"], c["card"], c["work"]
    room = art.rooms.smoll_room(device=dev)
    sc, p = room.scene, art.TraceParams.make(room.source, room.listener,
                                             device=dev)
    w = sc.n_walls
    out = {}
    for shape, n_rays, n_b in (("15k x 5", RAYS, BOUNCES),
                               ("131k x 8", BIG_RAYS, BIG_BOUNCES)):
        emit, u = rng.philox_uniforms(27, 1, n_b, n_rays, dev)
        e1, u1 = emit[0], u[0]
        calls = {
            "K5": (lambda e1=e1, u1=u1, **a: bk.trace_fused_rows(
                sc, p, e1, u1, **a), "frame_rows_kernel", PARENT_K5_MS,
                rows_bytes(w, n_rays, n_b)),
            "K6": (lambda e1=e1, u1=u1, **a: bk.trace_frame_ir_fused(
                sc, p, e1, u1, sample_rate=SR, ir_length=T, **a),
                "frames_ir_kernel", PARENT_K6_MS,
                4 * (11 * w + 2 + 5 + T + n_rays * (1 + 3 * n_b)))}
        for k, (fn, kname, parent_ms, n_bytes) in calls.items():
            dev_ms = device_ms(fn, 10 if n_rays == RAYS else 5, kname)
            ms = cuda_ms(torch, fn, 10)
            bnd = bound(work(lambda n, fn=fn: fn(work_counts=n)), n_bytes)
            parent = parent_ms[shape]
            check(dev_ms is not None, f"[12t] {k} {shape}: device time read")
            print(f"[12t] {k} {shape} x 1 frame on {card}: device "
                  f"{dev_ms:.4f} ms per call, one launch (the per-bounce "
                  f"step kernel it replaced, {n_b} launches: {parent:.4f}, "
                  f"{parent / dev_ms:.2f}x); {ms:.4f} ms per call (CUDA "
                  f"events); bound {bnd[0]:.6f} ms ({bnd[1]}), device at "
                  f"{bnd[0] / dev_ms * 100:.1f}% of it", flush=True)
            check(dev_ms <= parent * 1.05, f"[12t] {k} {shape}: "
                  f"{dev_ms:.4f} ms no slower than the step kernel "
                  f"({parent:.4f})")
            out[k, shape] = dict(device_ms=dev_ms, ms=ms, parent_ms=parent,
                                 bound=bnd)
    return out


def k4_lane_groups(c, readings, device_ms):
    """The [12t] K3/K4 lines: device ms at the stream's shape
    (15,000 x 5 x 1 frame) and of the 64-listener K4 call with lane groups
    of 1 and 4 beside the parent's (PARENT_K4_MS); both give the same IR
    bit for bit."""
    torch, art, bk, rng = (c[k] for k in ("torch", "art", "bk", "rng"))
    dev, card = c["dev"], c["card"]
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
               ir_length=T)
    room = art.rooms.smoll_room(device=dev)
    sc, p = room.scene, art.TraceParams.make(room.source, room.listener,
                                             device=dev)
    emit, u = rng.philox_uniforms(13, 1, BOUNCES, RAYS, dev)
    r64 = readings["64"]
    calls = {"K4 15k x 5 x 1": lambda: bk.trace_frames_ir_mega(sc, p, 5, 1,
                                                                **one),
             "K3 15k x 5 x 1": lambda: bk.trace_frames_ir_whole(
                 sc, p, emit, u, sample_rate=SR, ir_length=T),
             "K4 64 listeners K=8": lambda: bk.trace_frames_ir_mega(
                 r64["sc"], r64["p"], 31, 1, **one)}
    chosen = {k: bk.lane_group(RAYS, n) for k, n in
              (("K4 15k x 5 x 1", 1), ("K3 15k x 5 x 1", 1),
               ("K4 64 listeners K=8", 8))}
    want = {k: fn() for k, fn in calls.items()}
    lane_group = bk.lane_group
    out = {}
    groups = (1, bk.LANE_GROUP)
    try:
        for g in groups:
            bk.lane_group = lambda n, k, g=g: g
            for key, fn in calls.items():
                same = torch.equal(fn(), want[key])
                check(same, f"[12t] {key} lanes {g}: the chosen group's "
                      "bits")
                out[key, g] = device_ms(fn, 10 if "64" not in key else 3)
    finally:
        bk.lane_group = lane_group

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f}"
    for key in calls:
        parent = PARENT_K4_MS[key]
        print(f"[12t] {key} on {card}, device ms per call by lanes per ray "
              f"(chosen {chosen[key]}; the kernel before lane groups: "
              f"{parent:.4f}): " + ", ".join(
                  f"G={g} {fmt(out[key, g])}" for g in groups)
              + "; both == the chosen one bit for bit", flush=True)
        got = out[key, chosen[key]]
        check(got is not None and got <= parent * 1.05,
              f"[12t] {key}: {fmt(got)} ms no slower than before ({parent})")
    return {f"{k} G={g}": v for (k, g), v in out.items()}


# The binaural decode's target bin t = bin - shift * sin(phi) is a float32
# near the bin, spaced 7.8e-3 at 72,000 bins: an input that differs by the
# kernel's fixed-point rounding can round a t one spacing over, which moves
# e * spacing of a deposit e to the next bin. A decoded bin is held within
# DECODE_FLIPS such moves of the largest deposit ((1 + shadow) * max W).
DECODE_FLIPS = 4


def decode_limit(w_max, n_t, shadow=0.6):
    """The per-bin limit of a decoded ear IR against another decode of
    inputs that differ by rounding (see DECODE_FLIPS)."""
    return DECODE_FLIPS * (1.0 + shadow) * w_max * float(
        np.spacing(np.float32(n_t)))


def chunk_profile(torch, fn, n_chunks):
    """One call of ``fn`` (``n_chunks`` chunks of a stream) under the
    profiler: (device-busy ms, cudaLaunchKernel calls, device kernels),
    each per chunk."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    calls = sum(1 for e in events if e.name == "cudaLaunchKernel")
    return busy / n_chunks, calls / n_chunks, len(kernels) / n_chunks


def stream_timings(torch, make, dry, params_fn, facing=None,
                   doppler=False, n=221):
    """A stream's chunk times and device load: ``n`` chunks of a looped
    stream from ``make()`` synced after every chunk (chunk 0, the
    warm-up, left out) for the median and p99 ms per chunk, then 10
    chunks of a fresh one under the profiler (:func:`chunk_profile`).
    Returns (median, p99, device-busy ms, cudaLaunchKernel calls, device
    kernels), the last three per chunk."""
    chunk_ms, t_last = [], [0.0]

    def tick(i, st):
        torch.cuda.synchronize()
        now = time.perf_counter()
        chunk_ms.append((now - t_last[0]) * 1e3)
        t_last[0] = now

    t_last[0] = time.perf_counter()
    make().stream_clip(dry, params_fn, loop=True, total_chunks=n,
                       on_chunk=tick, facing_fn=facing, doppler=doppler)
    steady = np.asarray(chunk_ms[1:])
    busy, calls, kernels = chunk_profile(
        torch, lambda: make().stream_clip(dry, params_fn, total_chunks=10,
                                          facing_fn=facing,
                                          doppler=doppler), 10)
    return (float(np.median(steady)), float(np.percentile(steady, 99)),
            busy, calls, kernels)


def spatial_phase(c):
    """Phase 13: spatial captures and the binaural stream at full width
    (SmollRoom 15,000 x 5, 48 kHz, 72,000 bins, 4,800-sample chunks; the
    10,008-wall city). ``c`` holds the objects of main(). Returns the
    launch counts of its paths and its readings."""
    torch, art, bk, ak, rng, cli = (c[k] for k in (
        "torch", "art", "bk", "ak", "rng", "cli"))
    dev, counted, only, same_numbers, card = (c[k] for k in (
        "dev", "counted", "only", "same_numbers", "card"))
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        click_clip, read_wav, write_wav)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
               ir_length=T)
    slice_launches = {k: 0 for k in only()}
    readings = {}

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=RAYS)
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    mics = ("omni", "cardioid 0", "cardioid 90", "1 + cos 2", "1 + sin 2")

    # 13a. the capture through K4 (orders 1 and 2, and 8 bands) and K3
    # against the plain version on the same numbers, row by row
    room8 = art.rooms.smoll_room(n_bands=8, device=dev)
    p8 = art.TraceParams.make(room8.source, room8.listener, device=dev)
    host = rng.philox_uniforms(42, 1, BOUNCES, RAYS, dev)
    for tag, kernel, scene, pp, order, draws in (
            ("K4 order 1", "K4", room.scene, p, 1, dict(seed=41)),
            ("K4 order 2", "K4", room.scene, p, 2, dict(seed=41)),
            ("K4 order 1, 8 bands", "K4", room8.scene, p8, 1,
             dict(seed=43)),
            ("K3 order 1", "K3", room.scene, p, 1, dict(uniforms=host))):
        (_, st), launched = counted(lambda: sp.trace_spatial(
            scene, pp, order=order, **draws, **one))
        check(launched == only(**{kernel: 1}),
              f"13a: {tag} launches {launched}")
        add(launched)
        _, want = sp.trace_spatial(scene, pp, order=order, backend="plain",
                                   **draws, **one)
        check(tuple(st.sum.shape) == (3 if order == 1 else 5, T,
                                      scene.n_bands),
              f"13a: {tag} capture {tuple(st.sum.shape)}")
        for row in range(st.sum.shape[0]):
            same_numbers(f"[13a] {tag} mic {mics[row]} vs plain, {RAYS} x "
                         f"{BOUNCES} x 1 frame", kernel, st.sum[row],
                         want.sum[row])

    # 13b. 35 chunks of clicks through the binaural stream, the head
    # turning 0.5 rad/s from facing the source: K4 once a chunk; against
    # its plain twin; bit-identical on a rerun; a degenerate head (radius
    # 0, shadow 0) against the mono stream
    clicks = (0.1, 0.7, 1.3)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=clicks),
                          device=dev)
    n_chunks = 20 + 15
    src, lis = room.source, room.listener
    bearing = float(np.arctan2(src[1] - lis[1], src[0] - lis[0]))

    def turn(i):
        return bearing - 0.05 * i

    def binaural(backend="auto", irs=None, **head):
        s = art.Streamer(room.scene, cfg, seed=51, binaural=True,
                         backend=backend, **head)
        return s.stream_clip(dry, lambda i: p, facing_fn=turn,
                             on_chunk=None if irs is None else (
                                 lambda i, st: irs.append(
                                     st.prev_ir.clone())))

    irs_k, irs_p = [], []
    wet, launched = counted(lambda: binaural(irs=irs_k))
    check(launched == only(K4=n_chunks), f"13b: binaural stream launches "
          f"{launched}")
    add(launched)
    again, _ = counted(binaural)
    check(torch.equal(wet, again), "13b: binaural stream rerun "
          "bit-identical")
    wet_p, launched_p = counted(lambda: binaural("plain", irs_p))
    check(launched_p == only(), f"13b: plain twin launched {launched_p}")
    out, out_p = wet.cpu().numpy(), wet_p.cpu().numpy()
    check(out.shape == (2, n_chunks * CHUNK) and np.isfinite(out).all()
          and np.abs(out).max() > 0, f"13b: stream {out.shape} finite")
    w_max = max(float(ir.abs().max()) for ir in irs_p)
    d_ir = max(float((a - b).abs().max()) for a, b in zip(irs_k, irs_p))
    lim_ir = decode_limit(w_max, T) + 1e-6 * w_max
    lim = 2e-6 * np.abs(out_p).max() + float(dry.abs().sum()) * d_ir
    gap = np.abs(out - out_p) - 1e-4 * np.abs(out_p)
    ears = [float((out[e] ** 2).sum()) for e in (0, 1)]
    print(f"[13b] binaural stream: SmollRoom, head turning 0.5 rad/s, "
          f"{n_chunks} chunks -> {out.shape}, launches {launched}, rerun "
          f"bit-identical; decoded IRs vs the plain twin's: max abs "
          f"{d_ir:.3e} (limit {lim_ir:.3e} = {DECODE_FLIPS} target-bin "
          f"spacings of the largest deposit, max W {w_max:.3e}); audio: max"
          f" abs over rtol 1e-4 {gap.max():.3e} (limit {lim:.3e} = 2e-6 of "
          f"the peak + sum|dry| x that IR gap); ear energies "
          f"{ears[0]:.4e} / {ears[1]:.4e}", flush=True)
    check(d_ir <= lim_ir, "13b: decoded IRs within the decode limit")
    check(gap.max() <= lim, "13b: binaural stream == its plain twin")
    del irs_k, irs_p, again, wet_p
    # the degenerate head: each ear is W, which K4 bins at the scale of
    # its loudest microphone (S3 = S1 / 2 for the cardioids): a W bin is
    # within hits * (0.5 / S1 + 0.5 / S3) of the mono bin (hits = R * 2B,
    # each rounded to half a step) plus 3 float32 roundings of W (the two
    # conversions and the decode's coh + (W - coh))
    mono_irs = []
    mono = art.Streamer(room.scene, cfg, seed=51).stream_clip(
        dry, lambda i: p, on_chunk=lambda i, st: mono_irs.append(
            float(st.prev_ir.max())))
    flat, _ = counted(lambda: binaural(head_radius=0.0, shadow=0.0))
    mono, flat = mono.cpu().numpy()[0], flat.cpu().numpy()
    s1 = float(bk.fixed_point_scale(p, 1, RAYS, BOUNCES))
    s3 = float(bk.fixed_point_scale(sp.spatial_params(p), 1, RAYS, BOUNCES))
    per_bin = RAYS * 2 * BOUNCES * (0.5 / s1 + 0.5 / s3) \
        + 3 * 2.0 ** -24 * max(mono_irs)
    lim_flat = 2e-6 * np.abs(mono).max() + float(dry.abs().sum()) * per_bin
    gap_flat = float(np.abs(flat - mono[None]).max())
    print(f"[13b] degenerate head vs the mono stream: max abs {gap_flat:.3e}"
          f" (limit {lim_flat:.3e}: S1 = 2^{np.log2(s1):.0f}, S3 = 2^"
          f"{np.log2(s3):.0f}, {RAYS * 2 * BOUNCES} hits of half a step "
          f"each, 3 float32 roundings of max W {max(mono_irs):.3e}, "
          f"sum|dry| {float(dry.abs().sum()):g}; peak "
          f"{np.abs(mono).max():.3e})", flush=True)
    check(s3 == s1 / 2 and gap_flat <= lim_flat,
          "13b: degenerate head == mono within the fixed-point limit")

    # timings: >= 200 chunks of each stream, the device-busy time and the
    # launches of a chunk under the profiler, K4 at L = 3 directive against
    # L = 1 omni
    rows = {}
    for name, make, facing in (
            ("mono", lambda: art.Streamer(room.scene, cfg, seed=52), None),
            ("binaural", lambda: art.Streamer(room.scene, cfg, seed=52,
                                              binaural=True), turn)):
        rows[name] = stream_timings(torch, make, dry, lambda i: p,
                                    facing=facing)
    sp_p = sp.spatial_params(p)
    k4_ms = {}
    for _ in range(3):       # omni, directive, alternating
        for name, pp in (("L = 1 omni", p), ("L = 3 directive", sp_p)):
            k4_ms.setdefault(name, []).append(kernel_device_ms(
                torch, lambda: bk.trace_frames_ir_mega(room.scene, pp, 5, 1,
                                                       **one),
                10, "frames_ir_kernel", 1))
    k4_med = {k: (None if None in v else float(np.median(v)))
              for k, v in k4_ms.items()}
    readings["stream"], readings["K4"] = rows, k4_med
    print(f"[13b] timings on {card}: ms per 100 ms chunk (synced, 220 "
          "chunks) median / p99, device busy ms per chunk, cudaLaunchKernel"
          " and device kernels per chunk (profiler, 10 chunks): " + "; ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}, busy {v[2]:.4f}, "
              f"{v[3]:.1f} launches, {v[4]:.1f} kernels"
              for k, v in rows.items())
          + "; K4 device ms per call at 15,000 x 5 (median of three "
          "guarded readings): " + ", ".join(
              f"{k} {'not measured' if v is None else f'{v:.4f}'}"
              for k, v in k4_med.items()), flush=True)

    # 13c. 3 chunks of the binaural stream on the 10,008-wall city: K8
    # (5 launches a chunk), the capture of chunk 0 against the plain
    # version; the 8-band city's capture through K7
    scene_9, p_9 = c["scene_9"], c["p_9"]
    t0 = time.perf_counter()
    city_wet, launched = counted(lambda: art.Streamer(
        scene_9, cfg, seed=53, binaural=True).stream_clip(
            dry, lambda i: p_9, total_chunks=3, facing_fn=lambda i: 0.3 * i))
    city_s = time.perf_counter() - t0
    check(launched == only(K8=3 * BOUNCES), f"13c: city binaural stream "
          f"launches {launched}")
    add(launched)
    check(tuple(city_wet.shape) == (2, 3 * CHUNK)
          and bool(torch.isfinite(city_wet).all()), "13c: finite")
    sp_9 = sp.spatial_params(p_9)
    chunk0 = rng.mix_seed(53, 0)
    same_numbers(f"[13c] K8 capture of chunk 0 vs plain, city_scene(2500) "
                 f"{scene_9.n_walls} walls, {RAYS} x {BOUNCES}", "K8",
                 ak.trace_frames_ir_accel_sorted(scene_9, sp_9, chunk0, 1,
                                                 **one),
                 ak.trace_frames_ir_accel_sorted_plain(scene_9, sp_9, chunk0,
                                                       1, **one))
    city8 = art.rooms.city_scene(2500, n_bands=8, device=dev)
    p_c8 = art.TraceParams.make(city8.source, city8.listener,
                                city8.listener_radius, 343.0, CITY_GAIN,
                                device=dev)
    (_, st8), launched8 = counted(lambda: sp.trace_spatial(
        city8.scene, p_c8, 54, **one))
    check(launched8 == only(K7=BOUNCES), f"13c: 8-band city capture "
          f"launches {launched8}")
    add(launched8)
    same_numbers(f"[13c] K7 capture, 8-band city_scene(2500), {RAYS} x "
                 f"{BOUNCES}, vs plain", "K7", st8.sum,
                 ak.trace_frames_ir_accel_sorted_plain(
                     city8.scene, sp.spatial_params(p_c8), 54, 1, **one))
    print(f"[13c] city binaural stream: 3 chunks in {city_s:.3f} s (the "
          f"first call included), launches {launched}; the 8-band city's "
          f"capture launches {launched8}", flush=True)
    del city8, st8

    # 13d. the CLI: bake --binaural, trace --spatial-out, stream --binaural
    # with diffraction, analyze, sweep --metrics-out; each timed, its
    # launches counted
    cli_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(n):
            return os.path.join(tmp, n)

        write_wav(path("d.wav"), click_clip(1.0, 44100,
                                            click_times=(0.1, 0.6)), 44100)
        runs = (
            ("bake --binaural 30", ["bake", "--room", "smoll", "--in",
                                    path("d.wav"), "--out", path("b.wav"),
                                    "--binaural", "30"], dict(K4=1)),
            ("trace --spatial-out", ["trace", "--room", "smoll",
                                     "--spatial-out", path("sp.npz")],
             dict(K4=2)),
            ("stream --binaural 0 --head-turn 90 --diffraction --duration 1",
             ["stream", "--room", "smoll", "--in", path("d.wav"), "--out",
              path("s.wav"), "--binaural", "0", "--head-turn", "90",
              "--diffraction", "--duration", "1"],
             dict(K4=10, K2=10, D3seg=10, D3bin=10)),
            ("analyze", ["analyze", "--room", "smoll", "--out",
                         path("r.json"), "--edc-out", path("edc.png")],
             dict(K4=1)),
            ("sweep --rooms 64 --metrics-out",
             ["sweep", "--rooms", "64", "--out", path("irs.npz"),
              "--metrics-out", path("m.npz")], dict(K9=1)))
        said = {}
        for name, argv, want in runs:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launched = counted(lambda: cli.main(argv))
            cli_s[name] = time.perf_counter() - t0
            said[name] = buf.getvalue()
            check(launched == only(**want), f"13d: cli {name} launches "
                  f"{launched}")
            add(launched)
        x, rate = read_wav(path("b.wav"))
        check(rate == SR and x.shape == (SR + T, 2) and np.isfinite(x).all()
              and not np.allclose(x[:, 0], x[:, 1]),
              f"13d: binaural bake {x.shape}")
        with np.load(path("sp.npz")) as npz:
            check(set(npz.files) == {"w", "x", "y", "arrival_angle",
                                     "diffuseness", "sample_rate"}
                  and npz["w"].shape == (1, T, 1), "13d: spatial npz")
        x, rate = read_wav(path("s.wav"))
        check(x.shape == (10 * CHUNK, 2) and np.abs(x).max() > 0,
              f"13d: binaural stream wav {x.shape}")
        with np.load(path("m.npz")) as npz:
            check(npz["rt60_t20_s"].shape == (64, 1, 1)
                  and len(npz.files) == 10, "13d: sweep metrics")
    xrt = re.search(r"\(([0-9.]+)x realtime\)",
                    said["stream --binaural 0 --head-turn 90 --diffraction "
                         "--duration 1"]).group(1)
    bake_line = said["bake --binaural 30"].strip().splitlines()[-1]
    readings["cli"] = cli_s
    print(f"[13d] cli on {card}, seconds (launches checked): " + ", ".join(
        f"{k} {v:.2f}" for k, v in cli_s.items())
        + f"; stream --binaural {xrt}x realtime; {bake_line}", flush=True)
    return slice_launches, readings


def decode_phase(c):
    """Phase 13e: the binaural decode kernel (``binaural_decode_kernel``
    through ``ops/cuda/binaural_kernel.py::binaural_decode``) beside its
    plain chain (``spatial.binaural_plain``, the sorted ``index_put_``) on
    K4 captures of SmollRoom at the headphone cell's ``[3, 72,000, 1]``
    and at 8 bands, ``[3, 72,000, 8]``, the stream's card tensor speed of
    sound: the kernel equals the chain's card-computed deposits summed in
    index order bit for bit, one launch a call; ms a call (CUDA events),
    device ms (profiler), the byte bound (capture and ear signs read,
    both ears written, over 3.35 TB/s) and each side's device launches;
    registers, local bytes and the ptxas line. ``c`` holds the objects of
    main() (``torch``, ``art``, ``build``, ``dev``). Returns the
    readings."""
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        binaural_kernel as bdk
    torch, art, dev = c["torch"], c["art"], c["dev"]
    readings = {}
    for n_bands in (1, 8):
        room = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        p = art.TraceParams.make(room.source, room.listener, device=dev)
        _, st = sp.trace_spatial(room.scene, p, 13, n_rays=RAYS,
                                 max_bounces=BOUNCES, sample_rate=SR,
                                 ir_length=T)
        cap, speed = st.normalized(), p.speed_of_sound
        head = (SR, 0.3, 0.0875, 0.6, speed)

        def kernel():
            return sp.binaural_decode_ir(cap, *head)

        def chain():
            return sp.binaural_plain(sp.spatial_from_ir(cap), *head)

        rows, values, diffuse = sp.binaural_entries(sp.spatial_from_ir(cap),
                                                    *head)
        deposits = torch.zeros(2 * diffuse.numel()).index_add_(
            0, rows.cpu(), values.cpu())
        want = sp.binaural_ears(deposits, diffuse.cpu(), True)
        before = bdk.binaural_decode.launches
        got = kernel()
        torch.cuda.synchronize()
        check(bdk.binaural_decode.launches == before + 1,
              f"13e: one decode launch a call, K={n_bands}")
        check(torch.equal(got.cpu().view(torch.int32),
                          want.view(torch.int32)),
              f"13e: decode kernel == the chain's deposits in index order "
              f"bit for bit, K={n_bands}")
        ref = chain().cpu()
        gap = float((got.cpu() - ref).abs().max() / ref.abs().max())
        n_kernel = len(device_kernels(torch, kernel))
        n_chain = len(device_kernels(torch, chain))
        ms_kernel, ms_chain = cuda_ms(torch, kernel, 50), cuda_ms(torch,
                                                                  chain, 20)
        dev_kernel = kernel_device_ms(torch, kernel, 50,
                                      "binaural_decode_kernel", 1)
        dev_chain = kernel_device_ms(torch, chain, 20, "", n_chain)
        n_bytes = 4 * (3 * T * n_bands + 2 * T + 2 * T * n_bands)
        bound_ms = n_bytes / 3.35e12 * 1e3
        readings[n_bands] = dict(ms=ms_kernel, device_ms=dev_kernel,
                                 chain_ms=ms_chain,
                                 chain_device_ms=dev_chain,
                                 bound_ms=bound_ms, launches=n_kernel,
                                 chain_launches=n_chain, gap=gap)
        print(f"[13e] decode [3, {T}, {n_bands}]: kernel {ms_kernel:.4f} ms "
              f"a call [{dev_kernel} ms device, {n_kernel} launch], chain "
              f"{ms_chain:.4f} ms [{dev_chain} ms device, {n_chain} "
              f"launches]; bound {bound_ms:.6f} ms ({n_bytes} B, bytes); "
              f"== the chain's deposits in index order bit for bit; the "
              f"card chain's sorted accumulate within {gap:.2e} of the "
              f"peak", flush=True)
        check(n_kernel == 1, f"13e: the decode kernel alone ({n_kernel})")
    lib = c["build"].load_library()
    out = (ctypes.c_int * 2)()
    check(lib.art_binaural_decode_attributes(out) == 0, "13e: attributes")
    line = ptxas_table(c["build"].build_log()).get("binaural_decode_kernel")
    print(f"[13e] binaural_decode_kernel registers / local bytes {out[0]} / "
          f"{out[1]} B, ptxas (registers, spill stores, spill loads) "
          f"{line}", flush=True)
    check(line is not None, "13e: binaural_decode_kernel in the build log")
    return readings


# FP32 operations of a tap term in tap_synthesis_kernel: the delay's and
# the gain's glides (3 each), the read position, floor and fraction (3),
# the interpolation (4), the gain and the sum (2)
TAP_TERM_FLOP = 15


def taps_phase(c):
    """Phase 13f: per-arrival Doppler's tap kernels (``ear_taps_kernel``
    and ``tap_synthesis_kernel`` through ``ops/cuda/arrival_taps_kernel.
    py``) beside their plain chain (``streaming._ear_taps``, the window's
    gate and ``_tap_chunk_plain``, 200-odd launches) on the headphone
    cell's chunk: a composed stream of SmollRoom (15,000 x 5, 72,000 bins,
    4,800-sample chunks, 6 taps, a 10,562-sample window) gives chunk 2's
    tables; the table equals the card chain's bit for bit, the taps fall
    within ``1e-5 max|dry| sum|g|`` of the chain's (their sums' order);
    one launch a call each; ms a call of both (CUDA events), each
    kernel's device ms and the chain's over its launches (profiler); the
    bound, the larger of the valid rows' tap terms' FP32 operations
    (TAP_TERM_FLOP) over 67 TFLOP/s and the bytes (tables, window, rows,
    taps) over 3.35 TB/s; registers, local bytes and ptxas lines. ``c``
    holds the objects of main() (``torch``, ``art``, ``build``, ``dev``).
    Returns the readings."""
    from realisticaudioraytracing2d_tpu_torch import streaming as st
    from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        arrival_taps_kernel as atk
    torch, art, dev = c["torch"], c["art"], c["dev"]
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = torch.rand(6 * CHUNK, generator=torch.Generator(dev).manual_seed(
        13), device=dev) - 0.5
    streamer = art.Streamer(room.scene, cfg, seed=13, binaural=True)
    carries = []
    streamer.stream_clip(dry, lambda i: p, total_chunks=3, loop=True,
                         facing_fn=lambda i: 0.3 * i, doppler="per_arrival",
                         on_chunk=lambda i, s: carries.append(
                             st.ArrivalCarry(*(x.clone() for x in
                                               s.arrival.tensors()))))
    prev, cur = carries[1], carries[2]
    wd = CHUNK + streamer.arrival_early + 2
    window = st.DryWindow(dry, wd, *st.window_scalars(
        2, CHUNK, wd, dry.shape[-1], True, None), True)
    head = (cur, prev, 0.6, torch.tensor(0.3, device=dev), T, SR, 0.0875,
            0.6, p.speed_of_sound, True, 64.0)

    def kernels():
        ears = atk.ear_taps(*head)
        return st._tap_chunk(window, *ears[:5], CHUNK)

    def chain():
        ears = st._ear_taps(*head)
        return st._tap_chunk_plain(cv.gate_input(window.tensor()),
                                   *ears[:5], CHUNK)

    before = (atk.ear_taps.launches, atk.tap_synthesis.launches)
    got = kernels()
    torch.cuda.synchronize()
    check((atk.ear_taps.launches - before[0],
           atk.tap_synthesis.launches - before[1]) == (1, 1),
          "13f: one launch of each tap kernel a call")
    ears, ears_chain = atk.ear_taps(*head), st._ear_taps(*head)
    for f, x, y in zip(st.EarTaps._fields, ears, ears_chain):
        check(torch.equal(x.cpu().reshape(-1).view(torch.uint8),
                          y.cpu().reshape(-1).view(torch.uint8)),
              f"13f: ear-tap table {f} == the card chain's bit for bit")
    want = chain()
    limit = 1e-5 * float(dry.abs().max()) * float(
        ears.g0.abs().sum() + ears.g1.abs().sum())
    gap = float((got - want).abs().max())
    check(gap <= limit, f"13f: taps within the tap limit ({gap} > {limit})")
    check(float(want.abs().max()) > 0, "13f: the chunk has live taps")
    n_kernel = len(device_kernels(torch, kernels))
    n_chain = len(device_kernels(torch, chain))
    check(n_kernel == 2, f"13f: the two tap kernels alone ({n_kernel})")
    ms_kernel, ms_chain = cuda_ms(torch, kernels, 200), cuda_ms(torch, chain,
                                                                 20)
    dev_ears = kernel_device_ms(torch, kernels, 50, "ear_taps_kernel", 1)
    dev_synth = kernel_device_ms(torch, kernels, 50, "tap_synthesis_kernel",
                                 1)
    dev_chain = kernel_device_ms(torch, chain, 20, "", n_chain)
    terms = int(ears.valid.sum()) * 3 * CHUNK
    n_rows = ears.valid.numel() * 3
    n_bytes = (2 * (8 + 1 + 3 * 3 * 4) * ears.j.numel()    # both tables
               + 4 * wd + 4 * 2 * CHUNK                   # window, taps
               + 2 * (4 * 4 * n_rows + ears.valid.numel()))  # rows w + r
    flop_ms = TAP_TERM_FLOP * terms / 67e12 * 1e3
    byte_ms = n_bytes / 3.35e12 * 1e3
    bound_ms = max(flop_ms, byte_ms)
    readings = dict(ms=ms_kernel, ear_taps_device_ms=dev_ears,
                    synthesis_device_ms=dev_synth, chain_ms=ms_chain,
                    chain_device_ms=dev_chain, chain_launches=n_chain,
                    terms=terms, bound_ms=bound_ms, flop_ms=flop_ms,
                    byte_ms=byte_ms, gap=gap, limit=limit)
    print(f"[13f] arrival taps, the headphone chunk [2, {ears.tau0.shape[1]}"
          f", 3, 1] x {CHUNK} (window {wd}): kernels {ms_kernel:.4f} ms a "
          f"call [ear_taps {dev_ears} + synthesis {dev_synth} ms device, 2 "
          f"launches], chain {ms_chain:.4f} ms [{dev_chain} ms device, "
          f"{n_chain} launches]; bound {bound_ms:.6f} ms (operations "
          f"{flop_ms:.6f}: {terms} valid tap terms of "
          f"{2 * ears.tau0.shape[1] * 3 * CHUNK} x {TAP_TERM_FLOP} FLOP; "
          f"bytes {byte_ms:.6f}: {n_bytes} B); table == the card chain's "
          f"bit for bit; taps within {gap:.3e} of the chain's (limit "
          f"{limit:.3e})", flush=True)
    lib = c["build"].load_library()
    table = ptxas_table(c["build"].build_log())
    for which, name in enumerate(("ear_taps_kernel",
                                  "tap_synthesis_kernel")):
        out = (ctypes.c_int * 2)()
        check(lib.art_arrival_taps_attributes(which, out) == 0,
              f"13f: {name} attributes")
        readings[name] = dict(registers=out[0], local_bytes=out[1],
                              ptxas=table.get(name))
        print(f"[13f] {name} registers / local bytes {out[0]} / {out[1]} B,"
              f" ptxas (registers, spill stores, spill loads) "
              f"{table.get(name)}", flush=True)
        check(table.get(name) is not None, f"13f: {name} in the build log")
    return readings


# The barrier cell's diffraction call (samplescene_octave.barrier_walk):
# SampleScene at 44.1 kHz with a 2 s IR, 8 octave bands, order 2, one
# listener on the walk's circle of 4 m about the top wall's right-hand end
BARRIER_SR, BARRIER_T, BARRIER_K = 44100, 88200, 8
BARRIER_CENTRE, BARRIER_RADIUS = np.array([18.5, 14.12]), 4.0
# FP32 operations of the diffraction kernels' bound: a segment (its
# difference, length, two divisions, limit), an edge-table pair test
# (difference, squared length), a candidate path (order 1: d1, d2, d,
# delta, base and the bin; order 2: d12, d, delta1, delta2, base, the
# weights' product and the bin) and a band of it (order 1: n, 3 + 20 n,
# the quotient and the weight; order 2: two n, the two factors, the
# reciprocal and the products)
SEGMENT_FLOP, EDGE_PAIR_FLOP, PATH_FLOP = 9, 5, 21
BAND1_FLOP, BAND2_FLOP = 8, 16


def barrier_pose(i, n=16):
    a = 2.0 * np.pi * i / n
    return BARRIER_CENTRE + BARRIER_RADIUS * np.array([np.cos(a),
                                                       np.sin(a)])


def diffraction_phase(c):
    """Phase 13g: edge diffraction's kernels (``diffraction_segments_
    kernel``, K2 a sweep an order, ``diffraction_bin_kernel``, through
    ``ops/cuda/diffraction_kernel.py::add_paths``) beside the plain chain
    (``use_kernels=False``, some 350 launches) at the barrier cell's call:
    SampleScene, ``[1, 88,200, 8]``, order 2. ``diffraction_ir`` equals
    the chain's bit for bit at the 16 poses of the walk's circle (some
    shadowed, some lit); one ``add_diffraction`` call into a random IR,
    counts set to 0 just before, launches K2 twice and each diffraction
    kernel once, makes no sync or copy, and equals the chain's ``ir +
    diffraction_ir`` bit for bit; ms a call of both (CUDA events), each
    kernel's device ms and the chain's (profiler); each kernel's bound,
    the larger of its FP32 operations over 67 TFLOP/s and its bytes over
    3.35 TB/s (``SEGMENT_FLOP`` .. ``BAND2_FLOP``, K2's wall tests as in
    the other phases, the kept paths' records and keys and a
    read-modify-write of each IR bin they touch), and its share;
    registers and spills from the build log. ``c`` holds the objects of
    main() (``torch``, ``art``, ``build``, ``dev``, ``counted``,
    ``only``). Returns the readings."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
    torch, art, dev = c["torch"], c["art"], c["dev"]
    counted, only = c["counted"], c["only"]
    room = art.rooms.sample_scene(n_bands=BARRIER_K, device=dev)
    scene = room.scene
    engine = art.Engine(scene, art.sample_scene_config(n_bands=BARRIER_K))
    kw = dict(sample_rate=BARRIER_SR, order=2)
    heard = []
    for i in range(16):
        p_i = engine.params(room.source, barrier_pose(i))
        got = dfr.diffraction_ir(scene, p_i, ir_length=BARRIER_T, **kw)
        want = dfr.diffraction_ir(scene, p_i, ir_length=BARRIER_T,
                                  use_kernels=False, **kw)
        check(torch.equal(got, want), f"13g: pose {i}: diffraction_ir == "
                                      f"the card chain's bit for bit")
        heard.append(bool(want.any()))
    check(0 < sum(heard) < 16, f"13g: the walk is shadowed and lit {heard}")
    p = engine.params(room.source, barrier_pose(6))
    cur = torch.rand((1, BARRIER_T, BARRIER_K), device=dev,
                     generator=torch.Generator(dev).manual_seed(28))
    got = cur.clone()
    _, launched = counted(lambda: dfr.add_diffraction(got, scene, p, **kw))
    check(launched == only(K2=2, D3seg=1, D3bin=1),
          f"13g: launches of one call {launched}")
    want = dfr.add_diffraction(cur, scene, p, use_kernels=False, **kw)
    check(torch.equal(got, want) and bool((got != cur).any()),
          "13g: the call == the card chain's ir + diffraction_ir bit for "
          "bit, and adds paths")
    work = cur.clone()

    def kernels():
        dfr.add_diffraction(work, scene, p, **kw)

    def chain():
        return dfr.add_diffraction(cur, scene, p, use_kernels=False, **kw)

    kernels()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("diffraction_call"):
            kernels()
        torch.cuda.synchronize()
    host = list(prof.events())
    call = [e for e in host if e.name == "diffraction_call"]
    check(len(call) == 1, "13g: the profiled call's range")
    t0, t1 = call[0].time_range.start, call[0].time_range.end
    inside = [e.name for e in host if t0 <= e.time_range.start <= t1]
    stalls = [n for n in inside if "Synchronize" in n or "Memcpy" in n
              or "index_put" in n or "nonzero" in n]
    check(not stalls, f"13g: no sync or copy inside the call {stalls}")
    n_kernel = len(device_kernels(torch, kernels))
    n_chain = len(device_kernels(torch, chain))
    check(n_kernel == 4, f"13g: the four launches alone ({n_kernel})")
    ms_kernel, ms_chain = cuda_ms(torch, kernels, 200), cuda_ms(torch, chain,
                                                                 20)
    dev_ms = {"diffraction_segments_kernel": kernel_device_ms(
                  torch, kernels, 50, "diffraction_segments_kernel", 1),
              "wall_sweep_kernel": kernel_device_ms(
                  torch, kernels, 50, "wall_sweep_kernel", 2),
              "diffraction_bin_kernel": kernel_device_ms(
                  torch, kernels, 50, "diffraction_bin_kernel", 1)}
    dev_chain = kernel_device_ms(torch, chain, 20, "", n_chain)
    # the work of the call, from its inputs and the chain's paths
    n_w, n_l, n_k = scene.n_walls, 1, BARRIER_K
    n_e = 2 * n_w
    n_seg = n_e + n_l + n_l * n_e + n_e * n_e
    freqs = dfr.band_frequencies(n_k)
    kept = sum(int(v.sum()) for v in (
        dfr.diffraction_paths(scene, p, freqs, False)[2],
        dfr.diffraction_paths2(scene, p, freqs, False)[2]))
    touched = int(dfr.diffraction_ir(scene, p, ir_length=BARRIER_T,
                                     use_kernels=False, **kw)
                  .ne(0).any(-1).sum())
    cap = 1 << (n_e + n_e * n_e - 1).bit_length()
    work_of = {
        "diffraction_segments_kernel": (
            SEGMENT_FLOP * n_seg + EDGE_PAIR_FLOP * n_e * n_e,
            4 * 4 * n_w + n_w + 4 * 2 * (1 + n_l)            # walls, points
            + 4 * (5 * n_w + 5 * n_e) + 4 * 5 * n_seg),      # tables, rays
        "wall_sweep_kernel": (
            OPS_PER_TEST * n_seg * n_w + OPS_PER_SWEEP * n_seg,
            4 * (5 * n_seg + 5 * n_w + n_seg)),              # rays, walls, t
        "diffraction_bin_kernel": (
            n_l * (n_e * (PATH_FLOP + BAND1_FLOP * n_k)
                   + n_e * n_e * (PATH_FLOP + BAND2_FLOP * n_k)),
            4 * (n_seg + n_e + 4 * n_w + 2 * (1 + n_l) + n_k)  # distances..
            + 2 * 4 * 5 * kept + 2 * 8 * kept                # records, keys
            + 2 * 4 * n_k * touched)}                        # the IR bins
    readings = dict(ms=ms_kernel, chain_ms=ms_chain,
                    chain_device_ms=dev_chain, chain_launches=n_chain,
                    kept=kept, touched=touched, segments=n_seg, heard=heard)
    parts = []
    for name, (flop, n_bytes) in work_of.items():
        flop_ms = flop / PEAK_FP32 * 1e3
        byte_ms = n_bytes / PEAK_BYTES * 1e3
        bound_ms = max(flop_ms, byte_ms)
        d = dev_ms[name]
        share = None if not d else bound_ms / d
        readings[name] = dict(device_ms=d, bound_ms=bound_ms, flop=flop,
                              bytes=n_bytes, share=share)
        parts.append(f"{name} {d} ms device, bound {bound_ms:.3e} ms "
                     f"({'operations' if flop_ms >= byte_ms else 'bytes'}: "
                     f"{flop} FLOP, {n_bytes} B), share "
                     f"{'n/a' if share is None else f'{100 * share:.4f}%'}")
    total = (None if None in dev_ms.values()
             else sum(dev_ms.values()))
    bound_all = sum(r["bound_ms"] for r in readings.values()
                    if isinstance(r, dict))
    readings.update(device_ms=total, bound_ms=bound_all)
    print(f"[13g] diffraction, the barrier call [{n_l}, {BARRIER_T}, {n_k}] "
          f"order 2 ({n_w} walls, {n_seg} segments, {n_e + n_e * n_e} "
          f"candidate paths, {kept} kept in {touched} bins, key capacity "
          f"{cap}): kernels {ms_kernel:.4f} ms a call [{total} ms device, "
          f"{n_kernel} launches], chain {ms_chain:.4f} ms [{dev_chain} ms "
          f"device, {n_chain} launches]; " + "; ".join(parts)
          + f"; the call's bound {bound_all:.3e} ms, share "
          f"{'n/a' if not total else f'{100 * bound_all / total:.4f}%'}; "
          f"== the card chain bit for bit at 16 poses ({sum(heard)} heard) "
          f"and in place", flush=True)
    table = ptxas_table(c["build"].build_log())
    for name in ("diffraction_segments_kernel", "diffraction_bin_kernel"):
        readings[name]["ptxas"] = table.get(name)
        print(f"[13g] {name} ptxas (registers, spill stores, spill loads) "
              f"{table.get(name)}", flush=True)
        check(table.get(name) is not None, f"13g: {name} in the build log")
    return readings


def per_arrival_limit(peak, dry, d_res, d_tap, n_taps, n_bands=1,
                      max_shift=None, shadow=0.6):
    """The largest gap between two per-arrival streams whose tap tables
    (bins and validity) are equal, chunk by chunk, and whose traced IRs
    differ by rounding. The residual convolution moves by at most ``sum
    |dry| * d_res`` (linear in the residual; the crossfade a convex mix);
    each tap bin adds its gain's gap times the largest read, ``max |dry|``
    (a brickwall band of the dry reads no more), over the current and the
    fading taps' 3 bins in every band. A mono tap's gain is an IR value
    (gap ``d_tap``). A binaural ear tap's (``max_shift`` given) comes from
    its W/X/Y window (gap ``d_tap``): the coherent gain ``min(|XY|, W) (1
    +- shadow sin)`` moves by at most ``5 d_tap`` and its read by ``|d
    tau| 2 max|dry|`` with ``|d tau| <= max_shift |d sin|`` and ``|d sin|
    <= 2 d_tap / |XY|``, weighed by a gain of at most ``(1 + shadow)
    |XY|``; the diffuse gain ``W - coherent`` by ``3 d_tap``. Plus 2e-6 of
    the peak for the FFTs (the mono stream's own limit)."""
    if max_shift is None:
        per_bin = d_tap
    else:
        per_bin = (8.0 + 4.0 * (1.0 + shadow) * max_shift) * d_tap
    rows = 2 * n_taps * 3 * n_bands
    return (2e-6 * peak + float(dry.abs().sum()) * d_res
            + rows * float(dry.abs().max()) * per_bin)


def doppler_phase(c):
    """Phase 14: per-arrival and shared-rate Doppler streams at full width
    (SmollRoom 15,000 x 5, 48 kHz, 72,000 bins, 4,800-sample chunks).
    ``c`` holds the objects of main(). Returns the launch counts of its
    paths and its readings."""
    torch, art, cli = (c[k] for k in ("torch", "art", "cli"))
    dev, counted, only, card = (c[k] for k in (
        "dev", "counted", "only", "card"))
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        click_clip, read_wav, write_wav)
    slice_launches = {k: 0 for k in only()}
    readings = {}

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=RAYS)
    eng = art.Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener)
    src = np.float32(room.source)
    lis = np.float32(room.listener).reshape(-1)[:2]
    toward = (lis - src) / np.linalg.norm(lis - src)
    dt = cfg.audio.chunk_duration
    clicks = (0.1, 0.7, 1.3)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=clicks),
                          device=dev)
    n_chunks = 20 + 15

    def approaching(engine):
        def poses(i):          # the source toward the listener at 2 m/s
            return engine.params(src + np.float32(toward * 2.0 * dt * i),
                                 lis)
        return poses

    def run(scene, config, poses, backend="auto", seen=None, n=None, **kw):
        """A per-arrival stream; ``seen`` collects each chunk's IR and
        carry (copies: the state is updated in place)."""
        def grab(i, st):
            seen.append([st.prev_ir.clone()] + [
                x.clone() for x in st.arrival.tensors()])
        return art.Streamer(scene, config, seed=61, backend=backend,
                            **kw).stream_clip(
            dry, poses, total_chunks=n, doppler="per_arrival",
            facing_fn=(lambda i: 0.4 - 0.05 * i) if kw.get("binaural")
            else None, on_chunk=None if seen is None else grab)

    def tables_and_gaps(tag, seen_k, seen_p):
        """Check the tap tables equal chunk by chunk; return the IR,
        residual and tap-window gaps and the live taps' count."""
        d_ir = d_res = d_tap = 0.0
        live = 0
        for a, b in zip(seen_k, seen_p):
            ir_a, res_a, idx_a, g3_a, val_a = a[:5]
            ir_b, res_b, idx_b, g3_b, val_b = b[:5]
            check(torch.equal(idx_a, idx_b) and torch.equal(val_a, val_b),
                  f"{tag}: tap tables equal, chunk by chunk")
            live += int(val_a.sum())
            d_ir = max(d_ir, float((ir_a - ir_b).abs().max()))
            d_res = max(d_res, float((res_a - res_b).abs().max()))
            d_tap = max([d_tap] + [float((x - y).abs().max())
                                   for x, y in zip(a[3:], b[3:])
                                   if x.dtype == torch.float32])
        return d_ir, d_res, d_tap, live

    # 14a. 2.0 s of clicks through the per-arrival stream, the source
    # approaching at 2 m/s: K4 once a chunk; bit-identical on a rerun;
    # against its plain twin
    poses = approaching(eng)
    seen_k, seen_p = [], []
    wet, launched = counted(lambda: run(room.scene, cfg, poses,
                                        seen=seen_k))
    check(launched == only(K4=n_chunks), f"14a: per-arrival stream "
          f"launches {launched}")
    add(launched)
    again, _ = counted(lambda: run(room.scene, cfg, poses))
    check(torch.equal(wet, again), "14a: per-arrival stream rerun "
          "bit-identical")
    wet_p, launched_p = counted(lambda: run(room.scene, cfg, poses,
                                            backend="plain", seen=seen_p))
    check(launched_p == only(), f"14a: plain twin launched {launched_p}")
    d_ir, d_res, d_tap, live = tables_and_gaps("14a", seen_k, seen_p)
    check(d_res <= d_ir and d_tap <= d_ir, "14a: the residuals and tap "
          "windows differ only where the IRs do")
    out, out_p = wet.cpu().numpy(), wet_p.cpu().numpy()
    check(out.shape == (1, n_chunks * CHUNK) and np.isfinite(out).all()
          and np.abs(out).max() > 0 and live > 0,
          f"14a: stream {out.shape} finite, {live} live taps")
    lim = per_arrival_limit(np.abs(out_p).max(), dry, d_res, d_tap,
                            art.streaming._ARRIVAL_TAPS)
    gap = float(np.abs(out - out_p).max())
    plain_stream = art.Streamer(room.scene, cfg, seed=61).stream_clip(
        dry, poses).cpu().numpy()
    moved = float(np.abs(out - plain_stream).max())
    print(f"[14a] per-arrival stream: SmollRoom, the source approaching at "
          f"2 m/s, {n_chunks} chunks -> {out.shape}, launches {launched}, "
          f"rerun bit-identical, {live} live taps over the chunks, tap "
          f"tables == the plain twin's in every chunk; IR gap {d_ir:.3e}, "
          f"residual {d_res:.3e}, tap windows {d_tap:.3e}; audio max abs "
          f"{gap:.3e} (limit {lim:.3e}: sum|dry| x the residual gap + the "
          f"tap bins' gain gaps x max|dry| + 2e-6 of the peak); against "
          f"the stream without Doppler {moved:.3e} of peak "
          f"{np.abs(out).max():.3e}", flush=True)
    check(gap <= lim, "14a: per-arrival stream == its plain twin")
    check(moved > lim, "14a: the taps glide (not the plain stream)")
    del seen_k, seen_p, again, wet_p

    # 14b. the binaural x 8-band per-arrival stream, 4 chunks, against its
    # plain twin: tap tables equal, decoded residuals within decode_limit
    room8 = art.rooms.smoll_room(n_bands=8, device=dev)
    cfg8 = art.smoll_room_config(ray_count=RAYS, n_bands=8)
    poses8 = approaching(art.Engine(room8.scene, cfg8))
    seen_k, seen_p = [], []
    wet8, launched8 = counted(lambda: run(
        room8.scene, cfg8, poses8, seen=seen_k, n=4, binaural=True))
    check(launched8 == only(K4=4), f"14b: launches {launched8}")
    add(launched8)
    wet8_p, _ = counted(lambda: run(room8.scene, cfg8, poses8,
                                    backend="plain", seen=seen_p, n=4,
                                    binaural=True))
    _, d_res8, d_tap8, live8 = tables_and_gaps("14b", seen_k, seen_p)
    w_max = max(float(b[1].abs().max()) for b in seen_p)
    lim_res = decode_limit(w_max, T) + 1e-6 * w_max
    out8, out8_p = wet8.cpu().numpy(), wet8_p.cpu().numpy()
    max_shift = 0.0875 / 343.0 * SR
    lim8 = per_arrival_limit(np.abs(out8_p).max(), dry, d_res8, d_tap8,
                             art.streaming._ARRIVAL_TAPS, n_bands=8,
                             max_shift=max_shift)
    gap8 = float(np.abs(out8 - out8_p).max())
    print(f"[14b] binaural x 8-band per-arrival stream: 4 chunks -> "
          f"{out8.shape}, launches {launched8}, {live8} live taps, tap "
          f"tables == the plain twin's; decoded residual gap {d_res8:.3e} "
          f"(limit {lim_res:.3e}), tap windows {d_tap8:.3e}; audio max abs "
          f"{gap8:.3e} (limit {lim8:.3e}); ear energies "
          f"{float((out8[0] ** 2).sum()):.4e} / "
          f"{float((out8[1] ** 2).sum()):.4e}", flush=True)
    check(out8.shape == (2, 4 * CHUNK) and np.isfinite(out8).all()
          and live8 > 0 and not np.allclose(out8[0], out8[1]),
          "14b: two distinct, finite ears with live taps")
    check(d_res8 <= lim_res, "14b: decoded residuals within the decode "
          "limit")
    check(gap8 <= lim8, "14b: binaural x 8-band stream == its plain twin")
    del seen_k, seen_p, room8

    # 14c. doppler=True: a 400 Hz tone, the source receding at 0.1 c down
    # the listener-source axis, comes out at 360 Hz (the JAX test's check);
    # without Doppler at 400 Hz
    f0, v = 400.0, 34.3
    tone = torch.as_tensor((np.sin(2 * np.pi * f0 * np.arange(
        int(0.6 * SR)) / SR) * 0.5).astype(np.float32), device=dev)

    def receding(i):
        return eng.params(src - np.float32(toward * v * dt * i), lis)

    def peak_hz(wet_):
        seg = wet_.cpu().numpy()[0, int(0.1 * SR):int(0.5 * SR)]
        spec = np.abs(np.fft.rfft(seg * np.hanning(seg.size)))
        return float(np.argmax(spec) * SR / seg.size)

    n_tone = -(-tone.shape[-1] // CHUNK) + -(-T // CHUNK)
    dopp, launched_c = counted(lambda: art.Streamer(
        room.scene, cfg, seed=62).stream_clip(tone, receding, doppler=True))
    check(launched_c == only(K4=n_tone), f"14c: launches {launched_c}")
    add(launched_c)
    flat = art.Streamer(room.scene, cfg, seed=62).stream_clip(tone,
                                                              receding)
    hz, hz_flat = peak_hz(dopp), peak_hz(flat)
    want_hz = f0 * (1.0 - v / 343.0)
    print(f"[14c] doppler=True, a {f0:g} Hz tone, the source receding at "
          f"{v} m/s: peak {hz:.1f} Hz (want {want_hz:.1f} +- 12), without "
          f"Doppler {hz_flat:.1f} (want {f0:g} +- 12); launches "
          f"{launched_c}", flush=True)
    check(abs(hz - want_hz) < 12.0 and abs(hz_flat - f0) < 12.0,
          "14c: the receding source's pitch is lowered by 1 - v/c")

    # 14d. 220 chunks each of the mono, per-arrival mono and per-arrival
    # binaural streams (static poses, as [13b]): ms per chunk, device-busy
    # ms, cudaLaunchKernel calls and device kernels per chunk
    rows = {}
    for name, make, facing, doppler in (
            ("mono", lambda: art.Streamer(room.scene, cfg, seed=63), None,
             False),
            ("per-arrival mono", lambda: art.Streamer(room.scene, cfg,
                                                      seed=63), None,
             "per_arrival"),
            ("per-arrival binaural", lambda: art.Streamer(
                room.scene, cfg, seed=63, binaural=True),
             lambda i: 0.4 - 0.05 * i, "per_arrival")):
        rows[name] = stream_timings(torch, make, dry, lambda i: p,
                                    facing=facing, doppler=doppler)
    readings["stream"] = rows
    print(f"[14d] timings on {card}: ms per 100 ms chunk (synced, 220 "
          "chunks) median / p99, device busy ms per chunk, cudaLaunchKernel"
          " and device kernels per chunk (profiler, 10 chunks): " + "; ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}, busy {v[2]:.4f}, "
              f"{v[3]:.1f} launches, {v[4]:.1f} kernels"
              for k, v in rows.items()), flush=True)

    # 14e. the CLI: stream --doppler-per-arrival and stream --doppler, the
    # source moving at 2 m/s for 1 s (10 chunks: K4 once a chunk)
    cli_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(n):
            return os.path.join(tmp, n)

        write_wav(path("d.wav"), click_clip(1.0, 44100,
                                            click_times=(0.1, 0.6)), 44100)
        for name, flag in (("stream --doppler-per-arrival",
                            "--doppler-per-arrival"),
                           ("stream --doppler", "--doppler")):
            argv = ["stream", "--room", "smoll", "--in", path("d.wav"),
                    "--out", path("s.wav"), "--move-source", "2,0",
                    "--duration", "1", flag]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launched = counted(lambda: cli.main(argv))
            cli_s[name] = time.perf_counter() - t0
            check(launched == only(K4=10), f"14e: cli {name} launches "
                  f"{launched}")
            add(launched)
            x, rate = read_wav(path("s.wav"))
            check(rate == SR and x.shape == (10 * CHUNK,)
                  and np.isfinite(x).all() and np.abs(x).max() > 0,
                  f"14e: cli {name} wav {x.shape}")
            xrt = re.search(r"\(([0-9.]+)x realtime\)",
                            buf.getvalue()).group(1)
            cli_s[name] = (cli_s[name], xrt)
    readings["cli"] = cli_s
    print(f"[14e] cli on {card} (launches checked: 10 K4 each): "
          + ", ".join(f"{k} {v[0]:.2f} s ({v[1]}x realtime)"
                      for k, v in cli_s.items()), flush=True)
    return slice_launches, readings



class RingTwin:
    """The plain reference of the native ring (``AudioManager.cs:45-69``):
    writes add at their offset mod the size, reads copy and zero from the
    read head. NumPy, one float32 add per sample as the C++ ring makes."""

    def __init__(self, size, channels):
        self.data = np.zeros((channels, size), np.float32)
        self.head = 0

    def push(self, x, offset):
        idx = (offset + np.arange(x.shape[-1])) % self.data.shape[1]
        np.add.at(self.data, (slice(None), idx), np.float32(x))

    def drain(self, n):
        idx = (self.head + np.arange(n)) % self.data.shape[1]
        out = self.data[:, idx].copy()
        self.data[:, idx] = 0.0
        self.head = (self.head + n) % self.data.shape[1]
        return out


def live_phase(c):
    """Phase 15: the live pipeline at the shipped shape (SmollRoom 15,000 x
    5, 48 kHz, 72,000 bins, 4,800-sample chunks): the native runtime, the
    player against the stream in integrity mode, realtime runs, the pose
    feed written while a run plays, and the CLI. ``c`` holds the objects
    of main(). Returns the launch counts of its paths and its readings."""
    torch, art, cli = (c[k] for k in ("torch", "art", "cli"))
    dev, counted, only, card = (c[k] for k in (
        "dev", "counted", "only", "card"))
    import threading
    from realisticaudioraytracing2d_tpu_torch import native
    from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
    from realisticaudioraytracing2d_tpu_torch.posefeed import PoseFeed
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        click_clip, read_wav, write_wav)
    slice_launches = {k: 0 for k in only()}
    readings = {}
    t_phase = time.perf_counter()

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    # 15a. the native runtime: built into build/torch_native, its ring
    # against the NumPy twin across the wrap, 2 channels, bit for bit
    check(native.available(), "15a: the native library built (g++)")
    lib = native.library_path()
    check(lib.exists() and str(lib.parent.resolve()) == os.path.realpath(
        os.path.join(HERE, "build", "torch_native")),
        f"15a: library at {lib}")
    rng_np = np.random.default_rng(15)
    ring, twin = native.NativeRingBuffer(997, 2), RingTwin(997, 2)
    offset, drained = 0, 0
    for _ in range(200):
        x = rng_np.normal(size=(2, int(rng_np.integers(1, 900)))).astype(
            np.float32)
        at = offset + int(rng_np.integers(0, 400))
        ring.push(x, at)
        twin.push(x, at)
        n_d = int(rng_np.integers(1, 500))
        got, want = ring.drain(n_d), twin.drain(n_d)
        check(np.array_equal(got, want), "15a: native ring == NumPy twin")
        offset += n_d
        drained += n_d
    check(ring.read_head == twin.head, "15a: read heads equal")
    mp3, sink = native.mp3_probe(), native.sink_probe()
    print(f"[15a] native runtime {lib.relative_to(HERE)}: ring == NumPy twin "
          f"bit for bit over 200 push/drain pairs ({drained} samples, "
          f"wrapped {drained // 997}x, 2 channels); mp3_probe (decode, "
          f"encode) = {mp3}; sink_probe = {sink}", flush=True)

    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=RAYS)
    eng = art.Engine(room.scene, cfg)
    src = np.float32(room.source)
    lis = np.float32(room.listener).reshape(-1)[:2]
    toward = (lis - src) / np.linalg.norm(lis - src)
    dt = cfg.audio.chunk_duration
    clicks = (0.1, 0.7, 1.3)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=clicks),
                          device=dev)
    n_chunks = 20 + 15

    def approaching(i):        # the source toward the listener at 2 m/s
        return eng.params(src + np.float32(toward * 2.0 * dt * i), lis)

    p = eng.params(room.source, room.listener)
    modes = {
        "mono": ({}, dict(params_fn=lambda i: p)),
        "binaural": (dict(binaural=True),
                     dict(params_fn=lambda i: p,
                          facing_fn=lambda i: 0.5 * dt * i)),
        "per-arrival": ({}, dict(params_fn=approaching,
                                 doppler="per_arrival")),
    }

    # 15b. integrity mode: the player == stream_clip of the same seed,
    # K4 once a chunk; the 10,008-wall city through K8
    gaps = {}
    for name, (pkw, rkw) in modes.items():
        rep, launched = counted(lambda: LivePlayer(
            room.scene, cfg, seed=71, **pkw).run(
                dry, total_chunks=n_chunks, loop=False, **rkw))
        check(launched == only(K4=n_chunks), f"15b: live {name} launches "
              f"{launched}")
        add(launched)
        want = art.Streamer(room.scene, cfg, seed=71, **pkw).stream_clip(
            dry, loop=False, total_chunks=n_chunks, **rkw).cpu().numpy()
        check(rep.audio.shape == want.shape and rep.underruns == 0
              and rep.late_samples == 0 and np.abs(want).max() > 0,
              f"15b: live {name} {rep.audio.shape}, {rep.summary()}")
        gaps[name] = (float(np.abs(rep.audio - want).max()),
                      bool(np.array_equal(rep.audio, want)),
                      {k: v for k, v in launched.items() if v})
        check(gaps[name][0] <= 1e-6, f"15b: live {name} == its stream "
              f"within 1e-6 ({gaps[name][0]:.3e})")
    scene_9, p_9 = c["scene_9"], c["p_9"]
    rep9, launched9 = counted(lambda: LivePlayer(scene_9, cfg, seed=72).run(
        dry, total_chunks=10, loop=False, params_fn=lambda i: p_9))
    check(launched9 == only(K8=10 * BOUNCES), f"15b: city live launches "
          f"{launched9}")
    add(launched9)
    want9 = art.Streamer(scene_9, cfg, seed=72).stream_clip(
        dry, lambda i: p_9, loop=False, total_chunks=10).cpu().numpy()
    gaps["city"] = (float(np.abs(rep9.audio - want9).max()),
                    bool(np.array_equal(rep9.audio, want9)),
                    {k: v for k, v in launched9.items() if v})
    check(gaps["city"][0] <= 1e-6 and np.abs(want9).max() > 0,
          "15b: city live == its stream within 1e-6")
    same = {True: "bit-equal", False: "not bit-equal"}
    print("[15b] integrity mode, live == stream_clip (same seed; limit 1e-6):"
          + "; ".join(f" {k} max abs {v[0]:.3e} ({same[v[1]]}), launches "
                      f"{v[2]}" for k, v in gaps.items()), flush=True)

    # 15c. realtime mode, 3 s each (prime 1): mono must show no underrun;
    # each mode's realtime factor, step ms, lead, late samples, and its
    # cudaLaunchKernel per chunk (profiler, 10 integrity-mode chunks)
    rt = {}
    for name, (pkw, rkw) in modes.items():
        player = LivePlayer(room.scene, cfg, seed=73, **pkw)
        rep = player.run(dry, total_chunks=30, loop=True, realtime=True,
                         prime=1, **rkw)
        check(rep.chunks == 30 and rep.audio.shape[-1] == 30 * CHUNK,
              f"15c: realtime {name}: {rep.summary()}")
        busy, calls, kernels = chunk_profile(torch, lambda: LivePlayer(
            room.scene, cfg, seed=74, **pkw).run(
                dry, total_chunks=10, loop=True, **rkw), 10)
        steps = rep.step_ms[1:]
        rt[name] = dict(underruns=rep.underruns,
                        realtime_factor=rep.realtime_factor,
                        step_p50=float(np.median(steps)),
                        step_p99=float(np.percentile(steps, 99)),
                        step_first=float(rep.step_ms[0]),
                        max_lead=rep.max_lead_samples,
                        late=rep.late_samples, launches=calls,
                        kernels=kernels, busy_ms=busy)
    readings["realtime"] = rt
    print(f"[15c] realtime, 3 s each (30 chunks, prime 1) on {card}: " +
          "; ".join(f"{k}: {v['underruns']} underruns, producer "
                    f"{v['realtime_factor']:.2f}x realtime (the ring's "
                    f"backpressure included), step ms p50 {v['step_p50']:.3f}"
                    f" / p99 {v['step_p99']:.3f} (chunk 0 "
                    f"{v['step_first']:.1f}), peak lead {v['max_lead']} "
                    f"samples, {v['late']} late samples, "
                    f"{v['launches']:.1f} cudaLaunchKernel, "
                    f"{v['kernels']:.1f} device kernels and busy "
                    f"{v['busy_ms']:.4f} ms a chunk" for k, v in rt.items()),
          flush=True)
    check(rt["mono"]["underruns"] == 0, "15c: mono realtime run has no "
          "underrun after the prebuffer")

    with tempfile.TemporaryDirectory() as tmp:
        def path(n):
            return os.path.join(tmp, n)

        # 15d. a writer thread appends the pose feed while an integrity
        # run plays (each line three chunks before it is due: on_chunk
        # hands off to the writer and waits for it); the output equals
        # stream_clip under a feed replayed from the finished file
        lines = [(5, {"chunk": 5, "source": [-15.0, 6.0]}),
                 (8, {"chunk": 8, "listener": [2.0, -2.5]}),
                 (10, {"chunk": 10, "obstacle": "Wall (4)",
                       "position": [-9.0, 5.0], "angle": 0.2}),
                 (12, {"chunk": 12, "command": "reset_ir"}),
                 (20, {"chunk": 20, "command": "stop"})]
        feed_path = path("feed.jsonl")
        open(feed_path, "w").close()
        done = threading.Condition()
        state = {"chunk": -1, "written": 0}

        def writer():
            for due, obj in lines:
                with done:
                    done.wait_for(lambda: state["chunk"] >= due - 3,
                                  timeout=60)
                with open(feed_path, "a") as f:
                    f.write(json.dumps(obj) + "\n")
                with done:
                    state["written"] += 1
                    done.notify_all()

        def handoff(i, _ir):
            with done:
                state["chunk"] = i
                done.notify_all()
                need = sum(1 for due, _ in lines if due - 3 <= i)
                check(done.wait_for(lambda: state["written"] >= need,
                                    timeout=60), "15d: the writer keeps up")

        def steered(feed):
            feed.bind_scene(room.builder)
            return dict(params_fn=lambda i: feed.params(p, i),
                        scene_fn=lambda i: feed.scene(room.scene, i),
                        control_fn=feed.control)

        feed = PoseFeed.open(feed_path)
        wt = threading.Thread(target=writer)
        wt.start()
        rep_d, launched_d = counted(lambda: LivePlayer(
            room.scene, cfg, seed=75).run(dry, total_chunks=40, loop=False,
                                          on_chunk=handoff, **steered(feed)))
        wt.join(timeout=60)
        check(not wt.is_alive() and state["written"] == len(lines),
              "15d: every feed line written")
        feed.close()
        add(launched_d)
        replay = PoseFeed.open(feed_path)
        want_d = art.Streamer(room.scene, cfg, seed=75).stream_clip(
            dry, loop=False, total_chunks=40, **steered(replay)
        ).cpu().numpy()
        replay.close()
        plain_d = art.Streamer(room.scene, cfg, seed=75).stream_clip(
            dry, lambda i: p, loop=False, total_chunks=40).cpu().numpy()
        n_d = 20 + 15                   # stopped at 20 + the tail
        check(rep_d.audio.shape == want_d.shape == (1, n_d * CHUNK),
              f"15d: {rep_d.summary()}, stream {want_d.shape}")
        gap_d = float(np.abs(rep_d.audio - want_d).max())
        moved_d = float(np.abs(rep_d.audio - plain_d[:, :n_d * CHUNK]).max())
        print(f"[15d] pose feed written while live plays (source at 5, "
              f"listener at 8, Wall (4) dragged at 10, reset_ir at 12, stop "
              f"at 20): {rep_d.chunks} chunks, K4 launches "
              f"{launched_d['K4']}; "
              f"against stream_clip under the replayed feed max abs "
              f"{gap_d:.3e} ({same[bool(np.array_equal(rep_d.audio, want_d))]}"
              f"); against the unsteered stream {moved_d:.3e}", flush=True)
        check(rep_d.chunks == n_d and launched_d == only(K4=n_d),
              f"15d: {rep_d.summary()}, launches {launched_d}")
        check(gap_d <= 1e-6, "15d: steered live == the replayed stream")
        check(moved_d > 1e-6, "15d: the steering moved the audio")

        # 15e. the CLI: live (mono; binaural per-arrival), stream
        # --pose-feed, bake with the bundled clip, --scene-json on an
        # exported SmollRoom, live --play
        write_wav(path("d.wav"), click_clip(1.0, 44100,
                                            click_times=(0.1, 0.6)), 44100)
        spec = {"source": [float(v) for v in room.source],
                "listener": [float(v) for v in room.listener],
                "colliders": [dict(
                    name=col.name, type="box",
                    position=list(col.transform.position),
                    angle=col.transform.angle,
                    scale=list(col.transform.scale),
                    material=dict(absorption=col.material.absorption,
                                  scattering=col.material.scattering,
                                  transmission=col.material.transmission,
                                  ior=col.material.ior))
                    for col in room.builder.colliders]}
        with open(path("scene.json"), "w") as f:
            json.dump(spec, f)
        exported = cli.load_scene_json(spec, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(exported.scene,
                                                    room.scene)),
              "15e: the exported SmollRoom loads to its walls")
        with open(path("cli_feed.jsonl"), "w") as f:
            f.write(json.dumps({"chunk": 3, "obstacle": "Wall (4)",
                                "position": [-9.0, 5.0]}) + "\n"
                    + json.dumps({"chunk": 6, "command": "stop"}) + "\n")
        runs = [
            ("live", ["live", "--room", "smoll", "--in", path("d.wav"),
                      "--duration", "1", "--out", path("l.wav")],
             only(K4=10), (10 * CHUNK,)),
            ("live --binaural 0 --doppler-per-arrival",
             ["live", "--room", "smoll", "--in", path("d.wav"),
              "--duration", "1", "--binaural", "0", "--move-source", "2,0",
              "--doppler-per-arrival", "--out", path("l2.wav")],
             only(K4=10), (10 * CHUNK, 2)),
            ("stream --pose-feed", ["stream", "--room", "smoll", "--in",
                                    path("d.wav"), "--pose-feed",
                                    path("cli_feed.jsonl"), "--out",
                                    path("s.wav")],
             only(K4=6 + 15), ((6 + 15) * CHUNK,)),    # stopped at 6
            ("bake (the bundled clip)", ["bake", "--room", "smoll", "--out",
                                         path("b.wav")],
             only(K4=1), (SR + T,)),
            ("stream --scene-json", ["stream", "--scene-json",
                                     path("scene.json"), "--in",
                                     path("d.wav"), "--duration", "1",
                                     "--out", path("j.wav")],
             only(K4=10), (10 * CHUNK,))]
        cli_s = {}
        for name, argv, want_l, shape in runs:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launched = counted(lambda: cli.main(argv))
            cli_s[name] = time.perf_counter() - t0
            check(launched == want_l, f"15e: cli {name} launches {launched}")
            add(launched)
            x, rate = read_wav(argv[argv.index("--out") + 1])
            check(rate == SR and x.shape == shape and np.isfinite(x).all()
                  and np.abs(x).max() > 0, f"15e: cli {name} wav {x.shape}")
            if name.startswith("live"):
                check("(0 underruns)" in buf.getvalue(), f"15e: cli {name}: "
                      f"{buf.getvalue().strip()}")
        # live (integrity mode) hears the stream of the same seed, and the
        # exported SmollRoom is SmollRoom
        check(np.array_equal(read_wav(path("l.wav"))[0],
                             read_wav(path("j.wav"))[0]),
              "15e: cli live == cli stream --scene-json of the exported room")
        t0 = time.perf_counter()
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["live", "--room", "smoll", "--in", path("d.wav"),
                          "--duration", "1", "--play"])
            played = f"played: {buf.getvalue().strip()}"
        except SystemExit as e:
            # the degrade path: no sound system on this machine
            check(str(e).startswith("--play: audio sink"), f"15e: --play "
                  f"exited with {e}")
            played = f"exited: {e}"
        cli_s["live --play"] = time.perf_counter() - t0
    readings["cli"] = cli_s
    print(f"[15e] cli on {card}, seconds (launches checked): " + ", ".join(
        f"{k} {v:.2f}" for k, v in cli_s.items()) + f"; live --play {played}",
        flush=True)
    print(f"[15] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return slice_launches, readings


def diff_phase(c):
    """Phase 16: differentiable acoustics (``diff.py``) on the card, at the
    CLI's width (SmollRoom 15,000 x 5, 48 kHz, 72,000 bins) and at the JAX
    tests' fixture (a 4 x 4 m shoebox, 64 rays x 4 bounces, 8 kHz, 512
    bins). The differentiable forward is the plain trace under autograd
    (the hand kernels have no backward): only 16c's surrogate trace with
    ``use_kernels`` (K1/K2) and 16d's ``trace --ir-out`` (K4) launch hand
    kernels. ``c`` holds the objects of main(). Returns the launch counts
    of its paths and its readings."""
    torch, art, cli, rng = (c[k] for k in ("torch", "art", "cli", "rng"))
    dev, counted, only, card = (c[k] for k in (
        "dev", "counted", "only", "card"))
    from realisticaudioraytracing2d_tpu_torch import diff
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        AudioMaterial
    from realisticaudioraytracing2d_tpu_torch.models.scene import \
        Transform2D
    from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
    from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams
    slice_launches = {k: 0 for k in only()}
    readings = {}
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    def smoll_on(d):
        room = art.rooms.smoll_room(device=d)
        p = art.Engine(room.scene, art.smoll_room_config()).params(
            room.source, room.listener)
        return room, p

    def shoebox(absorption=0.3, divider=None):
        obstacles, src, lis = None, (-1.0, 0.0), (1.0, 0.3)
        if divider is not None:
            obstacles = [(Transform2D((0.0, 0.0), 0.0, (0.2, 3.0)),
                          AudioMaterial(absorption=0.1, scattering=0.0,
                                        transmission=divider))]
            src, lis = (-1.2, 0.0), (1.2, 0.2)
        scene = art.rooms.shoebox_room(
            4.0, 4.0, wall_material=AudioMaterial(absorption=absorption,
                                                  scattering=0.4),
            obstacles=obstacles, device=dev)
        return scene, TraceParams.make(src, lis, listener_radius=0.5,
                                       device=dev)

    small = dict(max_bounces=4, sample_rate=8000, ir_length=512)
    full = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
                ir_length=T)
    fields = ("absorption", "scattering")

    # 16a. SmollRoom's gradients at full width: finite and nonzero on the
    # card, the card against the CPU on the same Philox draws (a few
    # razor-edge rays part them: ROADMAP section 3, the plain trace on
    # the CPU and on the card); the
    # shoebox's absorption gradient against a central difference of the
    # card's forward (JAX's check); the blur in full float32
    grads = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        room, p = smoll_on(d)
        groups, n_groups = diff.infer_material_groups(room.scene)
        mp = diff.MaterialParams(*(
            x.requires_grad_(True) for x in diff.MaterialParams.from_scene(
                room.scene, groups, n_groups)))
        value = torch.sum(diff.simulate_ir(
            diff.apply_materials(room.scene, groups, mp, fields), p, 5,
            device=d, **full))
        value.backward()
        grads[where] = (float(value.detach()),
                        mp.absorption.grad.cpu().numpy().ravel(),
                        mp.scattering.grad.cpu().numpy())
    (vc, gac, gsc), (vh, gah, gsh) = grads["card"], grads["cpu"]
    for v, ga, gs in grads.values():
        check(v > 0 and np.isfinite(ga).all() and np.isfinite(gs).all()
              and np.abs(ga).max() > 0 and np.abs(gs).max() > 0,
              f"16a: SmollRoom gradients finite, nonzero ({ga}, {gs})")
    v_gap = abs(vc - vh) / vh
    g_gap = max(float(np.abs(gac - gah).max() / np.abs(gah).max()),
                float(np.abs(gsc - gsh).max() / np.abs(gsh).max()))
    scene_s, p_s = shoebox()
    groups_s, n_s = diff.infer_material_groups(scene_s)
    mp0 = diff.MaterialParams.from_scene(scene_s, groups_s, n_s)

    def loss_at(delta):
        mp = mp0._replace(absorption=mp0.absorption + delta)
        return torch.sum(diff.simulate_ir(
            diff.apply_materials(scene_s, groups_s, mp), p_s, 0, n_rays=64,
            device=dev, **small))

    delta = torch.zeros_like(mp0.absorption, requires_grad=True)
    loss_at(delta).backward()
    fd_said = []
    with torch.no_grad():
        for gi in range(n_s):
            e = torch.zeros_like(mp0.absorption)
            e[gi] = 1e-3
            fd = float(loss_at(e) - loss_at(-e)) / 2e-3
            ad = float(delta.grad[gi].sum())
            if abs(fd) < 1e-7 and abs(ad) < 1e-7:
                continue
            fd_said.append(f"{ad:.6g} / {fd:.6g}")
            check(abs(ad - fd) <= 5e-2 * abs(fd),
                  f"16a: autograd {ad} vs central difference {fd}")
    check(len(fd_said) >= 1, "16a: a group with a gradient")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, T, 1), dtype=np.float32))
    blur_gap = max(float((diff.gaussian_blur_time(x.to(dev), s).cpu()
                          - diff.gaussian_blur_time(x, s)).abs().max())
                   for s in (1.0, 24.0))
    check(blur_gap <= 1e-7 * float(x.max()), f"16a: blur gap {blur_gap}")
    print(f"[16a] SmollRoom {RAYS} x {BOUNCES}, {T} bins, d(sum IR)/d("
          f"absorption, scattering) on {card}: finite, nonzero; card vs CPU "
          f"value {v_gap:.2e} (< 1e-2), gradients {g_gap:.2e} of the "
          f"largest (< 1e-1); shoebox autograd / central difference "
          f"{', '.join(fd_said)} (rtol 5e-2); blur card vs CPU at {T} bins "
          f"{blur_gap:.2e} (cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32})", flush=True)
    check(v_gap < 1e-2 and g_gap < 1e-1, "16a: card vs CPU")

    # 16b. fit_materials recovers absorption on the card (JAX's test), and
    # a rerun gives the same losses bit for bit
    true_s, _ = shoebox(absorption=0.45)
    target_s = diff.simulate_ir(true_s, p_s, 7, n_rays=64, frames=4,
                                device=dev, **small)
    start_s, _ = shoebox(absorption=0.12)
    fit_kw = dict(n_rays=64, max_bounces=4, sample_rate=8000,
                  fields=("absorption",), loss="edc", steps=60, lr=0.1,
                  device=dev)
    runs = [diff.fit_materials(start_s, p_s, target_s, 0, **fit_kw)
            for _ in range(2)]
    losses = runs[0].losses.cpu().numpy()
    fitted = float(torch.sigmoid(runs[0].params.absorption)[
        int(diff.infer_material_groups(start_s)[0][0]), 0])
    same_bits = bool(torch.equal(runs[0].losses, runs[1].losses)
                     and torch.equal(runs[0].params.absorption,
                                     runs[1].params.absorption))
    print(f"[16b] fit_materials on {card}: absorption 0.12 -> {fitted:.4f} "
          f"(target 0.45, within 0.08), loss head/tail "
          f"{losses[:10].mean():.4f} / {losses[-10:].mean():.4f}; rerun "
          f"bit-identical {same_bits}", flush=True)
    check(abs(fitted - 0.45) < 0.08, "16b: absorption recovered")
    check(losses[-10:].mean() < 0.65 * losses[:10].mean(), "16b: losses")
    check(same_bits, "16b: a rerun gives the same bits")

    # 16c. the surrogate trace through K1/K2 == the plain surrogate trace,
    # bit for bit (SmollRoom's transmissive slant wall; the divider at
    # t = 0.5), one launch of each a bounce
    emit, u = rng.philox_uniforms(11, 1, BOUNCES, RAYS, device=dev)
    said = []
    for name, (scene, p) in (("SmollRoom", (lambda r: (r[0].scene, r[1]))(
            smoll_on(dev))), ("divider t = 0.5", shoebox(divider=0.5))):
        with_k, launched = counted(lambda: tt.trace_hits_only(
            scene, p, emit[0], u[0], use_kernels=True,
            transmission_surrogate=True))
        check(launched == only(K1=BOUNCES, K2=BOUNCES),
              f"16c: launches {launched}")
        add(launched)
        plain = tt.trace_hits_only(scene, p, emit[0], u[0],
                                   transmission_surrogate=True)
        check(bool(plain.valid.any()) and all(
            torch.equal(a, b) for a, b in zip(with_k, plain)),
              f"16c: {name} K1/K2 surrogate == plain")
        said.append(f"{name} {int(plain.valid.sum())} valid records")
    print(f"[16c] trace(use_kernels=True, transmission_surrogate=True) == "
          f"the plain surrogate trace bit for bit, {RAYS} x {BOUNCES}: "
          f"{'; '.join(said)}; K1 and K2 {BOUNCES} launches each", flush=True)

    # 16d. cli trace --ir-out (K4) -> cli fit at its defaults -> cli locate
    # (8 starts); fit and locate launch no hand kernel
    locate_steps = 25
    cli_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(n):
            return os.path.join(tmp, n)

        runs = [("trace --ir-out", ["trace", "--room", "smoll", "--ir-out",
                                    path("t.npz")], only(K4=1)),
                ("fit", ["fit", "--room", "smoll", "--target", path("t.npz"),
                         "--out", path("fit.json")], only()),
                (f"locate --steps {locate_steps}",
                 ["locate", "--room", "smoll", "--target", path("t.npz"),
                  "--out", path("loc.json"), "--steps", str(locate_steps)],
                 only())]
        for name, argv, want_l in runs:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launched = counted(lambda: cli.main(argv))
            cli_s[name] = time.perf_counter() - t0
            check(launched == want_l, f"16d: cli {name} launches {launched}")
            add(launched)
            print(f"    cli {name}: {buf.getvalue().strip()}", flush=True)
        fit_rep = json.load(open(path("fit.json")))
        loc_rep = json.load(open(path("loc.json")))
    check(set(fit_rep) == {"loss", "steps", "loss_start", "loss_end",
                           "fields", "groups"} and fit_rep["steps"] == 100
          and np.isfinite(fit_rep["loss_end"]) and fit_rep["groups"],
          f"16d: fit report {fit_rep}")
    check(set(loc_rep) == {"position", "loss", "configured_source",
                           "starts"} and len(loc_rep["starts"]) == 8
          and np.isfinite(loc_rep["loss"]), f"16d: locate report {loc_rep}")
    readings["cli"] = cli_s
    print(f"[16d] cli on {card}, seconds (launches checked): "
          + ", ".join(f"{k} {v:.2f}" for k, v in cli_s.items())
          + f"; fit loss {fit_rep['loss_start']:.4f} -> "
          f"{fit_rep['loss_end']:.4f}; located {loc_rep['position']} "
          f"(configured {loc_rep['configured_source']}, loss "
          f"{loc_rep['loss']:.4f}); 8 starts x {locate_steps} steps (the "
          f"CLI's 200 cut to fit the smoke)", flush=True)

    # 16e. one fit_materials step at the CLI defaults (fit's body: rebind,
    # trace, edc+mse, backward, Adam), synced: median and p99 over 30
    # steps, its launches and device time, and peak memory at 4 frames
    room, p = smoll_on(dev)
    groups, n_groups = diff.infer_material_groups(room.scene)
    target = diff.simulate_ir(room.scene, p, 99, frames=2, device=dev,
                              **full)
    mp = diff.MaterialParams(*(
        x.clone().requires_grad_(True) for x in diff.MaterialParams.
        from_scene(room.scene, groups, n_groups)))
    opt = torch.optim.Adam(list(mp), lr=0.08)
    groups_t = torch.from_numpy(groups).to(dev, torch.long)
    step_i = [0]

    def step(frames=1, remat=True):
        opt.zero_grad(set_to_none=True)
        pred = diff.simulate_ir(
            diff.apply_materials(room.scene, groups_t, mp, fields), p,
            rng.mix_seed(0, step_i[0]), frames=frames, remat=remat,
            device=dev, **full)
        diff.combined_loss(pred, target).backward()
        opt.step()
        step_i[0] += 1

    step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(30):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    busy, calls, kernels = chunk_profile(torch, step, 1)
    peak = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(frames=4, remat=remat)
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    readings["step"] = (float(np.median(ms)), float(np.percentile(ms, 99)),
                        busy, calls, kernels, peak)
    print(f"[16e] fit_materials step on {card}, SmollRoom {RAYS} x "
          f"{BOUNCES}, {T} bins, 1 frame, edc+mse, absorption + scattering:"
          f" median {np.median(ms):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} (30 steps); {calls:.0f} "
          f"cudaLaunchKernel, {kernels:.0f} device kernels, device busy "
          f"{busy:.3f} ms ({busy / np.median(ms) * 100:.1f}% of the step); "
          f"peak memory at 4 frames {peak[True]:.1f} MiB with remat, "
          f"{peak[False]:.1f} MiB without", flush=True)
    check(all(np.isfinite(ms)) and peak[True] < peak[False],
          "16e: step timed, remat keeps less")
    print(f"[16] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return slice_launches, readings


def ir_sha(torch, x):
    """The PARENT_BITS digest of an IR: sha256 of its f32 bytes."""
    torch.cuda.synchronize()
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def parent_bits(got):
    """The PARENT_BITS entries of the digests in ``got``."""
    return {k: PARENT_BITS.get(k) for k in got}


def city_setup(art, dev, n_boxes, n_bands=1):
    """A city scene and its trace parameters at the JAX bench's gain, as
    every phase builds them."""
    room = art.rooms.city_scene(n_boxes, n_bands=n_bands, device=dev)
    return room.scene, art.TraceParams.make(
        room.source, room.listener, room.listener_radius, 343.0, CITY_GAIN,
        device=dev)


def large_frames_run(ak, name, scene, p):
    """The unsharded call of ``LARGE_FRAMES[name]`` (K8's wrapper, which
    is K7's at more bands), with no frame offset: the call whose digest
    PARENT_BITS keeps (scripts/torch_accel_frame_bits.py runs it on the
    parent's checkout too)."""
    _, _, rays, bounces, n_f, sr, t, seed = LARGE_FRAMES[name]
    return ak.trace_frames_ir_accel_sorted(
        scene, p, seed, n_f, n_rays=rays, max_bounces=bounces,
        sample_rate=sr, ir_length=t)


def large_frames_phase(c, add, virtual):
    """[17l]: ``accumulate_frames_sharded`` on the cities past 5,280 walls
    (``LARGE_FRAMES``), through the cluster kernels at a frame offset:
    each run's launches (the shards' ``max_bounces`` each, no K3/K4) and
    its unsharded call's, the sharded IR within ``n / S + 1e-6 |x|`` of
    the unsharded one, both timed by their device time (every launch
    held); at frame_offset 0 the unsharded calls keep PARENT_BITS; on the
    sorted 4,808-wall city K8 and K7 (K = 1) at frame_offset 5 == K4 at
    it bit for bit; K8 and the 8-band K7 at frame_offset 5 against their
    plain twin on the 10,008-wall city at the city stream's shape.
    Returns its readings."""
    torch, art, ak, bk = (c[k] for k in ("torch", "art", "ak", "bk"))
    dev, counted, only, card = (c[k] for k in ("dev", "counted", "only",
                                               "card"))
    same_numbers = c["same_numbers"]
    from realisticaudioraytracing2d_tpu_torch.parallel import frames
    cities = {(2500, 1): (c["scene_9"], c["p_9"])}
    if "city_bands" in c:
        cities[10000, 8] = c["city_bands"][8]     # [8d]'s city
    digests, readings = {}, {}

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    for name, (boxes, bands, rays, bounces, n_f, sr, t, seed) in \
            LARGE_FRAMES.items():
        if (boxes, bands) not in cities:
            cities[boxes, bands] = city_setup(art, dev, boxes, bands)
        scene, p = cities[boxes, bands]
        key = "K7" if bands > 1 else "K8"
        mesh = virtual((n_f,))
        run = dict(n_rays=rays, max_bounces=bounces, sample_rate=sr,
                   n_frames=n_f)
        st0 = art.IRState.zeros(t, p.listeners.shape[0], bands, device=dev)

        def sharded():
            return frames.accumulate_frames_sharded(scene, p, st0, seed,
                                                    mesh, **run)

        sh, launched = counted(sharded)
        check(launched == only(**{key: n_f * bounces}),
              f"17l {name}: launches {launched}")
        add(launched)
        un, launched_u = counted(lambda: large_frames_run(ak, name, scene,
                                                          p))
        check(launched_u == only(**{key: bounces}),
              f"17l {name}: unsharded launches {launched_u}")
        add(launched_u)
        s_whole = float(bk.fixed_point_scale(p, n_f, rays, bounces))
        n_max = n_f * rays * 2 * bounces
        over = float(((sh.sum - un).abs() - (n_max / s_whole
                                             + 1e-6 * un.abs())).max())
        gap = float((sh.sum - un).abs().max())
        digests[name] = ir_sha(torch, un)
        ms = {"sharded": kernel_device_ms(
            torch, sharded, 2, "accel_bounce_kernel", n_f * bounces),
            "unsharded": kernel_device_ms(
                torch, lambda: large_frames_run(ak, name, scene, p), 2,
                "accel_bounce_kernel", bounces)}
        readings[name] = ms
        print(f"[17l] accumulate_frames_sharded, {scene.n_walls} walls, "
              f"{bands} band(s), {rays} x {bounces}, {n_f} frames over "
              f"{n_f} shards: launches {launched}, unsharded "
              f"{launched_u}; max abs gap to the unsharded {key} call "
              f"{gap:.3e} (peak {float(un.max()):.3e}; limit n / S + 1e-6 "
              f"|x|, n <= {n_max}, S = 2^{int(np.log2(s_whole))}; worst "
              f"margin {over:.3e}); device ms on {card}: sharded "
              f"{fmt(ms['sharded'])}, unsharded {fmt(ms['unsharded'])} "
              "(profiler, every launch held)", flush=True)
        check(sh.frames == n_f and float(un.sum()) > 0 and over <= 0.0,
              f"17l {name}: frames gap")
        check(None not in ms.values(), f"17l {name}: device time {ms}")
        del sh, un
    # K8 and K7 (K = 1) at frame_offset 5 == K4 at it on the sorted city
    city_run = dict(n_rays=BIG_RAYS, max_bounces=CITY_BOUNCES,
                    sample_rate=CITY_SR, ir_length=CITY_T)
    scene_a, p_a = city_setup(art, dev, 1200)
    k4 = bk.trace_frames_ir_mega(ak.prepare(scene_a).scene, p_a, 31,
                                 CITY_FRAMES, frame_offset=5, **city_run)
    parity = {f"{k} early_out={eo}": torch.equal(fn(
        scene_a, p_a, 31, CITY_FRAMES, early_out=eo, frame_offset=5,
        **city_run), k4)
        for k, fn in (("K7", ak.trace_frames_ir_accel),
                      ("K8", ak.trace_frames_ir_accel_sorted))
        for eo in (True, False)}
    moved = not torch.equal(k4, bk.trace_frames_ir_mega(
        ak.prepare(scene_a).scene, p_a, 31, CITY_FRAMES, **city_run))
    print(f"[17l] sorted city_scene(1200), {BIG_RAYS} x {CITY_BOUNCES} x "
          f"{CITY_FRAMES} frames at frame_offset 5 (IR energy "
          f"{float(k4.sum()):.4e}; other bits than at 0: {moved}): equal "
          f"to K4 at frame_offset 5 bit for bit: {parity}", flush=True)
    check(float(k4.sum()) > 0 and moved and all(parity.values()),
          "17l: K4 == K7 == K8 at frame_offset 5")
    # K8 and the 8-band K7 at frame_offset 5 against their plain twin on
    # the 10,008-wall city at the city stream's shape
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
               ir_length=T)
    for key, bands in (("K8", 1), ("K7", 8)):
        if (2500, bands) not in cities:
            cities[2500, bands] = city_setup(art, dev, 2500, bands)
        scene, p = cities[2500, bands]
        chunk = max(256, PLAIN_ELEMENTS // scene.n_walls)
        same_numbers(f"[17l] {key} at frame_offset 5 vs plain, "
                     f"{scene.n_walls} walls, {scene.n_bands} band(s), "
                     f"{RAYS} x {BOUNCES} x 1 frame", key,
                     ak.trace_frames_ir_accel_sorted(
                         scene, p, 9, 1, frame_offset=5, **one),
                     ak.trace_frames_ir_accel_sorted_plain(
                         scene, p, 9, 1, frame_offset=5, ray_chunk=chunk,
                         **one))
    print(f"[17l] the unsharded calls at frame_offset 0 keep the parent's "
          f"bits: {digests == parent_bits(digests)}; {digests}", flush=True)
    check(digests == parent_bits(digests), f"17l: parent bits {digests}")
    return readings


def mesh_phase(c):
    """Phase 17: the device-mesh paths (``parallel/``) at full width on a
    virtual mesh of the card (``[cuda:0] * 8``; a one-card host), the
    sharded CLI sweep, the profiler trace and the pytree checkpoint.
    ``c`` holds the objects of main(). Returns the launch counts of its
    paths and its readings."""
    torch, art, bk, rng, cli = (c[k] for k in ("torch", "art", "bk", "rng",
                                               "cli"))
    dev, counted, only, card = (c[k] for k in (
        "dev", "counted", "only", "card"))
    same_numbers, Scene = c["same_numbers"], c["Scene"]
    from realisticaudioraytracing2d_tpu_torch import diff
    from realisticaudioraytracing2d_tpu_torch.engine import trace_accumulate
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        AudioMaterial
    from realisticaudioraytracing2d_tpu_torch.parallel import (
        frames, multisource, rays, seq)
    from realisticaudioraytracing2d_tpu_torch.parallel.mesh import make_mesh
    from realisticaudioraytracing2d_tpu_torch.parallel.sweep import (
        sweep_rooms, sweep_rooms_sharded)
    from realisticaudioraytracing2d_tpu_torch.utils import checkpoint, \
        profiling
    slice_launches = {k: 0 for k in only()}
    readings = {}
    t_phase = time.perf_counter()

    def add(launched):
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)

    def virtual(shape, names=("rooms",)):
        return make_mesh(shape, names, devices=[dev] * int(np.prod(shape)))

    def synced(fn):
        out = fn()
        torch.cuda.synchronize()
        return out

    kw = dict(sample_rate=SR, ir_length=T)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, **kw)

    # 17a. make_mesh() on the card: every CUDA device on "rooms"
    default = make_mesh()
    n_cards = torch.cuda.device_count()
    check(dict(default.shape) == {"rooms": n_cards, "rays": 1}
          and list(default.devices.flat) == [torch.device("cuda", i)
                                             for i in range(n_cards)],
          f"17a: make_mesh() {default}")
    print(f"[17a] make_mesh() on {card}: shape {dict(default.shape)}, "
          f"devices {[str(d) for d in default.devices.flat]}; the phase "
          f"shards over a virtual mesh of 8 x {dev}", flush=True)

    # 17b. the sweep at cli sweep's defaults over 8 shards == the
    # unsharded sweep bit for bit, 8 K9 launches; a rerun the same bits
    scenes, src, lis = art.rooms.random_rooms(SWEEP_ROOMS, seed=0,
                                              device=dev)
    m8 = virtual((8,))
    sweep_kw = dict(n_frames=SWEEP_FRAMES, **one)
    sharded, launched = counted(lambda: sweep_rooms_sharded(
        scenes, src, lis, 0, m8, **sweep_kw))
    check(launched == only(K9=8), f"17b: launches {launched}")
    add(launched)
    whole, launched_w = counted(lambda: sweep_rooms(scenes, src, lis, 0,
                                                    **sweep_kw))
    check(launched_w == only(K9=1), f"17b: unsharded launches {launched_w}")
    add(launched_w)
    again = synced(lambda: sweep_rooms_sharded(scenes, src, lis, 0, m8,
                                               **sweep_kw))
    bits = torch.equal(sharded, whole) and torch.equal(sharded, again)
    sweep_ms = {"sharded": cuda_ms(torch, lambda: sweep_rooms_sharded(
        scenes, src, lis, 0, m8, **sweep_kw), 3),
        "unsharded": cuda_ms(torch, lambda: sweep_rooms(
            scenes, src, lis, 0, **sweep_kw), 3)}
    readings["sweep_ms"] = sweep_ms
    print(f"[17b] sweep_rooms_sharded, {SWEEP_ROOMS} rooms over 8 shards, "
          f"{RAYS} x {BOUNCES} x {SWEEP_FRAMES} frames, {T} bins "
          f"({sharded.numel() * 4 / 1e6:.0f} MB of IRs): launches "
          f"{launched}; == sweep_rooms bit for bit and rerun bit-identical:"
          f" {bits}; on {card}: sharded {sweep_ms['sharded']:.3f} ms, "
          f"unsharded {sweep_ms['unsharded']:.3f} ms per call (CUDA events,"
          " 3 calls)", flush=True)
    check(bits, "17b: sharded sweep == unsharded, rerun bit-identical")
    del sharded, whole, again, scenes

    # 17c. 8 copies of the 10,008-wall city (distinct listeners) over 2
    # shards, through K8 one entry at a time == the unsharded sweep
    scene_9, p_9 = c["scene_9"], c["p_9"]
    n_e, frames_c = 8, 2
    offsets = torch.tensor([[float(i % 4) - 1.5, float(i // 4) - 0.5]
                            for i in range(n_e)], device=dev)
    copies = Scene.stack([scene_9] * n_e)
    src8 = p_9.source[None].expand(n_e, 2)
    lis8 = (p_9.listeners + offsets)[:, None]
    city_kw = dict(n_frames=frames_c, input_gain=CITY_GAIN,
                   listener_radius=float(p_9.listener_radius), **one)
    city_sh, launched = counted(lambda: sweep_rooms_sharded(
        copies, src8, lis8, 26, virtual((2,)), **city_kw))
    check(launched == only(K8=n_e * BOUNCES), f"17c: launches {launched}")
    add(launched)
    city_un = synced(lambda: sweep_rooms(copies, src8, lis8, 26, **city_kw))
    heard = [float(x) for x in city_un.sum((1, 2, 3))]
    print(f"[17c] {n_e} copies of city_scene(2500) ({scene_9.n_walls} "
          f"walls) over 2 shards, {RAYS} x {BOUNCES} x {frames_c} frames: "
          f"launches {launched}; == the unsharded sweep bit for bit: "
          f"{torch.equal(city_sh, city_un)}; energies {heard}", flush=True)
    check(torch.equal(city_sh, city_un) and sum(x > 0 for x in heard) >= 4,
          "17c: sharded city sweep == unsharded")
    del city_sh, city_un, copies

    # 17d. the 64-source stereo mixdown over a (1, 8) rooms x rays mesh:
    # 8 K9 launches, the unsharded mixdown within the order of the sum
    g = np.random.default_rng(11)       # phase 7's sources
    sources = np.stack([g.uniform(-15, 15, N_SOURCES),
                        g.uniform(-3, 8, N_SOURCES)], -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    mix_p = art.TraceParams.make(sources, ears, device=dev)
    smoll = art.rooms.smoll_room(device=dev)
    m18 = virtual((1, 8), ("rooms", "rays"))
    mix_sh, launched = counted(lambda: multisource.
                               trace_sources_mixdown_sharded(
                                   smoll.scene, mix_p, 7, m18, **one))
    check(launched == only(K9=8), f"17d: launches {launched}")
    add(launched)
    mix_un, launched_u = counted(lambda: multisource.trace_sources_mixdown(
        smoll.scene, mix_p, 7, **one))
    check(launched_u == only(K9=1), f"17d: unsharded launches {launched_u}")
    add(launched_u)
    gap = float((mix_sh - mix_un).abs().max())
    rel = gap / float(mix_un.abs().max())
    mix_ms = {"sharded": cuda_ms(torch, lambda: multisource.
                                 trace_sources_mixdown_sharded(
                                     smoll.scene, mix_p, 7, m18, **one), 5),
              "unsharded": cuda_ms(torch, lambda: multisource.
                                   trace_sources_mixdown(
                                       smoll.scene, mix_p, 7, **one), 5)}
    # one shard's work alone: the unsharded mixdown of its 8 sources
    p_8 = mix_p._replace(source=mix_p.source[:8])
    mix_ms["8 sources"] = cuda_ms(torch, lambda: multisource.
                                  trace_sources_mixdown(smoll.scene, p_8, 7,
                                                        **one), 5)
    readings["mix_ms"] = mix_ms
    print(f"[17d] trace_sources_mixdown_sharded, {N_SOURCES} sources, 2 "
          f"ears, SmollRoom {RAYS} x {BOUNCES}, over (1, 8): launches "
          f"{launched}; max abs gap to the unsharded mixdown {gap:.3e} "
          f"({rel:.2e} of the peak; limit 1e-6: 8 float additions in "
          f"another order); on {card}: sharded {mix_ms['sharded']:.3f} ms, "
          f"unsharded {mix_ms['unsharded']:.3f} ms per call, one 8-source "
          f"mixdown {mix_ms['8 sources']:.3f} ms", flush=True)
    check(rel <= 1e-6 and float(mix_un.sum()) > 0, "17d: mixdown gap")

    # 17e. frames: SmollRoom 131,072 x 8, 8 frames over 8 shards (8 K4
    # launches, frame_offset d) against trace_accumulate(n_frames=8) (one
    # K4 launch) within the fixed point: a bin of n deposits moves by at
    # most n / S (n <= F * R * 2 * B), plus 1e-6 of the value (the float
    # sum over shards); K4 at frame_offset 0 keeps the parent's bits, at 5
    # equals K3 on those frames' Philox numbers and the plain version
    p_s = art.TraceParams.make(smoll.source, smoll.listener, device=dev)
    big = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES, sample_rate=SR)
    st0 = art.IRState.zeros(T, device=dev)
    sh, launched = counted(lambda: frames.accumulate_frames_sharded(
        smoll.scene, p_s, st0, 2024, m8, n_frames=BIG_FRAMES, **big))
    check(launched == only(K4=8), f"17e: launches {launched}")
    add(launched)
    un, launched_u = counted(lambda: trace_accumulate(
        smoll.scene, p_s, st0, n_frames=BIG_FRAMES, seed=2024, **big))
    check(launched_u == only(K4=1), f"17e: unsharded launches {launched_u}")
    add(launched_u)
    s_whole = float(bk.fixed_point_scale(p_s, BIG_FRAMES, BIG_RAYS,
                                         BIG_BOUNCES))
    n_max = BIG_FRAMES * BIG_RAYS * 2 * BIG_BOUNCES
    over = float(((sh.sum - un.sum).abs() - (n_max / s_whole
                                             + 1e-6 * un.sum.abs())).max())
    gap = float((sh.sum - un.sum).abs().max())
    parent = {
        "K4 15k x 5 x 2 seed 42": ir_sha(torch, bk.trace_frames_ir_mega(
            smoll.scene, p_s, 42, 2, frame_offset=0, **one)),
        "K4 131k x 8 x 8 seed 2024": ir_sha(torch, un.sum),
        "K9 256 rooms x 8": ir_sha(torch, bk.trace_rooms_ir_mega(
            *art.rooms.random_rooms(256, seed=0, device=dev), 0, 8,
            **one))}
    big1 = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES, **kw)
    k4_5 = bk.trace_frames_ir_mega(smoll.scene, p_s, 2024, 1, frame_offset=5,
                                   **big1)
    emit5, u5 = rng.philox_uniforms(2024, 1, BIG_BOUNCES, BIG_RAYS, dev,
                                    first_frame=5)
    k3_5 = bk.trace_frames_ir_whole(smoll.scene, p_s, emit5, u5, **kw)
    k3_ok = torch.equal(k4_5, k3_5)
    print(f"[17e] accumulate_frames_sharded, SmollRoom {BIG_RAYS} x "
          f"{BIG_BOUNCES}, {BIG_FRAMES} frames over 8 shards: launches "
          f"{launched}, frames {sh.frames}; max abs gap to trace_accumulate"
          f"(n_frames={BIG_FRAMES}) {gap:.3e} (peak {float(un.sum.max()):.3e}"
          f"; limit n / S + 1e-6 |x|, n <= {n_max}, S = 2^"
          f"{int(np.log2(s_whole))}; worst margin {over:.3e}); K4 at "
          f"frame_offset 0 keeps the parent's bits: "
          f"{parent == parent_bits(parent)}; K4 at frame_offset 5 == K3 on "
          f"frame 5's Philox numbers: {k3_ok}", flush=True)
    check(sh.frames == BIG_FRAMES and over <= 0.0, "17e: frames gap")
    check(parent == parent_bits(parent), f"17e: parent bits {parent}")
    check(k3_ok, "17e: K4 frame_offset 5 == K3")
    same_numbers(f"[17e] K4 frame_offset 5 vs plain first_frame 5, "
                 f"{BIG_RAYS} x {BIG_BOUNCES} x 1 frame", "K4", k4_5,
                 bk.trace_frames_ir_mega_plain(smoll.scene, p_s, 2024, 1,
                                               frame_offset=5, **big1))
    del sh, un, k4_5, k3_5, emit5, u5

    # 17f. rays: 131,072 rays over 8 shards of 16,384 (8 K4 launches,
    # entry d); shard 0 is K4 at 16,384 rays; the sum == the 8 launches;
    # statistically the unsharded trace (phase 3's limits); a rerun the
    # same bits; the uniforms= route (8 K3 launches) the same bits
    local = BIG_RAYS // 8
    ray_kw = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES, **kw)
    r_sh, launched = counted(lambda: rays.trace_rays_sharded(
        smoll.scene, p_s, 77, m18, **ray_kw))
    check(launched == only(K4=8), f"17f: launches {launched}")
    add(launched)
    loc = dict(n_rays=local, max_bounces=BIG_BOUNCES, **kw)
    parts = [bk.trace_frames_ir_mega(smoll.scene, p_s, 77, 1, entry=d, **loc)
             for d in range(8)]
    shard0 = bk.trace_frames_ir_mega(smoll.scene, p_s, 77, 1, **loc)
    again = synced(lambda: rays.trace_rays_sharded(smoll.scene, p_s, 77,
                                                   m18, **ray_kw))
    uni = [tuple(x[0] for x in rng.philox_uniforms(
        77, 1, BIG_BOUNCES, local, dev, entry=d)) for d in range(8)]
    r_k3, launched_k3 = counted(lambda: rays.trace_rays_sharded(
        smoll.scene, p_s, 77, m18, uniforms=uni, **ray_kw))
    check(launched_k3 == only(K3=8), f"17f: uniforms launches {launched_k3}")
    add(launched_k3)
    # statistics at phase 3's width: 8 sharded runs (seeds 77 .. 84)
    # against one unsharded K4 launch of 8 frames, 1,048,576 rays a side
    runs = [r_sh] + [rays.trace_rays_sharded(smoll.scene, p_s, 77 + i, m18,
                                             **ray_kw) for i in range(1, 8)]
    whole8 = bk.trace_frames_ir_mega(smoll.scene, p_s, 77, 8, **ray_kw)
    torch.cuda.synchronize()
    # per frame, as phase 3 holds them. The first arrival is the first bin
    # reaching 2% of the peak (diff.first_arrival_times' definition): a
    # rare ray guided inside SmollRoom's ior-0.6 slant slab arrives ~6 ms
    # before the direct path (a few per million rays, ~6e-6 per frame),
    # which phase 3's absolute threshold of 1e-7 counts in whichever run's
    # draws happen to hold one (printed beside)
    a = sum(runs[1:], runs[0]).cpu().numpy().ravel() / 8
    o = whole8.cpu().numpy().ravel() / 8
    e_rel = abs(a.sum() - o.sum()) / o.sum()
    first_a = int(np.argmax(a >= 0.02 * a.max()))
    first_o = int(np.argmax(o >= 0.02 * o.max()))
    abs_a, abs_o = (int(np.nonzero(x > 1e-7)[0][0]) for x in (a, o))
    checks = {f"shard 0 == K4 at {local} rays": torch.equal(parts[0],
                                                           shard0),
              "sum == the 8 launches": torch.equal(
                  r_sh, sum(parts[1:], parts[0])),
              "rerun": torch.equal(r_sh, again),
              "uniforms= (K3) ==": torch.equal(r_k3, r_sh)}
    print(f"[17f] trace_rays_sharded, SmollRoom {BIG_RAYS} rays x "
          f"{BIG_BOUNCES} over 8 shards: launches {launched} (K4), "
          f"{launched_k3} (uniforms=); {checks}; 8 runs (seeds 77 .. 84) "
          f"against the unsharded K4 over 8 frames: energy {e_rel:.2e} "
          f"(< 2e-2), first arrival at 2% of the peak {first_a}/{first_o} "
          f"(<= 4 bins); first bin past 1e-7 {abs_a}/{abs_o} (energies per "
          f"frame there {a[abs_a]:.3e}/{o[abs_o]:.3e})", flush=True)
    check(all(checks.values()), f"17f: {checks}")
    check(e_rel < 0.02 and abs(first_a - first_o) <= 4, "17f: statistics")
    del r_sh, parts, again, r_k3, whole8, uni, runs

    # 17g. 10 s at 48 kHz against a 72,000-bin IR over 8 shards against
    # convolve_fft: within 1e-5 of the peak (FFT roundoff of 8 chunks
    # against one transform of the whole)
    gen = torch.Generator(device=dev).manual_seed(4)
    dry = torch.randn(10 * SR, generator=gen, device=dev)
    ir = torch.randn(T, generator=gen, device=dev) * torch.exp(
        -torch.arange(T, device=dev) / dry.new_tensor(SR * 0.3))
    conv_sh = synced(lambda: seq.convolve_seq_sharded(dry, ir, virtual(
        (8,), ("rays",)), 3))
    conv = art.convolve.convolve_fft(dry, ir, 3)
    c_gap = float((conv_sh - conv).abs().max()) / float(conv.abs().max())
    conv_ms = {"sharded": cuda_ms(torch, lambda: seq.convolve_seq_sharded(
        dry, ir, virtual((8,), ("rays",)), 3), 5),
        "unsharded": cuda_ms(torch, lambda: art.convolve.convolve_fft(
            dry, ir, 3), 5)}
    readings["conv_ms"] = conv_ms
    print(f"[17g] convolve_seq_sharded, {dry.numel()} samples x {T} bins "
          f"over 8 shards: {tuple(conv_sh.shape)}, max gap to convolve_fft "
          f"{c_gap:.2e} of the peak (< 1e-5); on {card}: sharded "
          f"{conv_ms['sharded']:.3f} ms, convolve_fft "
          f"{conv_ms['unsharded']:.3f} ms", flush=True)
    check(conv_sh.shape == conv.shape and c_gap < 1e-5, "17g: convolution")
    del dry, ir, conv_sh, conv

    # 17h. localize_source(mesh=) with 8 starts over 8 shards == mesh=None
    # start by start (a 4 x 4 m shoebox, 64 rays x 4 bounces, 8 kHz)
    box = art.rooms.shoebox_room(4.0, 4.0, wall_material=AudioMaterial(
        absorption=0.3, scattering=0.4), device=dev)
    p_box = art.TraceParams.make((-1.0, 0.4), (1.0, 0.3), device=dev)
    target = diff.simulate_ir(box, p_box, 0, n_rays=64, max_bounces=4,
                              sample_rate=8000, ir_length=512, soft=True,
                              device=dev)
    loc_kw = dict(n_rays=64, max_bounces=4, sample_rate=8000, steps=20,
                  n_starts=8, device=dev)
    loc_un, launched_l = counted(lambda: diff.localize_source(
        box, p_box, target, 3, **loc_kw))
    loc_sh = synced(lambda: diff.localize_source(box, p_box, target, 3,
                                                 mesh=virtual((8,)),
                                                 **loc_kw))
    per_start = [bool(torch.equal(loc_sh.positions[i], loc_un.positions[i])
                      and torch.equal(loc_sh.losses[i], loc_un.losses[i]))
                 for i in range(8)]
    print(f"[17h] localize_source(mesh=) 8 starts over 8 shards x 20 steps "
          f"on {card}: each start == mesh=None bit for bit: {per_start}; "
          f"best {loc_sh.position.tolist()} (loss {float(loc_sh.loss):.4f});"
          f" launches {launched_l} (the plain trace under autograd)",
          flush=True)
    check(all(per_start) and launched_l == only(), "17h: sharded starts")

    # 17i. cli sweep --sharded --rooms 64 on a one-card host: the npz of
    # the run without the flag (one K9 launch each)
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for flag in ([], ["--sharded"]):
            path = os.path.join(tmp, f"s{len(flag)}.npz")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, launched = counted(lambda: cli.main(
                    ["sweep", "--rooms", "64", "--out", path, *flag]))
            check(launched == only(K9=1), f"17i: launches {launched}")
            add(launched)
            with np.load(path) as npz:
                got[len(flag)] = {k: npz[k] for k in npz.files}
        same = all(np.array_equal(got[0][k], got[1][k]) for k in got[0])
    print(f"[17i] cli sweep --rooms 64 --sharded on {n_cards} card(s): the "
          f"npz of the run without the flag: {same}", flush=True)
    check(same, "17i: cli sweep --sharded")

    # 17j. profiling.device_trace around one K4 call names the kernel
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            profiler_lead_in(torch)
            bk.trace_frames_ir_mega(smoll.scene, p_s, 5, 1, **one)
        files = os.listdir(tmp)
        text = open(os.path.join(tmp, files[0])).read() if files else ""
    named = "frames_ir_kernel" in text
    print(f"[17j] profiling.device_trace: {files} ({len(text)} bytes), "
          f"names frames_ir_kernel: {named}", flush=True)
    check(len(files) == 1 and named, "17j: device trace")

    # 17k. a pytree checkpoint on the card: written, read back onto it
    tree = {"ir": art.IRState(sum=bk.trace_frames_ir_mega(
        smoll.scene, p_s, 6, 1, **one), frames=1),
        "poses": (p_s.source, [p_s.listeners, None])}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tree.npz")
        checkpoint.save_pytree(path, tree, meta={"seed": 6}, kind="Run")
        back = checkpoint.load_pytree(path, tree, kind="Run")
        side = checkpoint.read_sidecar(path)
    ok = (back["ir"].frames == 1 and back["ir"].sum.device.type == "cuda"
          and torch.equal(back["ir"].sum, tree["ir"].sum)
          and torch.equal(back["poses"][1][0], p_s.listeners)
          and back["poses"][1][1] is None)
    print(f"[17k] save_pytree / load_pytree on {card}: {side['treedef']}, "
          f"leaves {side['leaf_paths']}, read back equal on {dev}: {ok}",
          flush=True)
    check(ok, "17k: pytree checkpoint")

    # 17l. frames of the cities past 5,280 walls: the cluster kernels at a
    # frame offset
    readings["large_frames_ms"] = large_frames_phase(c, add, virtual)
    print(f"[17] phase time {time.perf_counter() - t_phase:.1f} s; "
          f"launches {slice_launches}", flush=True)
    return slice_launches, readings


# Phase 18: each twin of a JAX example (examples/torch/) and the arguments
# [18] gives it: every twin's default width (rays, bins, microphones,
# elements); the depth of the inverse twins cut (their steps, starts and
# chunks), which take ~40 ms a start and step on the card (host-bound).
# A cut must keep the claim: at 4 starts x 60 steps locate_source missed
# on the card (0.232 m). None: the twin runs only under ``--full`` of
# scripts/torch_examples_phase.py (every twin at its defaults), not in
# the smoke: track_source at its 256 rays loses lock with 8 chunks or
# below ~45 steps a chunk, and its shallowest cut that holds (10 chunks
# x 45 steps, its cold solve of 8 starts x 150 steps kept) takes 127-146
# s, which the smoke's 540 s cannot hold beside the earlier phases.
EXAMPLE_CUTS = {
    "demo.py": [], "quad_mic.py": [], "speaker_array.py": [],
    "spatial_doa.py": [], "occlusion_walkby.py": [],
    "doppler_walkby.py": [], "binaural_walkby.py": [],
    "live_steering.py": [],
    "inverse_materials.py": ["--steps", "10"],
    "locate_source.py": ["--starts", "4", "--steps", "120"],
    "track_source.py": None,
    "obstacle_pose_negative.py": ["--steps", "20", "--grid", "2"],
    "dataset_sweep.py": []}
# The kernels each twin must launch, and no other: the inverse twins
# differentiate the plain trace (the hand kernels have no backward).
EXAMPLE_KERNELS = {
    "demo.py": {"K1", "K2", "K4"}, "quad_mic.py": {"K4"},
    "speaker_array.py": {"K9"}, "spatial_doa.py": {"K4"},
    "occlusion_walkby.py": {"K2", "K4", "D3seg", "D3bin"},
    "doppler_walkby.py": {"K4"},
    "binaural_walkby.py": {"K4"}, "live_steering.py": {"K4"},
    "inverse_materials.py": set(), "locate_source.py": set(),
    "track_source.py": set(), "obstacle_pose_negative.py": set(),
    "dataset_sweep.py": {"K9"}}
# The line of a twin's output that states its claim.
EXAMPLE_CLAIMS = {
    "demo.py": "localized", "quad_mic.py": "first arrival",
    "speaker_array.py": "contrast", "spatial_doa.py": "post-hoc",
    "occlusion_walkby.py": "OK:", "doppler_walkby.py": "measured lines",
    "binaural_walkby.py": "ILD", "live_steering.py": "byte-identical",
    "inverse_materials.py": "loss:", "locate_source.py": "fitted",
    "track_source.py": "mean |err|", "obstacle_pose_negative.py": "best",
    "dataset_sweep.py": "dataset sweep ok"}


def examples_phase(c, full=False):
    """Phase 18: every twin of a JAX example (``examples/torch/``) by its
    ``main(argv)`` in this process, in a temporary directory, at
    ``EXAMPLE_CUTS`` (``full``: its defaults; a twin cut to None runs only
    then). A non-zero return or an
    exception fails the smoke (the twin's output is printed first); each
    twin must launch exactly its ``EXAMPLE_KERNELS``. Returns the launch
    counts and each twin's seconds."""
    import importlib.util
    torch, dev, counted, only = (c[k] for k in ("torch", "dev", "counted",
                                                "only"))
    slice_launches = {k: 0 for k in only()}
    seconds = {}
    t_phase = time.perf_counter()
    cuts = ("none: every twin at its defaults" if full else "; ".join(
        f"{k} {'(only in --full)' if v is None else ' '.join(v)}"
        for k, v in EXAMPLE_CUTS.items() if v != []))
    print(f"[18] the twins of the JAX examples on {c['card']}, default "
          f"width; depth cuts: {cuts}", flush=True)
    for name, cut in EXAMPLE_CUTS.items():
        if cut is None and not full:
            continue
        argv = ([] if full else cut) + ["--device", str(dev)]
        spec = importlib.util.spec_from_file_location(
            "twin_" + name[:-3], os.path.join(HERE, "examples", "torch",
                                              name))
        twin = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(twin)
        out, cwd = io.StringIO(), os.getcwd()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                with contextlib.redirect_stdout(out):
                    rc, launched = counted(lambda: twin.main(argv))
            except BaseException:
                print(f"[18] {name} failed; its output:\n"
                      f"{out.getvalue()[-6000:]}", flush=True)
                raise
            finally:
                os.chdir(cwd)
        seconds[name] = time.perf_counter() - t0
        text = out.getvalue()
        claim = [ln.strip() for ln in text.splitlines()
                 if EXAMPLE_CLAIMS[name] in ln]
        used = {k for k, n in launched.items() if n}
        print(f"[18] {name} {' '.join(argv)}: {seconds[name]:.1f} s, "
              f"returned {rc}, launches "
              f"{ {k: n for k, n in launched.items() if n} }; "
              f"{claim[-1] if claim else '(no claim line)'}", flush=True)
        check(rc == 0 and claim, f"18: {name} returned {rc}:\n{text[-3000:]}")
        check(used == EXAMPLE_KERNELS[name],
              f"18: {name} launched {used}, not {EXAMPLE_KERNELS[name]}")
        for k in slice_launches:
            slice_launches[k] += launched.get(k, 0)
        del twin
        torch.cuda.empty_cache()
    print(f"[18] phase time {time.perf_counter() - t_phase:.1f} s; "
          f"launches {slice_launches}", flush=True)
    return slice_launches, seconds


# Phase 19: the launches of bench.main() at the JAX sizes (see the
# docstring) and the keys of its JSON line, JAX's.
BENCH_LAUNCHES = {"K4": 10 + 2 + 32 + 96, "K8": 2 * 2 * 2 * 6, "K9": 2}
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def bench_phase(c):
    """Phase 19: the port's bench suite, ``bench.main()``, in this process
    at the JAX sizes, stdout and stderr captured. Checks its JSON line
    and its launches (``BENCH_LAUNCHES``, nothing else); prints its
    summary on one line. Returns the launch counts and the seconds."""
    from realisticaudioraytracing2d_tpu_torch import bench
    counted, only = c["counted"], c["only"]
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            got, launched = counted(bench.main)
    except BaseException:
        print(f"[19] bench.main() failed; its output:\n{out.getvalue()}\n"
              f"{err.getvalue()[-6000:]}", flush=True)
        raise
    seconds = time.perf_counter() - t0
    said = " | ".join(ln.strip() for ln in err.getvalue().splitlines()
                      if ln.strip())
    print(f"[19] bench.main() on {c['card']}: {seconds:.1f} s; launches "
          f"{ {k: n for k, n in launched.items() if n} }; stderr: {said}",
          flush=True)
    lines = out.getvalue().strip().splitlines()
    print(f"[19] its stdout's last line: {lines[-1] if lines else None}; "
          f"unrounded: {json.dumps(got)}", flush=True)
    line = json.loads(lines[-1])
    check(list(line) == BENCH_KEYS, f"19: keys {list(line)}")
    check(line["metric"] == "ray_bounce_intersections_per_sec_per_chip"
          and line["unit"] == "intersections/s", f"19: {line}")
    check(line["value"] > 0, f"19: value {line['value']}")
    check(line["vs_baseline"] == float(f"{line['value'] / 100e6:.4g}"),
          f"19: vs_baseline {line['vs_baseline']}")
    check(launched == only(**BENCH_LAUNCHES),
          f"19: launches {launched}, not {BENCH_LAUNCHES}")
    bench_shapes(c)
    return launched, seconds


def bench_shapes(c):
    """Phase 19b: the bench's own launches against their plain versions on
    the same seeds (after the counted run; these launches are not
    counted): K4 through ``engine.trace_accumulate`` at 50 frames on
    SmollRoom padded to 32 walls (``bench_trace``'s 131,072 x 8 and
    15,000 x 5, ``bench_quad``'s four listeners at 15,000 x 5), and K9
    through ``sweep_rooms`` at ``bench_sweep``'s shape, four rooms of the
    1,024 held against the plain version."""
    from realisticaudioraytracing2d_tpu_torch.engine import trace_accumulate
    from realisticaudioraytracing2d_tpu_torch.ops.ir import IRState
    from realisticaudioraytracing2d_tpu_torch.parallel.sweep import \
        sweep_rooms
    torch, art, bk, dev = c["torch"], c["art"], c["bk"], c["dev"]
    same_numbers = c["same_numbers"]
    t0 = time.perf_counter()
    room = art.rooms.smoll_room(pad_to=32, device=dev)
    ears = np.asarray([[0.0, -3.68], [0.5, -3.68], [-6.0, 2.0],
                       [8.0, -1.0]], np.float32)
    one_ear = art.TraceParams.make(room.source, room.listener,
                                   room.listener_radius, 343.0, 1.0,
                                   device=dev)
    four_ears = art.TraceParams.make(room.source, ears, 0.5, 343.0, 1.0,
                                     device=dev)
    nf, kw = 50, dict(sample_rate=SR, ir_length=T)
    for what, p, n_rays, n_bounces in (
            ("bench_trace", one_ear, BIG_RAYS, BIG_BOUNCES),
            ("bench_trace", one_ear, RAYS, BOUNCES),
            ("bench_quad, 4 listeners", four_ears, RAYS, BOUNCES)):
        state = IRState.zeros(T, p.listeners.shape[0], 1, device=dev)
        got = trace_accumulate(room.scene, p, state, n_rays=n_rays,
                               max_bounces=n_bounces, sample_rate=SR,
                               n_frames=nf, seed=1).sum
        s = bk.fixed_point_scale(p, nf, n_rays, n_bounces)
        same_numbers(
            f"[19b] K4 vs plain at {what}'s shape, {n_rays} x {n_bounces} x "
            f"{nf} frames (S = 2^{int(torch.log2(s))}), seed 1, same "
            "Philox numbers", "K4", got,
            bk.trace_frames_ir_mega_plain(room.scene, p, 1, nf, n_rays=n_rays,
                                          max_bounces=n_bounces, **kw))
        del got, state
    n_rooms = 1024
    scenes, src, lis = art.rooms.random_rooms(n_rooms, seed=0, device=dev)
    sweep_kw = dict(n_rays=4096, max_bounces=6, sample_rate=16000,
                    ir_length=24000)
    irs = sweep_rooms(scenes, src, lis, 1, n_frames=1, **sweep_kw)
    for r in (0, 1, n_rooms // 2 - 1, n_rooms - 1):
        tag = (f"[19b] K9 vs plain at bench_sweep's shape, room {r} of "
               f"{n_rooms}, 4096 x 6 x 1 frame, 16 kHz, 24000 bins, seed 1, "
               "same Philox numbers")
        want = bk.trace_rooms_ir_mega_plain(
            scenes.row(slice(r, r + 1)), src[r:r + 1], lis[r:r + 1], 1, 1,
            entry_offset=r, **sweep_kw)[0]
        if float(want.sum()) > 0:
            same_numbers(tag, "K9", irs[r], want)
        else:               # no ray reaches this room's listener
            print(f"{tag}: no energy in either", flush=True)
            check(torch.equal(irs[r], want), f"{tag}: both silent")
    del irs, scenes
    torch.cuda.empty_cache()
    print(f"[19b] phase time {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    sys.path.insert(0, HERE)
    import torch
    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch import cli, engine
    from realisticaudioraytracing2d_tpu_torch.bench import card_line
    from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
    from realisticaudioraytracing2d_tpu_torch.ops import accel
    from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
    from realisticaudioraytracing2d_tpu_torch.ops import legacy, rng
    from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        trace_kernel as tk
    from realisticaudioraytracing2d_tpu_torch.parallel.multisource import \
        trace_sources_mixdown
    from realisticaudioraytracing2d_tpu_torch.parallel.sweep import \
        sweep_rooms
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        click_clip, read_wav, write_wav)
    from realisticaudioraytracing2d_tpu_torch.utils.checkpoint import \
        load_ir_state

    # --- 0. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only "
                         "on an NVIDIA GPU")
    card = card_line()
    check(not card.startswith("nvidia-smi"), f"card line: {card}")
    dev = torch.device(DEVICE)
    print(f"[0] device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # --- 1. build ------------------------------------------------------------
    secs = build.build()
    build.load_library()
    # every instantiation: bounce frames_ir_kernel<host, directive, K, G>
    # by band bucket (K = 0: the scratch) and lane group G,
    # accel_bounce_kernel<K, early_out, directive> (K7 and K8), the step
    # and sweep kernels
    print(f"[1] build: {secs:.1f} s ({build.library_path().name}); "
          + " | ".join(ptxas_lines(build.build_log())), flush=True)

    def setup(room_fn, cfg):
        room = room_fn(device=dev)
        eng = art.Engine(room.scene, cfg)
        return room, eng, eng.params(room.source, room.listener)

    smoll, smoll_eng, smoll_p = setup(
        art.rooms.smoll_room, art.smoll_room_config(ray_count=RAYS))
    s = bk.fixed_point_scale(smoll_p, 1, RAYS, BOUNCES)
    s50 = bk.fixed_point_scale(smoll_p, 50, BIG_RAYS, BIG_BOUNCES)
    print(f"    fixed point: S = 2^{int(torch.log2(s))} at {RAYS} x {BOUNCES}"
          f" x 1 frame (resolution {1 / float(s):.3g}); S = 2^"
          f"{int(torch.log2(s50))} at {BIG_RAYS} x {BIG_BOUNCES} x 50 "
          "frames", flush=True)
    kw = dict(sample_rate=SR, ir_length=T)
    errs = {"K3": 0.0, "K4": 0.0, "K9": 0.0, "K7": 0.0, "K8": 0.0,
            "K1": 0.0, "K2": 0.0, "K5": 0.0, "K6": 0.0, "K1b": 0.0,
            "K2b": 0.0}

    def same_numbers(tag, kernel, got, want):
        """Kernel vs plain on the same uniforms: energy, first nonzero bin,
        per-bin L1 (limits at the top); keeps the max abs error in errs
        (``kernel`` None: in none)."""
        torch.cuda.synchronize()
        g, w = got.cpu().numpy().ravel(), want.cpu().numpy().ravel()
        check(np.isfinite(g).all() and w.sum() > 0, f"{tag}: IR finite")
        e_rel = abs(g.sum() - w.sum()) / w.sum()
        first_g, first_w = np.flatnonzero(g)[0], np.flatnonzero(w)[0]
        err = float(np.abs(g - w).max())
        if kernel is not None:
            errs[kernel] = max(errs[kernel], err)
        print(f"{tag}: energy {e_rel:.2e} (< {SAME_ENERGY:g}), first bin "
              f"{first_g}/{first_w}, L1 {l1(g, w):.2e} (< {SAME_L1:g}), max "
              f"abs {err:.3e} of peak {w.max():.3e}", flush=True)
        check(e_rel < SAME_ENERGY, f"{tag}: energy")
        check(first_g == first_w, f"{tag}: first nonzero bin")
        check(l1(g, w) < SAME_L1, f"{tag}: L1")

    # --- 2. K3 vs plain, same uniforms ---------------------------------------
    for name, room_fn, cfg in (
            ("SmollRoom", art.rooms.smoll_room, art.smoll_room_config()),
            ("Big Room", art.rooms.big_room, art.big_room_config())):
        room, eng, p = setup(room_fn, cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        for source, (emit, u) in (
                ("torch.rand", rng.bounce_uniforms(gen, 4, BOUNCES, RAYS,
                                                   dev)),
                ("Philox", rng.philox_uniforms(1, 4, BOUNCES, RAYS, dev))):
            same_numbers(
                f"[2] K3 vs plain {name} {RAYS} x {BOUNCES} x 4 frames, "
                f"{source} uniforms", "K3",
                bk.trace_frames_ir_whole(room.scene, p, emit, u, **kw),
                bk.trace_frames_ir_plain(room.scene, p, emit, u, **kw))

    # --- 3. K4 vs plain at 131k x 8 x 8 frames ---------------------------
    big = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES)
    nf = BIG_FRAMES
    k4 = bk.trace_frames_ir_mega(smoll.scene, smoll_p, 2024, nf, **big, **kw)
    k4_again = bk.trace_frames_ir_mega(smoll.scene, smoll_p, 2024, nf, **big,
                                       **kw)
    k4_other = bk.trace_frames_ir_mega(smoll.scene, smoll_p, 2025, nf, **big,
                                       **kw)
    gen = torch.Generator(device=dev).manual_seed(2)
    emit, u = rng.bounce_uniforms(gen, nf, BIG_BOUNCES, BIG_RAYS, dev)
    indep = bk.trace_frames_ir_plain(smoll.scene, smoll_p, emit, u, **kw)
    del emit, u
    same = bk.trace_frames_ir_mega_plain(smoll.scene, smoll_p, 2024, nf,
                                         **big, **kw)
    torch.cuda.synchronize()
    check(torch.equal(k4, k4_again), "K4 same seed -> bit-identical IR")
    check(not torch.equal(k4, k4_other), "K4 other seed -> other IR")
    a = k4.cpu().numpy().ravel() / nf
    o = indep.cpu().numpy().ravel() / nf
    e_rel = abs(a.sum() - o.sum()) / o.sum()
    first_a = int(np.nonzero(a > 1e-7)[0][0])
    first_o = int(np.nonzero(o > 1e-7)[0][0])
    win = SR // 200
    n = (T // win) * win
    env = float(np.linalg.norm(a[:n].reshape(-1, win).sum(1)
                               - o[:n].reshape(-1, win).sum(1))
                / np.linalg.norm(o[:n].reshape(-1, win).sum(1)))

    def slope(ir):
        w10 = SR // 100
        e = ir[ir.argmax():ir.argmax() + 6 * w10].reshape(6, w10).sum(1)
        check((e > 0).all(), "decay windows nonzero")
        return np.polyfit(np.arange(6.0), np.log(e), 1)[0]

    s_a, s_o = slope(a), slope(o)
    print(f"[3] K4 vs plain {BIG_RAYS} x {BIG_BOUNCES} x {nf} frames, "
          f"independent draws: energy "
          f"{e_rel:.2e} (< 2e-2), first arrival {first_a}/{first_o} (<= 4 "
          f"bins), 5 ms envelope {env:.2e} (< 5e-2), decay slope "
          f"{s_a:.4f}/{s_o:.4f} ({abs(s_a - s_o) / abs(s_o):.2e} < 1e-1); "
          "rerun bit-identical, other seed differs", flush=True)
    check(e_rel < 0.02, "K4 energy")
    check(abs(first_a - first_o) <= 4, "K4 first arrival")
    check(env < 0.05, "K4 5 ms envelope")
    check(s_o < 0 and abs(s_a - s_o) / abs(s_o) < 0.10, "K4 decay slope")
    same_numbers(f"[3] K4 vs plain {BIG_RAYS} x {BIG_BOUNCES} x {nf} frames,"
                 " same Philox numbers", "K4", k4, same)
    del k4, k4_again, k4_other, indep, same

    # --- 4. the main path: the stream ------------------------------------
    cfg = art.smoll_room_config(ray_count=RAYS)
    clicks = (0.1, 0.7, 1.3)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=clicks),
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    fixed = rng.bounce_uniforms(gen, 1, BOUNCES, RAYS, dev)
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, **kw)
    # each kernel at the shape the stream gives it (one frame, a partial
    # last block of rays, the one-frame fixed-point scale): chunk 0's
    # Philox key for K4, the fixed-IR stream's uniforms for K3
    chunk0 = rng.mix_seed(7, 0)
    same_numbers(f"[4] K4 vs plain at the stream's shape, {RAYS} x {BOUNCES}"
                 " x 1 frame, chunk 0's Philox numbers", "K4",
                 bk.trace_frames_ir_mega(smoll.scene, smoll_p, chunk0, 1,
                                         **one),
                 bk.trace_frames_ir_mega_plain(smoll.scene, smoll_p, chunk0,
                                               1, **one))
    same_numbers(f"[4] K3 vs plain at the stream's shape, {RAYS} x {BOUNCES}"
                 " x 1 frame, the fixed-IR stream's uniforms", "K3",
                 bk.trace_frames_ir_whole(smoll.scene, smoll_p, *fixed, **kw),
                 bk.trace_frames_ir_plain(smoll.scene, smoll_p, *fixed, **kw))

    wrappers, only, counted = launch_counters()

    def counted_stream(streamer):
        """Stream the clip; return it with the launches of this run only."""
        return counted(lambda: streamer.stream_clip(dry, lambda i: smoll_p))

    n_chunks = 20 + 15
    args0 = bk.k4_args.launches
    wet, seeded = counted_stream(art.Streamer(smoll.scene, cfg, seed=7))
    args_seeded, args0 = bk.k4_args.launches - args0, bk.k4_args.launches
    check(seeded == only(K4=n_chunks) and args_seeded == n_chunks,
          f"seeded stream launch counts {seeded}, {args_seeded} argument "
          "launches")
    static, fixed_ir = counted_stream(
        art.Streamer(smoll.scene, cfg, uniforms_fn=lambda i: fixed))
    args_fixed = bk.k4_args.launches - args0
    check(fixed_ir == only(K3=n_chunks) and args_fixed == n_chunks,
          f"fixed-IR stream launch counts {fixed_ir}, {args_fixed} "
          "argument launches")
    launches = {"K3": fixed_ir["K3"], "K4": seeded["K4"]}
    out = wet.cpu().numpy()
    check(out.shape == (1, n_chunks * CHUNK), f"stream shape {out.shape}")
    check(np.isfinite(out).all() and np.abs(out).max() > 0,
          "stream finite, peak > 0")
    tails = []
    for tc in clicks:
        c = int(tc * SR)
        after = float((out[0, c:c + int(0.3 * SR)] ** 2).sum())
        before = float((out[0, max(0, c - int(0.3 * SR)):c] ** 2).sum())
        tails.append(after / max(before, 1e-30))
        check(after > 2 * before, f"reverb tail after the click at {tc} s")
    first = int(np.flatnonzero(np.abs(out[0]) > 1e-9)[0])
    bake = art.bake_audio(dry, smoll_eng.trace_frames(smoll_p,
                                                      uniforms=fixed),
                          normalize=False).cpu().numpy()
    st = static.cpu().numpy()[0]
    bake_ok = np.allclose(st, bake[:st.shape[0]], rtol=2e-3, atol=2e-5)
    print(f"[4] stream: {n_chunks} chunks -> {out.shape}, peak "
          f"{np.abs(out).max():.3e}, first sound at "
          f"{(first - clicks[0] * SR) / SR * 1e3:.1f} ms after the first "
          f"click, tail/pre-click energy {[f'{r:.3g}' for r in tails]}, "
          f"launches {seeded} (seeded stream) and {fixed_ir} (fixed-IR "
          f"stream), argument kernel {args_seeded} and {args_fixed}; "
          f"fixed-IR stream vs bake: max abs "
          f"{np.abs(st - bake[:st.shape[0]]).max():.2e} (rtol 2e-3, atol "
          f"2e-5) {'ok' if bake_ok else 'FAILED'}", flush=True)
    check(bake_ok, "fixed-IR stream == bake")
    k4_args_phase(dict(torch=torch, art=art, bk=bk, build=build, dev=dev,
                       smoll=smoll, smoll_p=smoll_p))

    # --- 6. the sweep: cli sweep --rooms 1024 at the defaults ----------------
    sweep_kw = dict(n_rays=RAYS, max_bounces=BOUNCES, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "irs.npz")
        t0 = time.perf_counter()
        _, swept = counted(lambda: cli.main(
            ["sweep", "--rooms", str(SWEEP_ROOMS), "--out", path]))
        cli_s = time.perf_counter() - t0
        with np.load(path) as npz:
            irs_cli, src, lis = npz["irs"], npz["sources"], npz["listeners"]
    check(swept == only(K9=1),
          f"sweep launch counts {swept}")
    check(irs_cli.shape == (SWEEP_ROOMS, 1, T, 1) and irs_cli.dtype ==
          np.float32 and np.isfinite(irs_cli).all(),
          f"sweep npz: irs {irs_cli.shape} {irs_cli.dtype}, finite")
    scenes, src_r, lis_r = art.rooms.random_rooms(SWEEP_ROOMS, seed=0,
                                                  device=dev)
    check(np.array_equal(src, src_r) and np.array_equal(lis, lis_r),
          "sweep npz: sources and listeners of random_rooms(seed=0)")
    k9 = bk.trace_rooms_ir_mega(scenes, src, lis, 0, SWEEP_FRAMES,
                                **sweep_kw)
    k9_again = bk.trace_rooms_ir_mega(scenes, src, lis, 0, SWEEP_FRAMES,
                                      **sweep_kw)
    torch.cuda.synchronize()
    check(torch.equal(k9, k9_again), "K9 sweep rerun bit-identical")
    del k9_again
    cli_again = (k9 / k9.new_tensor(float(SWEEP_FRAMES))).cpu().numpy()
    check(np.array_equal(cli_again, irs_cli),
          "cli sweep == K9 over the same rooms / 8 frames")
    del cli_again
    # K4's stream is entry 0 of K9's: room 0 through K4, through K9 alone
    # (E = 1, offset 0) and as entry 0 of the 1,024-room launch
    room0 = art.TraceParams.make(src[0], lis[0], device=dev)
    k4_room0 = bk.trace_frames_ir_mega(scenes.row(0), room0, 0, SWEEP_FRAMES,
                                       **sweep_kw)
    k9_room0 = bk.trace_rooms_ir_mega(scenes.row(slice(0, 1)), src[:1],
                                      lis[:1], 0, SWEEP_FRAMES, **sweep_kw)
    torch.cuda.synchronize()
    check(torch.equal(k9_room0[0], k4_room0) and torch.equal(k9[0], k4_room0),
          "K9 (E = 1) and entry 0 of the sweep == K4 on room 0")
    del k4_room0, k9_room0
    with_energy = int((irs_cli.reshape(SWEEP_ROOMS, -1).sum(-1) > 0).sum())
    scales = bk.fixed_point_scales(
        torch.as_tensor(src, device=dev), torch.as_tensor(lis, device=dev)
        [:, None], torch.ones(SWEEP_ROOMS, device=dev), SWEEP_FRAMES, RAYS,
        BOUNCES)
    s_min = int(torch.argmin(scales))
    d_min = float(np.linalg.norm(src[s_min] - lis[s_min]))
    print(f"[6] sweep: cli sweep --rooms {SWEEP_ROOMS} ({RAYS} x {BOUNCES} x "
          f"{SWEEP_FRAMES} frames, {T} bins) in {cli_s:.2f} s incl. room "
          f"build and npz write; irs {irs_cli.shape}; launches {swept}; "
          f"{with_energy}/{SWEEP_ROOMS} rooms carry energy (>= 90%); rerun "
          f"bit-identical; npz == K9 / {SWEEP_FRAMES}; K9 (E = 1) == entry 0 "
          f"== K4 on room 0, bit for bit; smallest fixed-point "
          f"S = 2^{int(torch.log2(scales[s_min]))} (room {s_min}, source-"
          f"listener distance {d_min:.3f} m), largest S = 2^"
          f"{int(torch.log2(scales.max()))}", flush=True)
    check(with_energy >= 0.9 * SWEEP_ROOMS, "sweep: >= 90% rooms carry energy")
    del irs_cli
    for r in (0, 1, SWEEP_ROOMS // 2 - 1, SWEEP_ROOMS - 1):
        tag = (f"[6] K9 vs plain, room {r} of the sweep, {RAYS} x {BOUNCES} "
               f"x {SWEEP_FRAMES} frames, same Philox numbers")
        want = bk.trace_rooms_ir_mega_plain(
            scenes.row(slice(r, r + 1)), src[r:r + 1], lis[r:r + 1], 0,
            SWEEP_FRAMES, entry_offset=r, **sweep_kw)[0]
        if float(want.sum()) > 0:
            same_numbers(tag, "K9", k9[r], want)
        else:               # no ray reaches this room's listener
            print(f"{tag}: no energy in either", flush=True)
            check(torch.equal(k9[r], want), f"{tag}: both silent")
    del k9

    # --- 7. the mixdown: 64 sources, stereo, SmollRoom ---------------------
    g = np.random.default_rng(11)       # tests/test_parallel.py's sources
    sources = np.stack([g.uniform(-15, 15, N_SOURCES),
                        g.uniform(-3, 8, N_SOURCES)], -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    mix_p = art.TraceParams.make(sources, ears, device=dev)
    mix, mixed = counted(lambda: trace_sources_mixdown(
        smoll.scene, mix_p, 7, **sweep_kw))
    check(mixed == only(K9=1),
          f"mixdown launch counts {mixed}")
    mix_plain = trace_sources_mixdown(smoll.scene, mix_p, 7,
                                      backend="plain", **sweep_kw)
    check(tuple(mix.shape) == (2, T, 1), f"mixdown shape {tuple(mix.shape)}")
    for ear in range(2):
        same_numbers(f"[7] mixdown of {N_SOURCES} sources vs the plain sum "
                     f"over sources, ear {ear}, {RAYS} x {BOUNCES}, same "
                     "Philox numbers", "K9", mix[ear], mix_plain[ear])
    ear_diff = float((mix[0] - mix[1]).abs().sum() / mix[0].abs().sum())
    print(f"[7] mixdown: {N_SOURCES} sources -> {tuple(mix.shape)}, "
          f"launches {mixed}; ears differ by L1 {ear_diff:.3f}", flush=True)
    check(ear_diff > 0, "mixdown: the two ears differ")
    launches["K9"] = swept["K9"] + mixed["K9"]

    def work(fn):
        """(wall tests, wall sweeps, slab tests) one call of ``fn(n)``
        made."""
        n = torch.zeros(3, dtype=torch.int64, device=dev)
        fn(n)
        torch.cuda.synchronize()
        return tuple(int(x) for x in n.cpu())

    # --- 8. the large-scene path: the city through K7 and K8 -----------------
    city_kw = dict(sample_rate=CITY_SR, ir_length=CITY_T)
    city_run = dict(n_rays=BIG_RAYS, max_bounces=CITY_BOUNCES, **city_kw)

    def city(n_boxes, n_bands=1):
        t0 = time.perf_counter()
        scene, p = city_setup(art, dev, n_boxes, n_bands)
        return scene, p, time.perf_counter() - t0

    # 8a. K4 = K7 = K8 on a sorted city K4 can take
    scene_a, p_a, _ = city(1200)
    sorted_a = ak.prepare(scene_a).scene
    check(scene_a.n_walls == 4808 and sorted_a.n_walls <= bk.MAX_WALLS,
          f"8a: {scene_a.n_walls} walls, {sorted_a.n_walls} sorted")
    k4a = bk.trace_frames_ir_mega(sorted_a, p_a, 31, CITY_FRAMES, **city_run)
    parity = {f"{k} early_out={eo}": torch.equal(fn(
        scene_a, p_a, 31, CITY_FRAMES, early_out=eo, **city_run), k4a)
        for k, fn in (("K7", ak.trace_frames_ir_accel),
                      ("K8", ak.trace_frames_ir_accel_sorted))
        for eo in (True, False)}
    torch.cuda.synchronize()
    print(f"[8a] city_scene(1200): {scene_a.n_walls} walls, sorted and "
          f"padded to {sorted_a.n_walls}, {BIG_RAYS} x {CITY_BOUNCES} x "
          f"{CITY_FRAMES} frames, IR energy {float(k4a.sum()):.4e}: equal to "
          f"K4 bit for bit: {parity}", flush=True)
    check(float(k4a.sum()) > 0 and all(parity.values()),
          "8a: K4 == K7 == K8 bit for bit")
    del k4a

    city_launches = {"K7": 0, "K8": 0}
    large = {}

    def against_plain(tag, key, plain, scene, p, seed, got):
        """Hold the kernel's IR ``got`` of a city at full shape against its
        plain version on the same Philox numbers, the plain version run
        over slices of rays; return the plain call's milliseconds (CUDA
        events)."""
        chunk = max(256, PLAIN_ELEMENTS // (scene.n_walls
                                            * p.listeners.shape[0]))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(scene, p, seed, CITY_FRAMES, ray_chunk=chunk,
                     **city_run)
        end.record()
        end.synchronize()
        same_numbers(f"{tag} {key} vs plain at full shape, {BIG_RAYS} x "
                     f"{CITY_BOUNCES} x {CITY_FRAMES} frames, "
                     f"{p.listeners.shape[0]} listener(s), the plain version "
                     f"over slices of {chunk} rays in "
                     f"{start.elapsed_time(end) / 1e3:.1f} s, same Philox "
                     "numbers", key, got, want)
        return start.elapsed_time(end)

    def large_scene(tag, key, scene, p, seed, build_s, n_bands=1,
                    plain=None, silent=False):
        """Drive a city through trace_accumulate(auto) (counts reset and
        read), check reruns and early_out=False bit-identical, hold the
        kernel's IR against its plain version at full shape if ``plain``,
        and time it with early_out on and off. ``silent``: the listener is
        enclosed, so an IR of zeros is right."""
        fn = wrappers[key]
        kname = "accel_bounce_kernel"
        ir, launched = counted(lambda: art.trace_accumulate(
            scene, p, art.IRState.zeros(CITY_T, p.listeners.shape[0],
                                        n_bands, device=dev),
            n_frames=CITY_FRAMES, seed=seed, n_rays=BIG_RAYS,
            max_bounces=CITY_BOUNCES, sample_rate=CITY_SR).sum)
        check(launched == only(**{key: CITY_BOUNCES}),
              f"{tag}: launch counts {launched}")
        city_launches[key] += launched[key]
        g = ir.cpu().numpy()
        check(np.isfinite(g).all() and g.shape == (p.listeners.shape[0],
                                                   CITY_T, n_bands),
              f"{tag}: IR {g.shape} finite")
        check(silent or (g.reshape(len(g), -1).sum(-1) > 0).any(),
              f"{tag}: energy")
        again = fn(scene, p, seed, CITY_FRAMES, **city_run)
        brute = fn(scene, p, seed, CITY_FRAMES, early_out=False, **city_run)
        torch.cuda.synchronize()
        check(torch.equal(ir, again), f"{tag}: rerun bit-identical")
        check(torch.equal(ir, brute), f"{tag}: early_out=False bit-identical")
        del again, brute
        plain_ms = None if plain is None else against_plain(
            tag, key, plain, scene, p, seed, ir)
        run = dict(city_run, n_frames=CITY_FRAMES)
        on = cuda_ms(torch, lambda: fn(scene, p, 5, **run), 3)
        off = cuda_ms(torch, lambda: fn(scene, p, 5, early_out=False, **run),
                      1)
        dev_on = kernel_device_ms(torch, lambda: fn(scene, p, 5, **run), 2,
                                  kname, CITY_BOUNCES)
        w_on = work(lambda n: fn(scene, p, 5, work_counts=n, **run))
        w_off = work(lambda n: fn(scene, p, 5, early_out=False,
                                  work_counts=n, **run))
        prep = ak.prepare(scene)
        n_l = p.listeners.shape[0]
        n_bytes = 4 * (prep.walls.numel() + prep.aabb.numel()
                       + prep.saabb.numel() + 2 * n_l + 5
                       + n_l * CITY_T * n_bands)
        check(w_on[1] == w_off[1], f"{tag}: early_out on and off made the "
              f"same sweeps ({w_on[1]}, {w_off[1]}): the same ray paths")
        if tag in PARENT_WORK and key == "K8":
            check_work(tag, w_on, PARENT_WORK[tag], exact=False)
        elif tag in PARENT_WORK:
            # K7: the ray paths, and so the sweeps, of the kernel it
            # replaced; each block's near-to-far box order tightens a lane's
            # closest hit sooner, so it tests fewer walls and boxes
            want = PARENT_WORK[tag]
            print(f"{tag} work against the kernel before the redesign: "
                  f"sweeps {w_on[1]} / {want[1]}, wall tests "
                  f"{w_on[0] / want[0]:.3f}x, slab tests "
                  f"{w_on[2] / want[2]:.3f}x", flush=True)
            check(w_on[1] == want[1], f"{tag}: sweeps {w_on[1]} == "
                  f"{want[1]}")
        bnd = bound(w_on, n_bytes)
        brute_tests = BIG_RAYS * CITY_BOUNCES * 2 * scene.n_walls * CITY_FRAMES
        low = "; the highest band carries less energy than the lowest" \
            if n_bands > 1 else ""
        energy = [float(x) for x in g.reshape(len(g), -1).sum(-1)]
        print(f"{tag} {scene.n_walls} walls (built in {build_s:.2f} s), "
              f"{prep.n_clusters} clusters of {prep.cluster_size} in "
              f"{prep.n_clusters // prep.group} supers, K={n_bands}, "
              f"{BIG_RAYS} x {CITY_BOUNCES} x {CITY_FRAMES} frames through "
              f"trace_accumulate(auto): launches {launched}; IR energy per "
              f"listener {energy}; rerun and early_out=False bit-identical"
              f"{low}. {key} per call: "
              f"{on:.3f} ms early_out on, {off:.3f} ms off = "
              f"{off / on:.2f}x over brute force; device "
              f"{'not measured' if dev_on is None else f'{dev_on:.4f} ms'}"
              f"; made {w_on[0]} wall tests, {w_on[1]} sweeps, {w_on[2]} "
              f"slab tests (brute force: {w_off[0]} tests, {w_off[1]} "
              f"sweeps); brute-equivalent R*B*2*W*F = {brute_tests} tests "
              f"= {brute_tests / on / 1e9:.2f} T tests/s (early_out on), "
              f"{brute_tests / off / 1e9:.3f} T/s (off); bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}; {FMAD_NOTE}), the call at "
              f"{bnd[0] / on * 100:.1f}% of it", flush=True)
        if key == "K8":
            k8_call_checks(tag, scene, p, on)
        large[tag] = dict(ms=on, brute_ms=off, device_ms=dev_on, work=w_on,
                          brute_work=w_off, bound=bnd, walls=scene.n_walls,
                          plain_ms=plain_ms)
        return g

    def k8_call_checks(tag, scene, p, call_ms):
        """The bookkeeping of one K8 call: the keys its kernel leaves equal
        morton_ray_keys of the state it leaves; under the profiler it
        makes one K8 launch per bounce and one sort between two, gathers
        nothing and sorts no walls; the device-busy share of the call."""
        prep = ak.prepare(scene)
        left = []
        ak.trace_frames_ir_accel_sorted(scene, p, 5, CITY_FRAMES,
                                        keys_out=left, **city_run)
        torch.cuda.synchronize()
        keys_ok = [torch.equal(keys, accel.morton_ray_keys(
            state[0], state[1], istate[1] >= 0, prep.bounds[:2],
            prep.bounds[2:])) for state, istate, keys in left]
        dead = [int((istate[1] < 0).sum()) for _, istate, _ in left]
        del left
        ak.prepare.builds = 0
        busy, share, names = busy_share(
            torch, lambda: ak.trace_frames_ir_accel_sorted(
                scene, p, 5, CITY_FRAMES, **city_run), call_ms)
        n_k8 = sum("accel_bounce_kernel" in n for n in names)
        n_sort = sum("RadixSortOnesweep" in n or "SingleTileKernel" in n
                     for n in names)
        gathers = [n for n in names if "index_select" in n.lower()
                   or "gather" in n.lower()]
        print(f"{tag} one K8 call: in-kernel keys == morton_ray_keys after "
              f"each of {len(keys_ok)} bounces: {keys_ok} (dead rays "
              f"{dead} of {BIG_RAYS * CITY_FRAMES}); under the profiler "
              f"{len(names)} device kernels: {n_k8} K8 launches, {n_sort} "
              f"sort passes, {len(gathers)} gathers; prepare built "
              f"{ak.prepare.builds} scenes; device busy {busy:.4f} ms = "
              f"{share * 100:.1f}% of the unprofiled {call_ms:.3f} ms call",
              flush=True)
        check(len(keys_ok) == CITY_BOUNCES and all(keys_ok),
              f"{tag}: in-kernel keys == morton_ray_keys")
        check(n_k8 == CITY_BOUNCES and not gathers and ak.prepare.builds == 0
              and len(names) <= 30 * CITY_BOUNCES,
              f"{tag}: one K8 call is {CITY_BOUNCES} launches, sorts and "
              f"nothing else ({len(names)} kernels, {gathers})")
        large[tag + " busy"] = (busy, share)

    # 8b. the 40,008-wall city, K = 1, through K8
    scene_b, p_b, secs = city(10000)
    check(scene_b.n_walls == 40008, f"8b: {scene_b.n_walls} walls")
    large_scene("[8b]", "K8", scene_b, p_b, 41, secs,
                plain=ak.trace_frames_ir_accel_sorted_plain)
    del scene_b, p_b
    # 8c. the 100,016-wall city. Its listener (and source) sit inside a box,
    # so no ray reaches the bench's listener; a second listener in the open
    # gives the bit-identity checks an IR to compare.
    scene_c, p_c, secs = city(25002)
    check(scene_c.n_walls == 100016, f"8c: {scene_c.n_walls} walls")
    large_scene("[8c]", "K8", scene_c, p_c, 43, secs, silent=True)
    open_spot = free_spot(scene_c, p_c.source)
    p_c2 = p_c._replace(listeners=torch.stack([p_c.listeners[0],
                                               open_spot]))
    ir_c2 = ak.trace_frames_ir_accel_sorted(scene_c, p_c2, 44, CITY_FRAMES,
                                            **city_run)
    brute_c2 = ak.trace_frames_ir_accel_sorted(
        scene_c, p_c2, 44, CITY_FRAMES, early_out=False, **city_run)
    torch.cuda.synchronize()
    e_c2 = [float(x) for x in ir_c2.sum(dim=(1, 2))]
    print(f"[8c] with a second listener in the open at "
          f"{open_spot.tolist()}: IR energy per listener {e_c2}; "
          f"early_out=False bit-identical: {torch.equal(ir_c2, brute_c2)}",
          flush=True)
    check(e_c2[1] > 0 and torch.equal(ir_c2, brute_c2),
          "8c: second listener: energy, early_out=False bit-identical")
    del brute_c2
    against_plain("[8c]", "K8", ak.trace_frames_ir_accel_sorted_plain,
                  scene_c, p_c2, 44, ir_c2)
    del scene_c, p_c, p_c2, ir_c2
    # 8d. the 8-band 40,008-wall city through K7
    scene_d, p_d, secs = city(10000, n_bands=8)
    banded_ir = large_scene("[8d]", "K7", scene_d, p_d, 47, secs, n_bands=8,
                            plain=ak.trace_frames_ir_accel_plain)
    check(banded_ir[..., -1].sum() < banded_ir[..., 0].sum(),
          "8d: highest band quieter than the lowest")

    # --- 9. the stream on a 10,008-wall city through K8 ------------------
    scene_9, p_9, secs = city(2500)
    check(scene_9.n_walls == 10008, f"9: {scene_9.n_walls} walls")
    same_numbers(f"[9] K8 vs plain at the stream's shape, {RAYS} x {BOUNCES}"
                 " x 1 frame, chunk 0's Philox numbers", "K8",
                 ak.trace_frames_ir_accel_sorted(scene_9, p_9, chunk0, 1,
                                                 **one),
                 ak.trace_frames_ir_accel_sorted_plain(scene_9, p_9, chunk0,
                                                       1, **one))
    # a scene no call has prepared yet: the same walls in new tensors
    scene_9 = Scene(*(x.clone() for x in scene_9))
    ak.prepare.builds = 0
    city_wet, streamed = counted(lambda: art.Streamer(
        scene_9, cfg, seed=7).stream_clip(dry, lambda i: p_9))
    stream_builds = ak.prepare.builds
    check(streamed == only(K8=n_chunks * BOUNCES),
          f"city stream launch counts {streamed}")
    check(stream_builds == 1, f"city stream: prepare sorted the walls "
          f"{stream_builds} times over {n_chunks} chunks (1)")
    city_launches["K8"] += streamed["K8"]
    out9 = city_wet.cpu().numpy()
    check(out9.shape == (1, n_chunks * CHUNK) and np.isfinite(out9).all()
          and np.abs(out9).max() > 0, f"city stream {out9.shape}: finite, "
          "peak > 0")
    # no sound before the straight path could bring it: sound crosses the
    # boxes at c / 0.6 (their ior, MATERIAL_INTERIOR) and the air at c
    first9 = (int(np.flatnonzero(np.abs(out9[0]) > 1e-9)[0])
              - clicks[0] * SR) / SR
    direct = (float(np.linalg.norm(p_9.listeners[0].cpu().numpy()
                                   - p_9.source.cpu().numpy()))
              - float(p_9.listener_radius)) / 343.0
    check(first9 >= 0.6 * direct, "city stream: no sound before the "
          f"straight path ({first9:.4f} s vs {0.6 * direct:.4f} s)")
    streamer = art.Streamer(scene_9, cfg, seed=11)
    streamer.stream_clip(dry, lambda i: p_9, total_chunks=5)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamer.stream_clip(dry, lambda i: p_9)
    torch.cuda.synchronize()
    ms_city = (time.perf_counter() - t0) * 1e3 / n_chunks
    busy9, share9, _ = busy_share(
        torch, lambda: streamer.stream_clip(dry, lambda i: p_9,
                                            total_chunks=5), 5 * ms_city)
    print(f"[9] city stream: city_scene(2500), {scene_9.n_walls} walls "
          f"(built in {secs:.2f} s), {RAYS} x {BOUNCES}, {n_chunks} chunks "
          f"-> {out9.shape}, launches {streamed}, prepare built "
          f"{stream_builds} scene, peak "
          f"{np.abs(out9).max():.3e}, first sound {first9 * 1e3:.1f} ms "
          f"after the first click (straight path {direct * 1e3:.1f} ms in "
          f"air, {0.6 * direct * 1e3:.1f} ms through boxes); "
          f"{ms_city:.3f} ms per 100 ms chunk = {100.0 / ms_city:.1f}x "
          f"realtime on {card}; device busy {busy9 / 5:.4f} ms per chunk = "
          f"{share9 * 100:.1f}% of it", flush=True)

    # --- 10. the hit-record path: K1, K2, K5, K6 ---------------------------
    sc = smoll.scene
    big_room, _, big_p = setup(art.rooms.big_room, art.big_room_config())
    ears = torch.stack([smoll_p.listeners[0],
                        smoll_p.listeners[0] + smoll_p.listeners.new_tensor(
                            [1.5, 0.5])])
    smoll_p2 = smoll_p._replace(listeners=ears)
    p_9two = p_9._replace(listeners=torch.stack(
        [p_9.listeners[0], free_spot(scene_9, p_9.source)]))
    LATER = 3

    def ray_states(scene, p, n_rays, seed):
        """The ray states of a real trace of ``seed`` at bounce 0 and before
        bounce ``LATER`` (K1/K2 on the route the scene takes)."""
        emit, u = rng.philox_uniforms(seed, 1, LATER, n_rays, dev)
        walls = tk.sweep_walls(scene)
        st = tt._emit(p, n_rays, scene.n_bands, emit[0])
        first = st
        for b in range(LATER):
            st, _ = tt._bounce(scene, p, st, u[0, b], walls)
        return first, st

    def shadow_rays(p, o):
        """The shadow rays from ``o[R, 2]`` to every listener: ``[R, L, 2]``
        origins and unit directions, the occlusion pass's input shape, and
        the limits ``[R, L]``: the distance to the listener less the NEE
        slack."""
        to_lis = p.listeners[None] - o[:, None]
        dist = to_lis.norm(dim=-1)
        d = to_lis / dist[..., None].clamp(min=1e-10)
        return (o[:, None].expand_as(d).contiguous(), d,
                dist - tt.OCCLUSION_SLACK)

    # 10a. K1 and K2 on both routes against their plain versions on the
    # rays of a trace (bounce 0 and before bounce LATER), without and with
    # the masks (the state's alive rays) and K2's limits (each shadow ray
    # up to its listener); the plain versions over slices of rays, their
    # masked results by the same torch.where they apply
    sweep_tests = {"K1": 0, "K2": 0}
    scene_40, p_40, _ = city(10000)
    scene_100, p_100, _ = city(25002)
    p_100 = p_100._replace(listeners=torch.stack(
        [p_100.listeners[0], free_spot(scene_100, p_100.source)]))
    p_40 = p_40._replace(listeners=torch.stack(
        [p_40.listeners[0], free_spot(scene_40, p_40.source)]))
    inf = torch.tensor(1e8, device=dev)
    for name, scene, p in (("SmollRoom", sc, smoll_p),
                           ("Big Room", big_room.scene, big_p),
                           ("city_scene(2500), 2 listeners", scene_9,
                            p_9two),
                           ("city_scene(10000), 2 listeners", scene_40,
                            p_40),
                           ("city_scene(25002), 2 listeners", scene_100,
                            p_100)):
        packed = tk.pack_walls(scene)
        prep = ak.prepare(scene)
        routes = {"K1": tk.SweepWalls(packed), "K1b": tk.SweepWalls(packed,
                                                                   prep)}
        n_l = p.listeners.shape[0]
        step = max(256, PLAIN_ELEMENTS // (scene.n_walls * n_l))
        for at, st in zip((0, LATER), ray_states(scene, p, BIG_RAYS, 20)):
            o, d, alive = st.pos, st.dir, st.alive
            so, sd, limit = shadow_rays(p, o)
            a2 = alive[:, None].expand(-1, n_l).contiguous()
            keys = tk.ray_keys(o, alive, prep.bounds)
            check(torch.equal(keys, accel.morton_ray_keys(
                o[:, 0], o[:, 1], alive, prep.bounds[:2], prep.bounds[2:])),
                f"10a {name} bounce {at}: ray_keys == morton_ray_keys")
            got = {k: (tk.nearest_hit(o, d, w), tk.nearest_hit(o, d, w, alive),
                       tk.occlusion_min(so, sd, w),
                       tk.occlusion_min(so, sd, w, a2, limit))
                   for k, w in routes.items()}
            torch.cuda.synchronize()
            equal = {k: True for k in routes}
            for r0 in range(0, BIG_RAYS, step):
                sl = slice(r0, r0 + step)
                t_p, idx_p = tk.nearest_hit_plain(o[sl], d[sl], packed)
                occ_p = tk.occlusion_min_plain(so[sl], sd[sl], packed)
                want = ((t_p, idx_p),
                        (torch.where(alive[sl], t_p, inf),
                         torch.where(alive[sl], idx_p, -1)), occ_p,
                        torch.where(a2[sl] & (occ_p < limit[sl]), occ_p, inf))
                for k, (full, masked, occ, occ_ml) in got.items():
                    kk = "K2b" if k == "K1b" else "K2"
                    errs[k] = max(errs[k],
                                  float((full[0][sl] - t_p).abs().max()))
                    errs[kk] = max(errs[kk],
                                   float((occ[sl] - occ_p).abs().max()))
                    equal[k] &= all(torch.equal(g[sl], w) for g, w in (
                        *zip(full, want[0]), *zip(masked, want[1]),
                        (occ, want[2]), (occ_ml, want[3])))
            sweep_tests["K1"] += BIG_RAYS * scene.n_walls
            sweep_tests["K2"] += BIG_RAYS * n_l * scene.n_walls
            idx = got["K1"][0][1]
            occ = got["K1"][2]
            hit = float((idx >= 0).float().mean())
            blocked = float((occ < 1e8).float().mean())
            print(f"[10a] K1/K2 vs plain, {name}, {scene.n_walls} walls, "
                  f"{BIG_RAYS} rays at bounce {at} ({int(alive.sum())} "
                  f"alive; plain over slices of {step} rays): distances, "
                  "indices and occlusion minima equal, without and with "
                  f"alive / limit, brute / box walk: {equal['K1']} / "
                  f"{equal['K1b']}; the box walk's ray keys == "
                  f"morton_ray_keys; {hit:.3f} of the rays hit a wall, "
                  f"{blocked:.3f} of the {BIG_RAYS * n_l} shadow rays cross "
                  "one", flush=True)
            check(equal["K1"] and equal["K1b"],
                  f"10a {name} bounce {at}: K1/K2 == plain on both routes")
            check(hit > 0.5, f"10a {name} bounce {at}: most rays hit a wall")
            del got, so, sd, limit, a2
    del scene_40, p_40, scene_100, p_100
    print(f"[10a] wall tests compared per route: K1 {sweep_tests['K1']}, K2 "
          f"{sweep_tests['K2']}; max abs error brute K1 {errs['K1']}, K2 "
          f"{errs['K2']}; box walk K1 {errs['K1b']}, K2 {errs['K2b']}",
          flush=True)

    # 10a'. the user path past BOX_WALK_MIN_WALLS: hit records on the
    # 10,008-wall city with two listeners through engine.trace_hits (the
    # box walk of K1 and K2 at every bounce), held against the plain trace
    check(scene_9.n_walls >= tk.BOX_WALK_MIN_WALLS
          and sc.n_walls < tk.BOX_WALK_MIN_WALLS,
          "10a': the city takes the box walk, SmollRoom the brute sweep")
    e9, u9 = (x[0] for x in rng.philox_uniforms(24, 1, BOUNCES, RAYS, dev))
    city_hits, launched = counted(lambda: engine.trace_hits(
        scene_9, p_9two, e9, u9))
    check(launched == only(K1b=BOUNCES, K2b=BOUNCES),
          f"10a': engine.trace_hits on the city, launch counts {launched}")
    for k in ("K1b", "K2b"):
        launches[k] = launched[k]
    v = tt.trace_hits_only(scene_9, p_9two, e9, u9)
    check(int(v.valid.sum()) > 0 and torch.equal(city_hits.valid, v.valid)
          and torch.equal(city_hits.delay[v.valid], v.delay[v.valid])
          and torch.equal(city_hits.energy[v.valid], v.energy[v.valid]),
          "10a': the city's hit records == the plain trace's")
    print(f"[10a'] engine.trace_hits, city_scene(2500), 2 listeners, {RAYS} x "
          f"{BOUNCES}: launches {launched}; {int(v.valid.sum())} valid hits, "
          "== the plain trace's", flush=True)
    del city_hits, v

    # 10b. trace(use_kernels=True) against the plain trace
    def hits_equal(tag, got, want):
        v = want.valid
        n_valid = int(v.sum())
        ok = (torch.equal(got.valid, v)
              and torch.equal(got.delay[v], want.delay[v])
              and torch.equal(got.energy[v], want.energy[v]))
        print(f"{tag}: {n_valid} valid hits of {v.numel()}; valid equal, "
              f"delays and energies equal under it: {ok}", flush=True)
        check(n_valid > 0 and ok, tag)

    shapes = ((RAYS, BOUNCES), (BIG_RAYS, BIG_BOUNCES))
    for n_rays, n_b in shapes:
        emit, u = rng.philox_uniforms(21, 1, n_b, n_rays, dev)
        for p in (smoll_p, smoll_p2):
            got, dbg = tt.trace(sc, p, emit[0], u[0], n_debug=100,
                                use_kernels=True)
            want, dbg_p = tt.trace(sc, p, emit[0], u[0], n_debug=100)
            hits_equal(f"[10b] trace(use_kernels=True) vs plain trace, "
                       f"SmollRoom {n_rays} x {n_b}, "
                       f"{p.listeners.shape[0]} listener(s)", got, want)
            check(tuple(dbg.pos.shape) == (n_b + 1, 100, 2) and all(
                torch.equal(a, b) for a, b in zip(dbg, dbg_p)),
                "10b: the debug paths of 100 rays equal the plain ones")
    del got, want

    # 10c. K5: rows and hits against plain, rows binned against K3
    for n_rays, n_b in shapes:
        emit, u = rng.philox_uniforms(22, 1, n_b, n_rays, dev)
        e1, u1 = emit[0], u[0]
        rows, launched = counted(lambda: bk.trace_fused_rows(sc, smoll_p, e1,
                                                             u1))
        check(launched == only(K5=1), f"10c: K5 launch counts {launched}")
        rows_p = bk.trace_fused_rows_plain(sc, smoll_p, e1, u1)
        errs["K5"] = max(errs["K5"], float((rows - rows_p).abs().max()))
        check(torch.equal(rows, rows_p), "10c: K5 rows == plain rows")
        check(torch.equal(rows, bk.trace_fused_rows(sc, smoll_p, e1, u1)),
              "10c: K5 rerun bit-identical")
        hits_equal(f"[10c] K5 trace_fused vs plain hits, SmollRoom {n_rays} x"
                   f" {n_b}, launches {launched['K5']}",
                   bk.trace_fused(sc, smoll_p, e1, u1),
                   tt.trace_hits_only(sc, smoll_p, e1, u1))
        ir_rows = bk.scatter_hits_rows(rows, SR, T)
        check(torch.equal(ir_rows, bk.scatter_hits_rows(rows, SR, T)),
              "10c: scatter_hits_rows rerun bit-identical")
        same_numbers(f"[10c] scatter_hits_rows(K5 rows) vs K3's IR, {n_rays} "
                     f"x {n_b}, same uniforms", None, ir_rows,
                     bk.trace_frames_ir_whole(sc, smoll_p, emit, u, **kw))
    del rows, rows_p, ir_rows

    # 10d. K6 == K3 == K4 bit for bit, and against its plain version
    emit, u = rng.philox_uniforms(23, 1, BOUNCES, RAYS, dev)
    for p in (smoll_p, smoll_p2):
        n_l = p.listeners.shape[0]
        k6, launched = counted(lambda: bk.trace_frame_ir_fused(
            sc, p, emit[0], u[0], **kw))
        check(launched == only(K6=1),
              f"10d: K6 launch counts {launched} (K3/K4's instantiation, "
              "counted as K6's)")
        seeded = bk.trace_frame_ir_fused(sc, p, seed=23, n_rays=RAYS,
                                         max_bounces=BOUNCES, **kw)
        k3 = bk.trace_frames_ir_whole(sc, p, emit, u, **kw)
        k4 = bk.trace_frames_ir_mega(sc, p, 23, 1, **one)
        torch.cuda.synchronize()
        bits = {"K6 == K3": torch.equal(k6, k3),
                "K6(seed) == K4": torch.equal(seeded, k4)}
        print(f"[10d] K6, SmollRoom {RAYS} x {BOUNCES} x 1 frame, {n_l} "
              f"listener(s), IR energy {float(k6.sum()):.5f}, launches "
              f"{launched['K6']}: bit for bit {bits}", flush=True)
        check(float(k6.sum()) > 0 and all(bits.values()), "10d: K6 bits")
        for ear in range(n_l):
            same_numbers(f"[10d] K6 vs plain, listener {ear} of {n_l}, "
                         f"{RAYS} x {BOUNCES}, same uniforms", "K6", k6[ear],
                         bk.trace_frame_ir_fused_plain(sc, p, emit[0], u[0],
                                                       **kw)[ear])
    emit8, u8 = rng.philox_uniforms(24, 1, BIG_BOUNCES, BIG_RAYS, dev)
    k6_big = bk.trace_frame_ir_fused(sc, smoll_p, emit8[0], u8[0], **kw)
    check(torch.equal(k6_big, bk.trace_frames_ir_whole(sc, smoll_p, emit8, u8,
                                                       **kw)),
          f"10d: K6 == K3 at {BIG_RAYS} x {BIG_BOUNCES}")
    same_numbers(f"[10d] K6 (== K3 bit for bit) vs plain, {BIG_RAYS} x "
                 f"{BIG_BOUNCES}, same uniforms", "K6", k6_big,
                 bk.trace_frame_ir_fused_plain(sc, smoll_p, emit8[0], u8[0],
                                               **kw))
    del k6_big, emit8, u8

    # 10e. the path: cli trace and cli bake at their defaults
    def run_cli(argv):
        """One CLI command: what it printed, its launches, its seconds."""
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            _, launched = counted(lambda: cli.main(argv))
        secs = time.perf_counter() - t0
        for line in said.getvalue().splitlines():
            print(f"      | {line}", flush=True)
        return said.getvalue(), launched, secs

    def lit(path, shape):
        img = read_png(path)
        check(img.shape == shape, f"{path}: shape {img.shape}")
        share = float((img.reshape(-1, 3).max(-1) > 0).mean())
        check(share > 0.002, f"{path}: not blank ({share:.4f} lit)")
        return share

    def tails(path, click_times, n_channels=1):
        """The WAV at 48 kHz: finite, and more energy in the 0.3 s after
        each click than in the 50 ms before it."""
        x, rate = read_wav(path)
        x = x.reshape(len(x), -1)
        check(rate == SR and x.shape[1] == n_channels and np.isfinite(x).all()
              and np.abs(x).max() > 0, f"{path}: {x.shape} at {rate} Hz")
        ratios = []
        for tc in click_times:
            c = int(tc * SR)
            after = float((x[c:c + int(0.3 * SR), 0] ** 2).sum())
            before = float((x[c - int(0.05 * SR):c, 0] ** 2).sum())
            ratios.append(after / before if before > 0 else float("inf"))
            check(after > 2 * before, f"{path}: reverb tail after {tc} s")
        return ratios

    cli_launches = {k: 0 for k in wrappers}
    cli_secs = {}
    hit_clicks = (0.1, 0.6)
    with tempfile.TemporaryDirectory() as tmp:
        def f(name):
            return os.path.join(tmp, name)

        # cli trace --room smoll at its defaults, every output
        said, launched, cli_secs["trace smoll"] = run_cli(
            ["trace", "--room", "smoll", "--out", f("ir.png"), "--scene-out",
             f("scene.png"), "--spectro-out", f("spectro.png"), "--ir-out",
             f("ir.npz")])
        check(launched == only(K4=1, K5=1, K1=BOUNCES, K2=BOUNCES),
              f"10e: cli trace launch counts {launched}")
        for k in cli_launches:
            cli_launches[k] += launched[k]
        shares = [lit(f("ir.png"), (256, 1024, 3)),
                  lit(f("scene.png"), (600, 800, 3)),
                  lit(f("spectro.png"), (256, 1024, 3))]
        state8 = load_ir_state(f("ir.npz"), device=dev)
        direct = smoll_eng.trace_frames(smoll_p, seed=0, n_frames=8)
        check(state8.frames == 8 and torch.equal(state8.sum, direct.sum),
              "10e: the checkpoint holds the engine's 8-frame IR of seed 0")
        ir8 = direct.normalized()[0, :, 0].cpu().numpy()
        peak = int(re.search(r"peak bin (\d+)", said).group(1))
        plain8 = bk.trace_frames_ir_mega_plain(sc, smoll_p, 0, 8, **one)
        first_k, first_p = (int(np.flatnonzero(x)[0]) for x in (
            ir8, plain8[0, :, 0].cpu().numpy()))
        check(peak == int(ir8.argmax()) and first_k == first_p <= peak,
              f"10e: printed peak bin {peak}, IR peak {int(ir8.argmax())}, "
              f"first arrival {first_k} (plain {first_p})")
        print(f"[10e] cli trace --room smoll ({RAYS} x {BOUNCES} x 8 frames, "
              f"100 debug rays) in {cli_secs['trace smoll']:.3f} s with its "
              f"four outputs; launches {launched}; lit share of ir/scene/"
              f"spectro PNG {[f'{x:.4f}' for x in shares]}; checkpoint == "
              f"engine IR; peak bin {peak}, first arrival bin {first_k} "
              "(plain: the same)", flush=True)
        # resumed: 16 frames, against a fresh 16-frame run
        said, launched, cli_secs["trace resume"] = run_cli(
            ["trace", "--room", "smoll", "--ir-in", f("ir.npz"), "--ir-out",
             f("ir16.npz")])
        check(launched == only(K4=1) and "at frame 8" in said,
              f"10e: resumed trace launch counts {launched}")
        cli_launches["K4"] += launched["K4"]
        state16 = load_ir_state(f("ir16.npz"), device=dev)
        fresh16 = smoll_eng.trace_frames(smoll_p, seed=0, n_frames=16)
        e_rel = abs(float(state16.sum.sum()) - float(fresh16.sum.sum())) \
            / float(fresh16.sum.sum())
        print(f"[10e] resumed with --ir-in: {state16.frames} frames; energy "
              f"against a fresh 16-frame run {e_rel:.2e} (< 2e-2; the "
              "resumed frames draw under mix_seed(seed, 8))", flush=True)
        check(state16.frames == 16 and e_rel < 0.02
              and not torch.equal(state16.sum, fresh16.sum),
              "10e: resume continues the count with new draws")
        # Big Room, and a stereo spectrogram (two listeners: K1/K2 hits)
        said, launched, cli_secs["trace big"] = run_cli(
            ["trace", "--room", "big", "--out", f("big.png"), "--scene-out",
             f("big_scene.png")])
        check(launched == only(K4=1, K1=BOUNCES, K2=BOUNCES),
              f"10e: cli trace --room big launch counts {launched}")
        for k in cli_launches:
            cli_launches[k] += launched[k]
        energy = float(re.search(r"IR energy ([0-9.eE+-]+),", said).group(1))
        check(energy > 0, "10e: Big Room IR energy")
        lit(f("big.png"), (256, 1024, 3))
        lit(f("big_scene.png"), (600, 800, 3))
        said, launched, cli_secs["trace stereo"] = run_cli(
            ["trace", "--stereo", "0.4", "--spectro-out", f("stereo.png")])
        check(launched == only(K4=1, K1=BOUNCES, K2=BOUNCES),
              f"10e: cli trace --stereo launch counts {launched}")
        for k in cli_launches:
            cli_launches[k] += launched[k]
        lit(f("stereo.png"), (256, 1024, 3))
        # bake and bake --legacy on a click clip (44.1 kHz: resampled)
        write_wav(f("dry.wav"), click_clip(1.0, 44100, click_times=hit_clicks),
                  44100)
        said, launched, cli_secs["bake"] = run_cli(
            ["bake", "--room", "smoll", "--in", f("dry.wav"), "--out",
             f("wet.wav")])
        check(launched == only(K4=1) and "baked 48000 samples" in said,
              f"10e: cli bake launch counts {launched}")
        cli_launches["K4"] += launched["K4"]
        ratios = tails(f("wet.wav"), hit_clicks)
        said, launched, cli_secs["bake --legacy"] = run_cli(
            ["bake", "--room", "smoll", "--in", f("dry.wav"), "--out",
             f("legacy.wav"), "--legacy"])
        check(launched == only(K5=8)
              and "baked 48000 samples" in said,
              f"10e: cli bake --legacy launch counts {launched}")
        cli_launches["K5"] += launched["K5"]
        ratios_l = tails(f("legacy.wav"), hit_clicks)
        run_cli(["bake", "--room", "smoll", "--in", f("dry.wav"), "--out",
                 f("legacy2.wav"), "--legacy"])
        with open(f("legacy.wav"), "rb") as a, open(f("legacy2.wav"),
                                                    "rb") as b:
            check(a.read() == b.read(),
                  "10e: cli bake --legacy rerun writes the same bytes")
        print(f"[10e] cli bake: tail/pre-click energy "
              f"{[f'{r:.3g}' for r in ratios]}; --legacy (8 frames of hit "
              f"records through K5, launches {launched}): "
              f"{[f'{r:.3g}' for r in ratios_l]}, rerun byte-identical; "
              "seconds per command "
              f"{({k: round(v, 3) for k, v in cli_secs.items()})}", flush=True)
    # the fused accumulate entry point: K6 per frame, and the
    # exact_scatter route (a K5 pass per listener, binned in float)
    emit, u = rng.philox_uniforms(25, 2, BOUNCES, RAYS, dev)
    k3_two = bk.trace_frames_ir_whole(sc, smoll_p2, emit, u, **kw)
    for exact, key in ((False, "K6"), (True, "K5")):
        got, launched = counted(lambda: bk.trace_accumulate_fused(
            sc, smoll_p2, art.IRState.zeros(T, 2, device=dev), emit, u,
            sample_rate=SR, exact_scatter=exact))
        n_launch = 2 * (2 if exact else 1)   # a frame: K6 once, K5 per ear
        check(launched == only(**{key: n_launch}) and got.frames == 2,
              f"10e: trace_accumulate_fused(exact_scatter={exact}) launch "
              f"counts {launched}")
        cli_launches[key] += launched[key]
        for ear in range(2):
            same_numbers(f"[10e] trace_accumulate_fused(exact_scatter={exact}"
                         f"), 2 frames, ear {ear}, launches {launched[key]} "
                         f"{key}, vs K3's 2-frame IR", None, got.sum[ear],
                         k3_two[ear])
    # every float scatter of the path gives the same bits on a rerun
    hits = smoll_eng.trace_hits(smoll_p2, 0)
    spectro = legacy.scatter_hits_legacy(hits, SR, T // 128)
    reruns = {
        "scatter_hits": torch.equal(irm.scatter_hits(hits, SR, T),
                                    irm.scatter_hits(hits, SR, T)),
        "scatter_hits_legacy": torch.equal(
            spectro, legacy.scatter_hits_legacy(hits, SR, T // 128)),
        "legacy_ir_to_time_domain": torch.equal(
            legacy.legacy_ir_to_time_domain(spectro, SR, T),
            legacy.legacy_ir_to_time_domain(spectro, SR, T))}
    print(f"[10e] legacy IR {tuple(spectro.shape)}; float scatters rerun "
          f"bit-identical: {reruns}", flush=True)
    check(tuple(spectro.shape) == (2, 562, 128) and all(reruns.values())
          and not torch.are_deterministic_algorithms_enabled(),
          "10e: the float scatters are deterministic, the global mode "
          "untouched")
    del hits, spectro
    for k in ("K1", "K2", "K5", "K6"):
        launches[k] = cli_launches[k]
    check(all(launches[k] > 0 for k in ("K1", "K2", "K5", "K6")),
          f"10e: the path launched K1, K2, K5 and K6: {launches}")

    # --- 11. directive sources and microphones, diffraction and air --------
    from realisticaudioraytracing2d_tpu_torch.ops import air
    from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv

    def pad5(c):
        return np.pad(c, (0, 5 - len(c)))

    # the issue's patterns: a cardioid source (padded to C = 5) and a
    # figure-eight microphone (C = 5)
    src_pat = torch.as_tensor(pad5(dv.cardioid(0.7)), device=dev)
    mic_pat = torch.as_tensor(dv.figure_eight(0.3), device=dev)
    one_pat = torch.ones(1, device=dev)

    def directive(pp):
        return pp._replace(directivity=src_pat, mic_directivity=mic_pat)

    def omni_coded(pp):
        return pp._replace(directivity=one_pat, mic_directivity=one_pat)

    omni_bits = {}
    sd = directive(smoll_p)
    emit, u = rng.philox_uniforms(31, 4, BOUNCES, RAYS, dev)
    same_numbers(f"[11a] K3 directive vs plain, SmollRoom {RAYS} x {BOUNCES}"
                 " x 4 frames, same Philox numbers", "K3",
                 bk.trace_frames_ir_whole(sc, sd, emit, u, **kw),
                 bk.trace_frames_ir_plain(sc, sd, emit, u, **kw))
    omni_bits["K3"] = torch.equal(
        bk.trace_frames_ir_whole(sc, omni_coded(smoll_p), emit, u, **kw),
        bk.trace_frames_ir_whole(sc, smoll_p, emit, u, **kw))
    same_numbers(f"[11a] K4 directive vs plain at the stream's shape, {RAYS}"
                 f" x {BOUNCES} x 1 frame", "K4",
                 bk.trace_frames_ir_mega(sc, sd, chunk0, 1, **one),
                 bk.trace_frames_ir_mega_plain(sc, sd, chunk0, 1, **one))
    same_numbers(f"[11a] K4 directive vs plain, {BIG_RAYS} x {BIG_BOUNCES} x "
                 f"{nf} frames", "K4",
                 bk.trace_frames_ir_mega(sc, sd, 2024, nf, **big, **kw),
                 bk.trace_frames_ir_mega_plain(sc, sd, 2024, nf, **big,
                                               **kw))
    omni_bits["K4"] = torch.equal(
        bk.trace_frames_ir_mega(sc, omni_coded(smoll_p), chunk0, 1, **one),
        bk.trace_frames_ir_mega(sc, smoll_p, chunk0, 1, **one))
    rows, launched = counted(lambda: bk.trace_fused_rows(sc, sd, emit[0],
                                                         u[0]))
    check(launched == only(K5=1), f"11a: K5 directive launches {launched}")
    rows_p = bk.trace_fused_rows_plain(sc, sd, emit[0], u[0])
    errs["K5"] = max(errs["K5"], float((rows - rows_p).abs().max()))
    check(torch.equal(rows, rows_p), "11a: K5 directive rows == plain rows")
    omni_bits["K5"] = torch.equal(
        bk.trace_fused_rows(sc, omni_coded(smoll_p), emit[0], u[0]),
        bk.trace_fused_rows(sc, smoll_p, emit[0], u[0]))
    k6, launched = counted(lambda: bk.trace_frame_ir_fused(
        sc, sd, emit[0], u[0], **kw))
    check(launched == only(K6=1), f"11a: K6 directive launches {launched}")
    check(torch.equal(k6, bk.trace_frames_ir_whole(sc, sd, emit[:1], u[:1],
                                                   **kw)),
          "11a: K6 == K3 bit for bit, directive")
    same_numbers(f"[11a] K6 directive (== K3 bit for bit) vs plain, {RAYS} x "
                 f"{BOUNCES}", "K6", k6,
                 bk.trace_frame_ir_fused_plain(sc, sd, emit[0], u[0], **kw))
    omni_bits["K6"] = torch.equal(
        bk.trace_frame_ir_fused(sc, omni_coded(smoll_p), emit[0], u[0], **kw),
        bk.trace_frame_ir_fused(sc, smoll_p, emit[0], u[0], **kw))
    del rows, rows_p, k6
    # K9: the 64-source mixdown, each source aimed its own way (11d)
    aims = torch.as_tensor(np.stack([
        pad5(dv.cardioid(2 * np.pi * s_ / N_SOURCES))
        for s_ in range(N_SOURCES)]), device=dev)
    mix_d = mix_p._replace(directivity=aims, mic_directivity=mic_pat)
    mix_dir, mixed_d = counted(lambda: trace_sources_mixdown(
        smoll.scene, mix_d, 7, **sweep_kw))
    check(mixed_d == only(K9=1), f"11a: directive mixdown launches {mixed_d}")
    mix_dir_plain = trace_sources_mixdown(smoll.scene, mix_d, 7,
                                          backend="plain", **sweep_kw)
    for ear in range(2):
        same_numbers(f"[11a] K9 directive mixdown, {N_SOURCES} aims, vs the "
                     f"plain sum over sources, ear {ear}", "K9", mix_dir[ear],
                     mix_dir_plain[ear])
    shared1 = Scene(*(x[None] for x in smoll.scene))
    srcs64 = mix_p.source
    singles = []
    for s_ in range(N_SOURCES):
        singles.append(bk.trace_rooms_ir_mega(
            shared1, srcs64[s_:s_ + 1], mix_p.listeners[None], 7, 1,
            entry_offset=s_, directivity=aims[s_:s_ + 1],
            mic_directivity=mic_pat, **sweep_kw)[0])
    k4_0 = bk.trace_frames_ir_mega(smoll.scene, mix_p._replace(
        source=srcs64[0], directivity=aims[0], mic_directivity=mic_pat), 7, 1,
        **sweep_kw)
    torch.cuda.synchronize()
    check(torch.equal(singles[0], k4_0),
          "11d: source 0's single launch == K4 bit for bit")
    for ear in range(2):
        same_numbers(f"[11d] directive mixdown vs the sum of {N_SOURCES} "
                     f"single-source launches, ear {ear}", None, mix_dir[ear],
                     sum(x[ear] for x in singles))
    omni_bits["K9"] = torch.equal(
        trace_sources_mixdown(smoll.scene, mix_p._replace(
            directivity=one_pat, mic_directivity=one_pat), 7, **sweep_kw),
        trace_sources_mixdown(smoll.scene, mix_p, 7, **sweep_kw))
    del singles, k4_0, mix_dir_plain
    # K7 and K8: K4 == K7 == K8 on a sorted city, directive; K8 at the city
    # stream's shape and K7 (8 bands) at full shape against plain
    scene_a, p_a, _ = city(1200)
    pa_d = directive(p_a)
    k4a = bk.trace_frames_ir_mega(ak.prepare(scene_a).scene, pa_d, 31,
                                  CITY_FRAMES, **city_run)
    dir_parity = {k: torch.equal(fn(scene_a, pa_d, 31, CITY_FRAMES,
                                    **city_run), k4a)
                  for k, fn in (("K7", ak.trace_frames_ir_accel),
                                ("K8", ak.trace_frames_ir_accel_sorted))}
    print(f"[11a] city_scene(1200) sorted, {BIG_RAYS} x {CITY_BOUNCES} x "
          f"{CITY_FRAMES} frames, directive: equal to K4 bit for bit "
          f"{dir_parity}; IR energy {float(k4a.sum()):.4e}", flush=True)
    check(float(k4a.sum()) > 0 and all(dir_parity.values()),
          "11a: K4 == K7 == K8, directive")
    del k4a
    same_numbers(f"[11a] K8 directive vs plain at the city stream's shape, "
                 f"{RAYS} x {BOUNCES} x 1 frame, {scene_9.n_walls} walls",
                 "K8", ak.trace_frames_ir_accel_sorted(
                     scene_9, directive(p_9), chunk0, 1, **one),
                 ak.trace_frames_ir_accel_sorted_plain(
                     scene_9, directive(p_9), chunk0, 1, **one))
    omni_bits["K8"] = torch.equal(
        ak.trace_frames_ir_accel_sorted(scene_9, omni_coded(p_9), chunk0, 1,
                                        **one),
        ak.trace_frames_ir_accel_sorted(scene_9, p_9, chunk0, 1, **one))
    scene_a8, p_a8, _ = city(1200, n_bands=8)
    k7d = ak.trace_frames_ir_accel(scene_a8, directive(p_a8), 47, CITY_FRAMES,
                                   **city_run)
    against_plain("[11a] 8-band city_scene(1200), directive,", "K7",
                  ak.trace_frames_ir_accel_plain, scene_a8, directive(p_a8),
                  47, k7d)
    omni_bits["K7"] = torch.equal(
        ak.trace_frames_ir_accel(scene_a8, omni_coded(p_a8), 47, CITY_FRAMES,
                                 **city_run),
        ak.trace_frames_ir_accel(scene_a8, p_a8, 47, CITY_FRAMES,
                                 **city_run))
    del k7d
    print(f"[11b] omni-coded patterns ([1.]) through each directive kernel "
          f"== the omni kernel, bit for bit: {omni_bits}", flush=True)
    check(all(omni_bits.values()) and len(omni_bits) == 7,
          "11b: omni-coded patterns give the omni bits")

    # 11c. registers and local bytes: the omni instantiations keep the
    # parent's
    lib = build.load_library()
    attr_calls = {"K3": ("art_frames_attributes", (1, 1)),
                  "K4": ("art_frames_attributes", (0, 1)),
                  "K9": ("art_frames_attributes", (0, 1)),
                  "K8": ("art_accel_attributes", (1, 1))}
    regs = {}
    for k, (fn_name, args) in attr_calls.items():
        fn = getattr(lib, fn_name)
        for d in (0, 1):
            out = (ctypes.c_int * 2)()
            check(fn(*args, d, out) == 0, f"11c: {fn_name}{args + (d,)}")
            regs[k, d] = (out[0], out[1])
    print("[11c] registers / local bytes per thread (cudaFuncGetAttributes), "
          "omni (the parent's) -> directive: " + "; ".join(
              f"{k} {regs[k, 0][0]} / {regs[k, 0][1]} B ({PARENT_REGS[k][0]}"
              f" / {PARENT_REGS[k][1]} B) -> {regs[k, 1][0]} / "
              f"{regs[k, 1][1]} B" for k in attr_calls),
          flush=True)
    check(all(regs[k, 0] == PARENT_REGS[k] for k in attr_calls),
          "11c: the omni kernels keep the parent's registers and local "
          "bytes")
    table = ptxas_table(build.build_log())
    moved = {k: table.get(k) for k, v in PARENT_PTXAS.items()
             if table.get(k) != v}
    print(f"[11c] ptxas registers / spill stores / spill loads of the "
          f"{len(PARENT_PTXAS)} instantiations of PARENT_PTXAS (the "
          "one-band K3/K4/K9/K8 the parent built, K1/K2's of their "
          f"redesign): equal: {not moved}; "
          + "; ".join(f"{k} {table.get(k)}" for k in PARENT_PTXAS),
          flush=True)
    check(not moved, f"11c: ptxas lines moved from the parent's: {moved}")
    # K3/K4/K6's argument kernel is new code: its lines beside K4's
    out = (ctypes.c_int * 2)()
    check(lib.art_k4_args_attributes(out) == 0, "11c: k4_args attributes")
    print(f"[11c] k4_args_kernel (K3/K4/K6's arguments; K6 launches K3's "
          f"or K4's instantiation, so its registers are theirs): registers "
          f"/ local bytes {out[0]} / {out[1]} B, ptxas "
          f"{table.get('k4_args_kernel')}; K4's frames_ir_kernel<0,0,1,1> "
          f"{table.get('frames_ir_kernel<0,0,1,1>')}", flush=True)
    # K5's kernel is new code: its lines beside K3's G = 1 omni one
    rows_lines = {k: v for k, v in table.items()
                  if k.startswith("frame_rows_kernel")}
    print("[11c] ptxas registers / spill stores / spill loads of K5's "
          "frame_rows_kernel<directive, lanes>: " + "; ".join(
              f"{k} {v}" for k, v in rows_lines.items())
          + f"; K3's frames_ir_kernel<1,0,1,1> "
          f"{table.get('frames_ir_kernel<1,0,1,1>')}", flush=True)
    check(len(rows_lines) == 4, f"11c: four K5 instantiations {rows_lines}")

    # 11e. the stream: SmollRoom with an opaque barrier below the source
    # (the slant wall's ends lie outside the room, so it casts no shadow
    # an edge could fill), an XY cardioid pair at +-45 degrees and a third
    # listener in the barrier's shadow; a cardioid source, diffraction
    # order 1 and ISO 9613-1 air at 20 C / 50 %
    room_e = art.rooms.smoll_room(device=dev)
    room_e.builder.add_segment((-18.0, 6.0), (-15.0, 6.0), (0.0, 1.0),
                               art.AudioMaterial(0.9, 0.5, 0.0, 1.0))
    scene_e = room_e.builder.build(device=dev)
    lis_e = [[-0.1, -3.68], [0.1, -3.68], [-16.0, 3.0]]
    mic_e = torch.as_tensor(np.stack([
        pad5(dv.cardioid(np.pi / 4)), pad5(dv.cardioid(-np.pi / 4)),
        pad5(dv.omni())]), device=dev)
    p_e = art.Engine(scene_e, cfg).params(
        room_e.source, lis_e, directivity=pad5(dv.cardioid(-0.9)),
        mic_directivity=mic_e)
    alpha = air.iso9613_alpha(air.band_frequencies(1))

    def stream_e(**a):
        return counted(lambda: art.Streamer(
            scene_e, cfg, seed=7, n_listeners=3, air_alpha=alpha,
            **a).stream_clip(dry, lambda i: p_e))

    wet_e, launched_e = stream_e(diffraction=1)
    check(launched_e == only(K4=n_chunks, K2=n_chunks, D3seg=n_chunks,
                             D3bin=n_chunks),   # one of each a chunk
          f"11e: stream launches {launched_e}")
    wet_plain, launched_p = stream_e(diffraction=1, backend="plain")
    check(launched_p == only(), f"11e: the plain twin launched {launched_p}")
    wet_nod, _ = stream_e(diffraction=0)
    out_e, out_p, out_n = (x.cpu().numpy() for x in (wet_e, wet_plain,
                                                      wet_nod))
    check(out_e.shape == (3, n_chunks * CHUNK) and np.isfinite(out_e).all(),
          f"11e: stream {out_e.shape}, finite")
    gap = float(np.abs(out_e - out_p).max())
    e_shadow = [float((x[2] ** 2).sum()) for x in (out_n, out_e)]
    xy = float(np.abs(out_e[0] - out_e[1]).sum() / np.abs(out_e[0]).sum())
    print(f"[11e] stream: SmollRoom + barrier, cardioid source, XY cardioid "
          f"pair +-45 deg and a listener in the barrier's shadow, "
          f"diffraction 1, air {alpha[0] * 1000:.2f} dB/km: {n_chunks} chunks "
          f"-> {out_e.shape}, launches {launched_e}; vs its plain twin "
          f"(backend='plain', the same Philox numbers): max abs "
          f"{gap:.3e} of peak {np.abs(out_p).max():.3e}; shadow listener "
          f"energy without / with diffraction {e_shadow[0]:.6e} / "
          f"{e_shadow[1]:.6e} (+{e_shadow[1] / e_shadow[0] - 1:.3e}: the "
          "barrier's tips add to what the walls reflect around it); XY "
          f"channels differ by L1 {xy:.3f}", flush=True)
    check(np.allclose(out_e, out_p, rtol=1e-4,
                      atol=1e-6 * np.abs(out_p).max()),
          "11e: stream == its plain twin")
    check(e_shadow[1] > e_shadow[0] and xy > 0,
          "11e: diffraction adds energy in the shadow; the XY pair differs")
    for k in ("K2", "K4", "D3seg", "D3bin"):
        launches[k] = launches.get(k, 0) + launched_e[k]
    del wet_e, wet_plain, wet_nod, out_e, out_p, out_n

    # 11f. diffraction through its kernels and K2 equals its plain version
    for order in (1, 2):
        d_ir, launched_f = counted(lambda: dfr.diffraction_ir(
            scene_e, p_e, order=order, **kw))
        d_plain = dfr.diffraction_ir(scene_e, p_e, order=order,
                                     use_kernels=False, **kw)
        torch.cuda.synchronize()
        print(f"[11f] diffraction_ir order {order}, {scene_e.n_walls} walls, "
              f"3 listeners: launches {launched_f}; energy per listener "
              f"{[float(x) for x in d_ir.sum(dim=(1, 2))]}; == plain bit for "
              f"bit: {torch.equal(d_ir, d_plain)}", flush=True)
        check(launched_f == only(K2=order, D3seg=1, D3bin=1)
              and float(d_ir[2].sum()) > 0 and torch.equal(d_ir, d_plain),
              f"11f: diffraction order {order} through its kernels == "
              f"plain")
    del d_ir, d_plain

    # 11g. cli trace / cli bake with the new flags
    new_flags = ["--directivity", "cardioid:90", "--stereo", "0.2",
                 "--stereo-aim", "45", "--diffraction", "--air"]
    with tempfile.TemporaryDirectory() as tmp:
        def g(name):
            return os.path.join(tmp, name)

        said, launched_g, secs_t = run_cli(
            ["trace", "--room", "smoll", "--out", g("ir.png"), "--scene-out",
             g("scene.png"), *new_flags])
        # K2: the debug paths' sweeps, the diffraction's and the scene
        # picture's diffraction paths (the chain through K2)
        check(launched_g == only(K4=1, K1=BOUNCES, K2=BOUNCES + 2, D3seg=1,
                                 D3bin=1)
              and "air absorption:" in said and "diffraction: added" in said,
              f"11g: cli trace launch counts {launched_g}")
        lit(g("ir.png"), (256, 1024, 3))
        lit(g("scene.png"), (600, 800, 3))
        for k in ("K1", "K2", "K4", "D3seg", "D3bin"):
            launches[k] = launches.get(k, 0) + launched_g[k]
        write_wav(g("dry.wav"), click_clip(1.0, 44100,
                                           click_times=hit_clicks), 44100)
        said, launched_b, secs_b = run_cli(
            ["bake", "--room", "smoll", "--in", g("dry.wav"), "--out",
             g("wet.wav"), *new_flags])
        check(launched_b == only(K4=1, K2=1, D3seg=1, D3bin=1),
              f"11g: cli bake launch counts {launched_b}")
        ratios_b = tails(g("wet.wav"), hit_clicks, n_channels=2)
        said, launched_l, secs_l = run_cli(
            ["bake", "--room", "smoll", "--in", g("dry.wav"), "--out",
             g("legacy.wav"), "--legacy", "--directivity", "cardioid:90",
             "--mic-directivity", "figure8:45"])
        check(launched_l == only(K5=8),
              f"11g: cli bake --legacy launch counts {launched_l}")
        ratios_l = tails(g("legacy.wav"), hit_clicks)
        for lb in (launched_b, launched_l):
            for k in ("K2", "K4", "K5", "D3seg", "D3bin"):
                launches[k] = launches.get(k, 0) + lb[k]
    print(f"[11g] cli trace {' '.join(new_flags)}: {secs_t:.3f} s, launches "
          f"{launched_g}; cli bake with them: {secs_b:.3f} s, launches "
          f"{launched_b}, tail/pre-click energy "
          f"{[f'{r:.3g}' for r in ratios_b]}; cli bake --legacy with a "
          f"cardioid source and a figure-eight mic: {secs_l:.3f} s, "
          f"launches {launched_l}, {[f'{r:.3g}' for r in ratios_l]}",
          flush=True)

    # --- 12. bands, many listeners, batches past 5,280 walls ---------------
    ctx = dict(torch=torch, art=art, bk=bk, ak=ak, rng=rng, cli=cli, dev=dev,
               counted=counted, only=only, same_numbers=same_numbers,
               Scene=Scene, build=build, card=card, work=work)
    band_launches, band_readings = bands_phase(ctx)
    launches_d, band_readings["64"] = listeners_batches_phase(ctx)
    for k, n in launches_d.items():
        band_launches[k] += n
    # 12e. the 40,008-wall city at 32 bands through K7, at full shape
    scene_32, p_32, secs = city(10000, n_bands=32)
    ir_32 = large_scene("[12e]", "K7", scene_32, p_32, 49, secs, n_bands=32,
                        plain=ak.trace_frames_ir_accel_plain)
    check(ir_32[..., -1].sum() < ir_32[..., 0].sum(),
          "12e: highest band quieter than the lowest")
    del ir_32
    scene_d1 = scene_d._replace(absorption=scene_d.absorption[:, :1])
    ctx["city_bands"] = {1: (scene_d1, p_d), 8: (scene_d, p_d),
                         32: (scene_32, p_32)}

    # --- 13. spatial captures and the binaural stream ----------------------
    ctx.update(scene_9=scene_9, p_9=p_9)
    spatial_launches, _ = spatial_phase(ctx)
    decode_phase(ctx)
    taps_phase(ctx)
    diffraction_phase(ctx)

    # --- 14. per-arrival and shared-rate Doppler streams -------------------
    doppler_launches, _ = doppler_phase(ctx)

    # --- 15. the live pipeline, the pose feed, the native runtime ----------
    live_launches, _ = live_phase(ctx)

    # --- 16. differentiable acoustics --------------------------------------
    diff_launches, _ = diff_phase(ctx)

    # --- 17. the device-mesh paths -----------------------------------------
    mesh_launches, _ = mesh_phase(ctx)

    # --- 5. timings (run last) -------------------------------------------
    emit, u = rng.bounce_uniforms(gen, 1, BOUNCES, RAYS, dev)
    sc, p = smoll.scene, smoll_p
    times = {
        "K3": (cuda_ms(torch, lambda: bk.trace_frames_ir_whole(
            sc, p, emit, u, **kw), 20),
            cuda_ms(torch, lambda: bk.trace_frames_ir_plain(
                sc, p, emit, u, **kw), 5)),
        "K4": (cuda_ms(torch, lambda: bk.trace_frames_ir_mega(
            sc, p, 5, 1, **one), 20),
            cuda_ms(torch, lambda: bk.trace_frames_ir_mega_plain(
                sc, p, 5, 1, **one), 5)),
    }
    emit8, u8 = rng.bounce_uniforms(gen, 1, BIG_BOUNCES, BIG_RAYS, dev)
    big_k = cuda_ms(torch, lambda: bk.trace_frames_ir_mega(
        sc, p, 6, nf, **big, **kw), 5) / nf
    big_k3 = cuda_ms(torch, lambda: bk.trace_frames_ir_whole(
        sc, p, emit8, u8, **kw), 5)
    big_plain = cuda_ms(torch, lambda: bk.trace_frames_ir_plain(
        sc, p, emit8, u8, **kw), 3)
    # every reading holds one launch a call (a reading that missed one is
    # retried), K7/K8's one a bounce
    dev_ms = {
        "K3": kernel_device_ms(torch, lambda: bk.trace_frames_ir_whole(
            sc, p, emit, u, **kw), 10, "frames_ir_kernel", 1),
        "K4": kernel_device_ms(torch, lambda: bk.trace_frames_ir_mega(
            sc, p, 5, 1, **one), 10, "frames_ir_kernel", 1),
        "K4 big": kernel_device_ms(torch, lambda: bk.trace_frames_ir_mega(
            sc, p, 6, nf, **big, **kw), 3, "frames_ir_kernel", 1)}
    streamer = art.Streamer(sc, cfg, seed=11)
    streamer.stream_clip(dry, lambda i: p, total_chunks=5)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamer.stream_clip(dry, lambda i: p)
    torch.cuda.synchronize()
    ms_chunk = (time.perf_counter() - t0) * 1e3 / n_chunks
    print(f"[5] timings on {card}: ms per frame at {RAYS} x {BOUNCES} "
          f"(72,000 bins): "
          f"K3 {times['K3'][0]:.3f} vs plain {times['K3'][1]:.3f}, K4 "
          f"{times['K4'][0]:.3f} vs plain+Philox {times['K4'][1]:.3f}; at "
          f"{BIG_RAYS} x {BIG_BOUNCES}: K4 {big_k:.3f} ({nf} frames/launch), "
          f"K3 {big_k3:.3f} vs "
          f"plain {big_plain:.3f}; stream {ms_chunk:.3f} ms per 100 ms "
          f"chunk = {100.0 / ms_chunk:.1f}x realtime", flush=True)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"
    # the bench frame's bounds: K4 over 8 frames, K3 over one
    w_big = {"K4": work(lambda n: bk.trace_frames_ir_mega(
        sc, p, 6, nf, work_counts=n, **big, **kw)),
        "K3": work(lambda n: bk.trace_frames_ir_whole(
            sc, p, emit8, u8, work_counts=n, **kw))}
    big_bytes = 4 * (11 * smoll.scene.n_walls + 2 + 5 + T)
    b_big = {"K4": bound(w_big["K4"], big_bytes),
             "K3": bound(w_big["K3"], big_bytes + 4 * BIG_RAYS
                         * (1 + 3 * BIG_BOUNCES))}
    print(f"    kernel device time per launch (profiler): K3 {RAYS} x "
          f"{BOUNCES} {fmt(dev_ms['K3'])}, K4 {fmt(dev_ms['K4'])}, K4 "
          f"{BIG_RAYS} x {BIG_BOUNCES} x {nf} frames {fmt(dev_ms['K4 big'])}"
          "; the per-call times above include the wrapper's host work; "
          "bounds at the bench frame: " + "; ".join(
              f"{k} ({'8 frames' if k == 'K4' else '1 frame'}) {w[0]} wall "
              f"tests, {w[1]} sweeps -> {b_big[k][0]:.6f} ms "
              f"({b_big[k][1]})" for k, w in w_big.items()), flush=True)

    # the sweep and the mixdown: wrapper calls (CUDA events), K9's device
    # time (profiler), and the wall tests and sweeps the kernel made for
    # the bounds
    sweep_ms = cuda_ms(torch, lambda: sweep_rooms(
        scenes, src, lis, 0, n_frames=SWEEP_FRAMES, **sweep_kw), 3)
    torch.cuda.reset_peak_memory_stats()
    sweep_rooms(scenes, src, lis, 0, n_frames=SWEEP_FRAMES, **sweep_kw)
    torch.cuda.synchronize()
    sweep_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dev_ms["K9 sweep"] = kernel_device_ms(torch, lambda: bk.trace_rooms_ir_mega(
        scenes, src, lis, 0, SWEEP_FRAMES, **sweep_kw), 3, "frames_ir_kernel",
        1)
    sweep_work = work(lambda n: bk.trace_rooms_ir_mega(
        scenes, src, lis, 0, SWEEP_FRAMES, work_counts=n, **sweep_kw))
    check_work("sweep", sweep_work, PARENT_WORK["sweep"], exact=True)
    w_sweep = scenes.n_walls
    sweep_bound = bound(sweep_work, 4 * SWEEP_ROOMS * (
        11 * w_sweep + 2 + 5 + T))
    # K9 on the device tensors trace_sources_mixdown hands it
    shared = Scene(*(x[None] for x in smoll.scene))
    lis64 = mix_p.listeners.expand(N_SOURCES, -1, 2)
    mix_args = (shared, mix_p.source, lis64, 7, 1)
    mix_kw = dict(listener_radius=mix_p.listener_radius,
                  speed_of_sound=mix_p.speed_of_sound,
                  input_gain=mix_p.input_gain, **sweep_kw)
    times["K9"] = (
        cuda_ms(torch, lambda: bk.trace_rooms_ir_mega(*mix_args, **mix_kw),
                20),
        cuda_ms(torch, lambda: bk.trace_rooms_ir_mega_plain(
            *mix_args, **mix_kw), 2))
    mix_ms = (cuda_ms(torch, lambda: trace_sources_mixdown(
        smoll.scene, mix_p, 7, **sweep_kw), 20),
        cuda_ms(torch, lambda: trace_sources_mixdown(
            smoll.scene, mix_p, 7, backend="plain", **sweep_kw), 2))
    dev_ms["K9"] = kernel_device_ms(torch, lambda: bk.trace_rooms_ir_mega(
        *mix_args, **mix_kw), 10, "frames_ir_kernel", 1)
    n_work = {
        "K3": work(lambda n: bk.trace_frames_ir_whole(
            sc, p, *fixed, work_counts=n, **kw)),
        "K4": work(lambda n: bk.trace_frames_ir_mega(
            sc, p, chunk0, 1, work_counts=n, **one)),
        "K9": work(lambda n: bk.trace_rooms_ir_mega(
            *mix_args, work_counts=n, **mix_kw))}
    check_work("mixdown", n_work["K9"], PARENT_WORK["mixdown"], exact=True)
    # bytes: each input read once (wall table 11 x W, listeners, scalars,
    # K3's host uniforms), the f32 IR written once
    w = smoll.scene.n_walls
    one_bytes = 4 * (11 * w + 2 + 5 + T)
    bounds = {
        "K3": bound(n_work["K3"], one_bytes + 4 * RAYS * (1 + 3 * BOUNCES)),
        "K4": bound(n_work["K4"], one_bytes),
        "K9": bound(n_work["K9"], 4 * (11 * w + N_SOURCES * (2 * 2 + 5)
                                        + N_SOURCES * 2 * T))}
    nominal = {"K3": RAYS * w * BOUNCES * 2, "K4": RAYS * w * BOUNCES * 2,
               "K9": N_SOURCES * RAYS * w * BOUNCES * 3,
               "sweep": SWEEP_ROOMS * SWEEP_FRAMES * RAYS * w_sweep * BOUNCES
               * 2}
    print(f"[5] sweep on {card}: {SWEEP_ROOMS} rooms x {SWEEP_FRAMES} frames"
          f" x {RAYS} x {BOUNCES}, {T} bins: {sweep_ms:.3f} ms per sweep_rooms"
          f" call = {SWEEP_ROOMS / sweep_ms * 1e3:.1f} rooms/s (CUDA events);"
          f" K9 device time {fmt(dev_ms['K9 sweep'])} (profiler); peak "
          f"device memory {sweep_peak:.3f} GiB; wall tests made "
          f"{sweep_work[0]} of nominal R*W*B*(1+L) {nominal['sweep']} in "
          f"{sweep_work[1]} sweeps, the counts before the redesign; bound "
          f"{sweep_bound[0]:.4f} ms ({sweep_bound[1]}; {FMAD_NOTE})",
          flush=True)
    print(f"[5] mixdown on {card}: {N_SOURCES} sources x {RAYS} x {BOUNCES},"
          f" 2 ears: trace_sources_mixdown {mix_ms[0]:.3f} ms per call vs "
          f"plain {mix_ms[1]:.3f}; K9 wrapper {times['K9'][0]:.3f} vs plain "
          f"{times['K9'][1]:.3f}; K9 device time {fmt(dev_ms['K9'])}",
          flush=True)
    for k in ("K3", "K4", "K9"):
        print(f"    bound {k}: {n_work[k][0]} wall tests made (nominal "
              f"R*W*B*(1+L) {nominal[k]}) x {OPS_PER_TEST} + {n_work[k][1]} "
              f"sweeps x {OPS_PER_SWEEP} FP32 ops -> {bounds[k][0]:.6f} ms "
              f"({bounds[k][1]}; {FMAD_NOTE}); device time "
              f"{fmt(dev_ms[k])}", flush=True)

    # K8 at the city stream's shape (15k x 5 x 1 frame, 10,008 walls):
    # wrapper calls (CUDA events), device time (profiler), and the tests,
    # sweeps and slab tests made for the bound. K7 at the banded city's
    # (131,072 x 6 x 4 frames, 8 bands, 40,008 walls), measured in [8d].
    times["K8"] = (
        cuda_ms(torch, lambda: ak.trace_frames_ir_accel_sorted(
            scene_9, p_9, 5, 1, **one), 10),
        cuda_ms(torch, lambda: ak.trace_frames_ir_accel_sorted_plain(
            scene_9, p_9, 5, 1, **one), 2))
    dev_ms["K8"] = kernel_device_ms(
        torch, lambda: ak.trace_frames_ir_accel_sorted(scene_9, p_9, 5, 1,
                                                       **one),
        5, "accel_bounce_kernel", launches=BOUNCES)
    n_work["K8"] = work(lambda n: ak.trace_frames_ir_accel_sorted(
        scene_9, p_9, 5, 1, work_counts=n, **one))
    check_work("K8", n_work["K8"], PARENT_WORK["K8"], exact=False)
    prep = ak.prepare(scene_9)
    bounds["K8"] = bound(n_work["K8"], 4 * (
        prep.walls.numel() + prep.aabb.numel() + prep.saabb.numel() + 2 + 5
        + T))
    banded = large["[8d]"]
    times["K7"] = (banded["ms"], banded["plain_ms"])
    dev_ms["K7"], n_work["K7"] = banded["device_ms"], banded["work"]
    bounds["K7"] = banded["bound"]
    for k, shape in (("K8", f"{RAYS} x {BOUNCES} x 1 frame, "
                            f"{scene_9.n_walls} walls, K=1"),
                     ("K7", f"{BIG_RAYS} x {CITY_BOUNCES} x {CITY_FRAMES} "
                            f"frames, {banded['walls']} walls, K=8")):
        print(f"    {k} at {shape}: {times[k][0]:.3f} ms per call vs plain "
              f"{times[k][1]:.3f}; device {fmt(dev_ms[k])}; {n_work[k][0]} "
              f"wall tests, {n_work[k][1]} sweeps, {n_work[k][2]} slab tests"
              f" -> bound {bounds[k][0]:.6f} ms ({bounds[k][1]})",
              flush=True)
    # K1 and K2 on the rays cli trace --scene-out gives them (15,000 rays
    # before bounce 3, SmollRoom's 24 walls, one listener: the brute sweep
    # in lane groups), called as the trace calls them (the alive rays; each
    # shadow ray up to its listener); K5 and K6 at one 15,000 x 5 frame.
    # The work is the kernels' own count; the bytes each input read once
    # (origins and directions, the mask, K2's limits, the table) and each
    # output written once.
    _, st15 = ray_states(sc, p, RAYS, 0)
    o15, d15, a15 = st15.pos, st15.dir, st15.alive
    so15, sd15, l15 = shadow_rays(p, o15)
    a15s = a15[:, None].expand(-1, p.listeners.shape[0])
    walls_s = tk.sweep_walls(sc)
    check(walls_s.sorted is None, "[5] SmollRoom takes the brute sweep")
    sweeps = {
        "K1": (lambda **a: tk.nearest_hit(o15, d15, walls_s, a15, **a),
               lambda: tk.nearest_hit_plain(o15, d15, walls_s, a15),
               RAYS * 25 + 20 * w),
        "K2": (lambda **a: tk.occlusion_min(so15, sd15, walls_s, a15s, l15,
                                            **a),
               lambda: tk.occlusion_min_plain(so15, sd15, walls_s, a15s,
                                              l15),
               a15s.numel() * 25 + 20 * w)}
    for k, (fn, plain, n_bytes) in sweeps.items():
        times[k] = (cuda_ms(torch, fn, 50), cuda_ms(torch, plain, 20))
        # one launch a call: a reading that missed one is retried
        dev_ms[k] = kernel_device_ms(torch, fn, 20, "wall_sweep_kernel",
                                     launches=1)
        n_work[k] = work(lambda n: fn(work_counts=n))
        bounds[k] = bound(n_work[k], n_bytes)
    e1, u1 = (x[0] for x in rng.philox_uniforms(26, 1, BOUNCES, RAYS, dev))
    frame = {"K5": (lambda **a: bk.trace_fused_rows(sc, p, e1, u1, **a),
                    lambda: bk.trace_fused_rows_plain(sc, p, e1, u1),
                    "frame_rows_kernel"),
             "K6": (lambda **a: bk.trace_frame_ir_fused(sc, p, e1, u1, **kw,
                                                        **a),
                    lambda: bk.trace_frame_ir_fused_plain(sc, p, e1, u1,
                                                          **kw),
                    "frames_ir_kernel")}
    for k, (fn, plain, kname) in frame.items():
        times[k] = (cuda_ms(torch, fn, 20), cuda_ms(torch, plain, 5))
        dev_ms[k] = kernel_device_ms(torch, fn, 10, kname, launches=1)
        n_work[k] = work(lambda n: fn(work_counts=n))
    # K5: the table, its host uniforms in and its rows out (8 f32 per ray
    # and bounce); K6 is K3 at one frame. The per-bounce step kernel they
    # replaced also moved the ray state between its B launches (8 f32 +
    # 1 i32 per ray, written B times and read B - 1 times): its bound
    # counted that too, printed beside.
    bounds["K5"] = bound(n_work["K5"], rows_bytes(w, RAYS, BOUNCES))
    bounds["K6"] = bound(n_work["K6"], one_bytes
                         + 4 * RAYS * (1 + 3 * BOUNCES))
    old_state = 36 * RAYS * (2 * BOUNCES - 1)
    old_bounds = {"K5": bound(n_work["K5"], rows_bytes(w, RAYS, BOUNCES)
                              + old_state),
                  "K6": bound(n_work["K6"], one_bytes
                              + 4 * RAYS * (1 + 3 * BOUNCES) + old_state)}
    for k, shape in (("K1", f"{RAYS} rays x {w} walls"),
                     ("K2", f"{RAYS} shadow rays x {w} walls"),
                     ("K5", f"{RAYS} x {BOUNCES} x 1 frame, one launch"),
                     ("K6", f"{RAYS} x {BOUNCES} x 1 frame, one launch")):
        old = (f" (the per-bounce step kernel's: "
               f"{old_bounds[k][0]:.6f})" if k in old_bounds else "")
        print(f"    {k} at {shape}: {times[k][0]:.4f} ms per call vs plain "
              f"{times[k][1]:.4f}; device {fmt(dev_ms[k])} per call; "
              f"{n_work[k][0]} wall tests, {n_work[k][1]} sweeps -> bound "
              f"{bounds[k][0]:.6f} ms ({bounds[k][1]}){old}", flush=True)
    # the same kernels at the bench frame's 131,072 rays, and K1/K2 on the
    # 10,008-wall city with two listeners (plain over slices of rays)
    e8, u8b = emit8[0], u8[0]
    wide = {
        "K3 1 frame": (lambda: bk.trace_frames_ir_whole(sc, p, emit8, u8,
                                                        **kw),
                       "frames_ir_kernel"),
        "K5": (lambda: bk.trace_fused_rows(sc, p, e8, u8b),
               "frame_rows_kernel"),
        "K6": (lambda: bk.trace_frame_ir_fused(sc, p, e8, u8b, **kw),
               "frames_ir_kernel")}
    wide_ms = {k: (cuda_ms(torch, fn, 5),
                   kernel_device_ms(torch, fn, 3, name, launches=1))
               for k, (fn, name) in wide.items()}
    wide_plain = cuda_ms(torch, lambda: bk.trace_fused_rows_plain(
        sc, p, e8, u8b), 2)
    print(f"[5] K3, K5 and K6 on {card} at {BIG_RAYS} x {BIG_BOUNCES} x 1 "
          f"frame, {w} walls, ms per call [device]: "
          + ", ".join(f"{k} {v[0]:.4f} [{fmt(v[1])}]"
                      for k, v in wide_ms.items())
          + f"; K5's plain version {wide_plain:.3f}", flush=True)
    # K1 and K2 at 131,072 rays before bounce 3, called as the trace calls
    # them, on both routes: SmollRoom (the router's brute sweep) and the
    # 10,008-wall city with two listeners (the router's box walk, whose
    # times are the JSON line's K1b / K2b); the plain versions over slices
    # of rays. Brute-equivalent tests/s: R * W over the device time.
    for name, scene, pp in (("SmollRoom", sc, p),
                            ("city_scene(2500), 2 listeners", scene_9,
                             p_9two)):
        _, st = ray_states(scene, pp, BIG_RAYS, 20)
        o, d, alive = st.pos, st.dir, st.alive
        so, sd, lim = shadow_rays(pp, o)
        n_l = pp.listeners.shape[0]
        a2 = alive[:, None].expand(-1, n_l)
        packed = tk.pack_walls(scene)
        prep = ak.prepare(scene)
        routed = tk.sweep_walls(scene).sorted is not None
        step = max(256, PLAIN_ELEMENTS // (scene.n_walls * n_l))

        def plain_k1():
            for r0 in range(0, BIG_RAYS, step):
                sl = slice(r0, r0 + step)
                tk.nearest_hit_plain(o[sl], d[sl], packed, alive[sl])

        def plain_k2():
            for r0 in range(0, BIG_RAYS, step):
                sl = slice(r0, r0 + step)
                tk.occlusion_min_plain(so[sl], sd[sl], packed, a2[sl],
                                       lim[sl])

        plain_ms = {"K1": cuda_ms(torch, plain_k1, 1),
                    "K2": cuda_ms(torch, plain_k2, 1)}
        table = 4 * 5 * scene.n_walls
        box_table = 4 * (6 * prep.geo.shape[0] + 4 * prep.aabb.shape[0]
                         + 4 * prep.saabb.shape[0] + 4)
        for route, walls_r, kname in (
                ("brute", tk.SweepWalls(packed), "wall_sweep_kernel"),
                ("box walk", tk.SweepWalls(packed, prep),
                 "box_sweep_kernel")):
            calls = {
                "K1": (lambda **a: tk.nearest_hit(o, d, walls_r, alive, **a),
                       BIG_RAYS * 25),
                "K2": (lambda **a: tk.occlusion_min(so, sd, walls_r, a2, lim,
                                                    **a),
                       BIG_RAYS * n_l * 25)}
            said = []
            for k, (fn, n_bytes) in calls.items():
                call = cuda_ms(torch, fn, 10)
                dv = kernel_device_ms(torch, fn, 5, kname, launches=1)
                wk = work(lambda n: fn(work_counts=n))
                bd = bound(wk, n_bytes + (table if route == "brute"
                                          else box_table))
                n_rays = BIG_RAYS * (1 if k == "K1" else n_l)
                said.append(
                    f"{k} {call:.4f} ms per call [device {fmt(dv)}], work "
                    f"{wk}, bound {bd[0]:.6f} ms ({bd[1]})"
                    + ("" if dv is None else
                       f" = {bd[0] / dv * 100:.1f}% reached, "
                       f"{n_rays * scene.n_walls / dv / 1e9:.3f} T "
                       "brute-equivalent tests/s"))
                if scene is scene_9 and route == "box walk":
                    kb = k + "b"
                    times[kb] = (call, plain_ms[k])
                    dev_ms[kb], n_work[kb], bounds[kb] = dv, wk, bd
            print(f"[5] wall sweeps on {card}, {name}, {BIG_RAYS} rays x "
                  f"{scene.n_walls} walls before bounce {LATER}, {route}"
                  + (" (the router's)" if routed == (route == "box walk")
                     else "") + ": " + "; ".join(said)
                  + f"; plain versions K1 {plain_ms['K1']:.3f} ms, K2 "
                  f"{plain_ms['K2']:.3f} ms", flush=True)
        del so, sd, lim, a2
    for k in ("K1b", "K2b"):
        print(f"    {k} (box walk) at {BIG_RAYS} rays x {scene_9.n_walls} "
              f"walls, 2 listeners: {times[k][0]:.4f} ms per call vs plain "
              f"{times[k][1]:.4f}; device {fmt(dev_ms[k])}; work "
              f"{n_work[k]} -> bound {bounds[k][0]:.6f} ms ({bounds[k][1]})",
              flush=True)
    # trace(use_kernels=True) against the plain trace, one frame
    for n_rays, e_, u_ in ((RAYS, e1, u1), (BIG_RAYS, e8, u8b)):
        with_k = cuda_ms(torch, lambda: tt.trace_hits_only(
            sc, p, e_, u_, use_kernels=True), 5)
        without = cuda_ms(torch, lambda: tt.trace_hits_only(sc, p, e_, u_), 5)
        print(f"[5] trace(use_kernels=True) on {card}, SmollRoom {n_rays} x "
              f"{u_.shape[0]}: {with_k:.3f} ms per frame vs the plain trace "
              f"{without:.3f}", flush=True)
    # the directive instantiations' device time beside the omni ones, at
    # the kernel table's shapes (profiler; omni, directive, omni,
    # directive, so that a drift between readings shows)
    dmix = dict(mix_kw, directivity=aims, mic_directivity=mic_pat)

    def pick(pp, d):
        return directive(pp) if d else pp

    dir_runs = {
        "K3": (lambda d: bk.trace_frames_ir_whole(sc, pick(p, d), emit, u,
                                                  **kw), "frames_ir_kernel"),
        "K4": (lambda d: bk.trace_frames_ir_mega(sc, pick(p, d), 5, 1, **one),
               "frames_ir_kernel"),
        "K9": (lambda d: bk.trace_rooms_ir_mega(*mix_args,
                                                **(dmix if d else mix_kw)),
               "frames_ir_kernel"),
        "K8": (lambda d: ak.trace_frames_ir_accel_sorted(
            scene_9, pick(p_9, d), 5, 1, **one), "accel_bounce_kernel"),
        "K7": (lambda d: ak.trace_frames_ir_accel(
            scene_d, pick(p_d, d), 5, CITY_FRAMES, **city_run),
            "accel_bounce_kernel"),
        "K5": (lambda d: bk.trace_fused_rows(sc, pick(p, d), e1, u1),
               "frame_rows_kernel"),
        "K6": (lambda d: bk.trace_frame_ir_fused(sc, pick(p, d), e1, u1,
                                                 **kw), "frames_ir_kernel")}
    dir_runs["K4 131k x 8 x 8"] = (
        lambda d: bk.trace_frames_ir_mega(sc, pick(p, d), 6, nf, **big, **kw),
        "frames_ir_kernel")
    per_call = {"K8": BOUNCES, "K7": CITY_BOUNCES}
    for k, (run, kname) in dir_runs.items():
        reps = 2 if k in ("K7", "K4 131k x 8 x 8") else 10
        dev_d = [kernel_device_ms(torch, lambda: run(d), reps, kname,
                                  launches=per_call.get(k, 1))
                 for d in (False, True) * 3]
        # the median of three readings of each, each holding every launch
        # of its calls
        med = [None if None in dev_d[i::2] else float(np.median(dev_d[i::2]))
               for i in (0, 1)]
        ratio = ("not measured" if None in med else
                 f"{med[1] / med[0]:.4f}")
        print(f"[11c] {k} device ms per call on {card}, omni / directive "
              f"alternating: {', '.join(fmt(x) for x in dev_d)}; medians "
              f"{fmt(med[0])} / {fmt(med[1])}, directive over omni {ratio}",
              flush=True)
    band_timing = bands_timings(ctx, band_readings)
    del scene_32, p_32, scene_d1, band_timing
    launches.update(city_launches)
    for k, n in band_launches.items():   # the slice's paths ([12])
        launches[k] += n
    for k, n in spatial_launches.items():   # and [13]'s
        launches[k] = launches.get(k, 0) + n
    for k, n in doppler_launches.items():   # and [14]'s
        launches[k] = launches.get(k, 0) + n
    for k, n in live_launches.items():      # and [15]'s
        launches[k] = launches.get(k, 0) + n
    for k, n in diff_launches.items():      # and [16]'s
        launches[k] = launches.get(k, 0) + n
    for k, n in mesh_launches.items():      # and [17]'s
        launches[k] = launches.get(k, 0) + n

    # --- 19. the port's bench at the JAX sizes ---------------------------
    bench_launches, _ = bench_phase(ctx)
    for k, n in bench_launches.items():     # and [19]'s
        launches[k] = launches.get(k, 0) + n

    # --- 18. the example twins (last: no global torch state a twin sets
    # reaches an earlier phase) -------------------------------------------
    example_launches, _ = examples_phase(ctx)
    for k, n in example_launches.items():   # and [18]'s
        launches[k] = launches.get(k, 0) + n

    names = {"K3": ("bounce_kernel K3 (host uniforms)", 494, KERNEL_SOURCE),
             "K4": ("bounce_kernel K4 (in-kernel Philox)", 563,
                    KERNEL_SOURCE),
             "K9": ("bounce_kernel K9 (rooms-batched, in-kernel Philox)",
                    656, KERNEL_SOURCE),
             "K7": ("accel_kernel K7 (cluster early-out per bounce, Morton "
                    "re-sort, any K bands)", 1869, ACCEL_SOURCE),
             "K8": ("accel_kernel K8 (cluster early-out per bounce, Morton "
                    "re-sort)", 2154, ACCEL_SOURCE),
             "K1": ("trace_kernel K1 (nearest wall of each ray; brute "
                    "sweep, wall_sweep_kernel, up to BOX_WALK_MIN_WALLS)", 75,
                    SWEEP_SOURCE),
             "K2": ("trace_kernel K2 (occlusion minimum of each shadow ray; "
                    "brute sweep, wall_sweep_kernel)", 82, SWEEP_SOURCE),
             "K1b": ("trace_kernel K1 (nearest wall of each ray; box walk, "
                     "box_sweep_kernel, past BOX_WALK_MIN_WALLS)", 75,
                     SWEEP_SOURCE),
             "K2b": ("trace_kernel K2 (occlusion minimum of each shadow "
                     "ray; box walk, box_sweep_kernel)", 82, SWEEP_SOURCE),
             "K5": ("bounce_kernel K5 (frame_rows_kernel: a frame's "
                    "bounces in one launch, hit rows out)", 180,
                    KERNEL_SOURCE),
             "K6": ("bounce_kernel K6 (K3/K4's frames_ir_kernel at one "
                    "frame, in-kernel binning)", 1291, KERNEL_SOURCE)}
    # ms/plain_ms/bound of one call each: K3 and K4 at the stream's shape
    # (15k x 5 x 1 frame), K9 at the mixdown's (64 entries x 15k x 5), K8
    # at the city stream's, K7 at the banded city's, K1/K2 on the 15,000
    # rays of cli trace --scene-out (brute sweep), K1b/K2b (the box walk)
    # on 131,072 rays of the 10,008-wall city with two listeners before
    # bounce 3, K5/K6 at one 15k x 5 frame; the
    # sweep's and the other full-width numbers are in the [5] and [8]
    # lines. No PyTorch call computes a Monte-Carlo trace or a bounce, and
    # none a fused rays x segments min/argmin (the plain versions are
    # several calls: plain_ms), so library_ms is null.
    kernels = [
        {"name": names[k][0], "route": "cuda", "source": names[k][2],
         "replaces": f"{PALLAS_SWEEPS if k[:2] in ('K1', 'K2') else PALLAS}:"
                     f"{names[k][1]}", "launches": launches[k],
         "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None}
        for k in ("K1", "K2", "K1b", "K2b", "K3", "K4", "K5", "K6", "K7",
                  "K8", "K9")]
    print(json.dumps({"kernels": kernels}))
    print(f"K3/K4/K6's argument kernel (k4_args_kernel): "
          f"{bk.k4_args.launches} launches over the smoke", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
