"""Interactive steering channel: drive a RUNNING stream from outside.

The port's copy of ``realisticaudioraytracing2d_tpu/posefeed.py`` (the
same protocol, folding and messages). Two changes: :meth:`PoseFeed.params`
puts an override on the device of the stream's parameters as a float32
tensor (the port's ``TraceParams`` holds tensors on one device), and the
partial-line buffer holds bytes, split on ``b"\\n"`` and decoded one whole
line at a time, so a multibyte UTF-8 character torn across two polls
parses (the JAX copy decodes each read and turns a torn character into
U+FFFD).

The reference is steered live — every frame it re-reads the scene
object transforms and the keyboard while audio plays
(``RayTraceManager.cs:50-61,67``: Update() reads ``source.position`` /
``listener.position``, Space toggles streaming, R resets the impulse;
FixedUpdate re-flattens moving colliders). The framework's trajectories
(``--move-source``, ``params_fn``, ``facing_fn``) are declared up
front; this module adds the missing *channel*: a JSON-lines feed (a
file being appended to, or stdin) that overrides the trajectory chunk
by chunk while the stream runs — the functional equivalent of dragging
the Unity source (or a wall) around mid-play and hitting R/Space.

Feed protocol — one JSON object per line:

    {"chunk": 12, "source": [x, y]}
    {"chunk": 20, "listener": [x, y], "facing": 1.57}
    {"source": [x, y]}                  # no chunk: applies immediately
    {"chunk": 8, "obstacle": "Wall (4)", "position": [x, y],
     "angle": 0.4}                      # drag a wall mid-stream
    {"chunk": 30, "command": "reset_ir"}   # the R key
    {"command": "stop"}                    # the Space key

* ``chunk`` (optional int >= 0): the chunk index the line takes effect
  at; omitted = the next chunk polled. Lines may arrive in any order
  and any time; a line whose chunk has already played applies at the
  next poll (live feeds are late by nature).
* ``source`` / ``listener``: ``[x, y]`` (or ``[[x, y], ...]`` matching
  the param's source/listener count), world meters.
* ``facing`` (radians): the binaural head bearing.
* ``obstacle`` (collider name or build-order index) with ``position``
  ``[x, y]`` and/or ``angle`` (radians): re-pose that collider — the
  scene is re-flattened through the bound
  :meth:`..models.scene.SceneBuilder.move_collider` into the SAME
  padded wall count, so a moved wall changes no shape
  (``RayTraceManager.cs:67,246-250`` -> ``SceneHelper.cs:29-76``).
  Scale/shape are not steerable (they would change the wall count).
* ``command``: ``"stop"`` ends the stream after the reverb tail
  flushes (Space, ``RayTraceManager.cs:55-57``); ``"reset_ir"`` drops
  the IR memory once at its chunk (R -> ``ClearImpulse``,
  ``RayTraceManager.cs:58-61``).
* Overrides HOLD until a later line changes them (the Unity transform
  stays where you dragged it); per-obstacle position and angle hold
  independently. Commands are events, not holds.

Every line is validated; a malformed line raises :class:`PoseFeedError`
naming the line — a steering channel that silently skips your input is
worse than one that stops.

Reads are non-blocking: each poll consumes whatever complete lines have
arrived (``select`` on pipes/stdin, plain read-to-EOF on regular files,
which is exactly "tail -f" semantics since the position persists across
polls). A trailing partial line is buffered until its newline arrives.

State is FOLDED, not replayed: events whose effective chunk is at least
one chunk behind the furthest chunk queried collapse into a constant-
size base, so a chatty feed (30 lines/s from a UI, hours long) costs
O(new lines) per poll and bounded memory, not an O(history) re-sort
per poll. Queries may look back at most ONE chunk
behind the furthest query (exactly the Doppler rate lookahead's
``params_fn(i + 1)`` pattern); both pipelines satisfy this.
"""

from __future__ import annotations

import io
import json
import os
import select
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class PoseFeedError(ValueError):
    """A malformed pose-feed line (bad JSON, unknown key, bad shape)."""


_KEYS = {"chunk", "source", "listener", "facing", "obstacle", "position",
         "angle", "command"}
_COMMANDS = {"stop", "reset_ir"}


def _validate(obj, line_no: int, line: str) -> Dict:
    if not isinstance(obj, dict):
        raise PoseFeedError(
            f"pose feed line {line_no}: expected a JSON object, got "
            f"{type(obj).__name__}: {line!r}")
    unknown = set(obj) - _KEYS
    if unknown:
        raise PoseFeedError(
            f"pose feed line {line_no}: unknown key(s) {sorted(unknown)} "
            f"(valid: {sorted(_KEYS)}): {line!r}")
    out: Dict = {}
    if "chunk" in obj:
        c = obj["chunk"]
        if not isinstance(c, int) or isinstance(c, bool) or c < 0:
            raise PoseFeedError(
                f"pose feed line {line_no}: 'chunk' must be an int >= 0, "
                f"got {c!r}")
        out["chunk"] = c
    for key in ("source", "listener"):
        if key in obj:
            try:
                arr = np.asarray(obj[key], np.float32)
            except (TypeError, ValueError) as e:
                raise PoseFeedError(
                    f"pose feed line {line_no}: bad {key!r}: {e}") from None
            if arr.shape != (2,) and not (arr.ndim == 2
                                          and arr.shape[-1] == 2):
                raise PoseFeedError(
                    f"pose feed line {line_no}: {key!r} must be [x, y] or "
                    f"[[x, y], ...], got shape {arr.shape}")
            if not np.isfinite(arr).all():
                raise PoseFeedError(
                    f"pose feed line {line_no}: non-finite {key!r}: "
                    f"{obj[key]!r}")
            out[key] = arr
    for key in ("facing", "angle"):
        if key in obj:
            f = obj[key]
            if isinstance(f, bool) or not isinstance(f, (int, float)) \
                    or not np.isfinite(f):
                raise PoseFeedError(
                    f"pose feed line {line_no}: {key!r} must be a finite "
                    f"number (radians), got {f!r}")
            out[key] = float(f)
    if "position" in obj:
        try:
            pos = np.asarray(obj["position"], np.float64)
        except (TypeError, ValueError) as e:
            raise PoseFeedError(
                f"pose feed line {line_no}: bad 'position': {e}") from None
        if pos.shape != (2,) or not np.isfinite(pos).all():
            raise PoseFeedError(
                f"pose feed line {line_no}: 'position' must be a finite "
                f"[x, y], got {obj['position']!r}")
        out["position"] = (float(pos[0]), float(pos[1]))
    if "obstacle" in obj:
        o = obj["obstacle"]
        if isinstance(o, bool) or not isinstance(o, (str, int)):
            raise PoseFeedError(
                f"pose feed line {line_no}: 'obstacle' must be a collider "
                f"name (str) or index (int), got {o!r}")
        if "position" not in out and "angle" not in out:
            raise PoseFeedError(
                f"pose feed line {line_no}: 'obstacle' needs 'position' "
                f"and/or 'angle': {line!r}")
        out["obstacle"] = o
    elif "position" in out or "angle" in out:
        raise PoseFeedError(
            f"pose feed line {line_no}: 'position'/'angle' steer an "
            f"obstacle — add \"obstacle\": <name-or-index> ('facing' "
            f"steers the head): {line!r}")
    if "command" in obj:
        c = obj["command"]
        if c not in _COMMANDS:
            raise PoseFeedError(
                f"pose feed line {line_no}: unknown command {c!r} "
                f"(valid: {sorted(_COMMANDS)})")
        out["command"] = c
    if not (set(out) - {"chunk"}):
        raise PoseFeedError(
            f"pose feed line {line_no}: no override present "
            f"(need source/listener/facing/obstacle/command): {line!r}")
    return out


class _BaseState:
    """Folded overrides: everything that can no longer be affected by a
    query (constant size however long the feed runs)."""

    __slots__ = ("src", "lis", "fac", "obstacles", "stop_due")

    def __init__(self):
        self.src = None
        self.lis = None
        self.fac = None
        # obstacle key -> (position | None, angle | None, line_no)
        self.obstacles: Dict = {}
        self.stop_due: Optional[int] = None

    def apply(self, due: int, o: Dict, line_no: int) -> None:
        self.src = o.get("source", self.src)
        self.lis = o.get("listener", self.lis)
        self.fac = o.get("facing", self.fac)
        if "obstacle" in o:
            key = o["obstacle"]
            pos, ang, _ = self.obstacles.get(key, (None, None, 0))
            self.obstacles[key] = (o.get("position", pos),
                                   o.get("angle", ang), line_no)
        if o.get("command") == "stop" and self.stop_due is None:
            self.stop_due = due


class PoseFeed:
    """Poll-driven JSON-lines steering for a running stream.

    Wraps a base ``params_fn`` / ``facing_fn`` / ``scene_fn``: call
    :meth:`params` / :meth:`facing` / :meth:`scene` in place of them and
    :meth:`control` as the pipeline's ``control_fn`` (all called per
    chunk, near-monotonically). Each call polls the feed for newly
    arrived lines first.
    """

    def __init__(self, fh: io.IOBase, close: bool = False):
        # ``fh``: a binary file (``open()`` reads regular files unbuffered
        # binary) or a text stream; either way the bytes that arrive are
        # buffered and decoded one whole line at a time (_read_available)
        self._fh = fh
        self._close = close
        self._buf = b""
        self._line_no = 0
        # folded base + the small pending window (events whose effective
        # chunk is >= the fold watermark); pending is kept sorted lazily
        # per query — it only ever holds not-yet-due lines plus the
        # current chunk's, not the whole history.
        self._base = _BaseState()
        self._pending: List[Tuple[int, int, Dict, int]] = []
        self._resets: List[int] = []       # due chunks, consumed on query
        self._max_q = -1                   # furthest chunk ever queried
        self._rebuilder = None             # SceneBuilder for obstacles
        self._scene_cache = None     # (key, base_scene, scene) memo
        fd = None
        try:
            fd = fh.fileno()
        except (OSError, io.UnsupportedOperation, AttributeError):
            pass
        # Regular files read to EOF without blocking (tail semantics);
        # pipes/terminals need a readiness check per poll.
        self._select_fd = fd if fd is not None and not os.path.isfile(
            _fd_path(fd)) else None

    # -- construction --------------------------------------------------------

    @staticmethod
    def open(path: str) -> "PoseFeed":
        """``path`` or ``-`` for stdin.

        Regular files are opened UNBUFFERED BINARY: tailing a growing
        file through a text-mode ``read()`` can silently drop the bytes
        between two polls (CPython's text layer caches a decoder
        snapshot at EOF; a 10-minute soak reproduced a torn line whose
        head vanished while the file on disk was intact). A raw
        ``FileIO.read()`` advances exactly by the bytes it returns, so
        the partial-line buffer in :meth:`poll` sees every byte once."""
        if path == "-":
            return PoseFeed(sys.stdin, close=False)
        return PoseFeed(open(path, "rb", buffering=0), close=True)

    def bind_scene(self, builder) -> "PoseFeed":
        """Attach the :class:`..models.scene.SceneBuilder` whose collider
        records resolve ``obstacle`` lines (see :meth:`scene`)."""
        self._rebuilder = builder
        return self

    def close(self) -> None:
        if self._close:
            self._fh.close()

    # -- polling -------------------------------------------------------------

    def _read_available(self) -> bytes:
        """The bytes that arrived since the last poll, undecoded: a read
        may end inside a multibyte character, so only :meth:`poll`
        decodes, one whole line at a time."""
        if self._select_fd is not None:
            chunks = []
            while select.select([self._select_fd], [], [], 0)[0]:
                data = os.read(self._select_fd, 65536)
                if not data:
                    break
                chunks.append(data)
            return b"".join(chunks)
        data = self._fh.read()
        if isinstance(data, str):            # a text stream
            return data.encode("utf-8")
        return data or b""                   # binary tail (see open())

    def poll(self, chunk_index: int) -> None:
        """Consume every complete line that has arrived. Each line is
        recorded with its *effective* chunk — ``max(line's chunk,
        chunk_index)``: a future chunk waits for its chunk, a line with
        no chunk (or one whose chunk already played) takes effect now.
        Which overrides a given chunk sees is folded per query
        (:meth:`_state`), never held mutably — so the Doppler rate
        lookahead's ``params_fn(i + 1)`` call polling at ``i + 1``
        cannot leak a chunk-``i+1`` override into chunk ``i``'s trace
        (it also means a chunk-less line racing that lookahead lands at
        ``i + 1`` instead of ``i`` — live feeds are late by nature)."""
        self._buf += self._read_available()
        while b"\n" in self._buf:
            raw, self._buf = self._buf.split(b"\n", 1)
            line = raw.decode("utf-8", errors="replace")
            self._line_no += 1
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise PoseFeedError(
                    f"pose feed line {self._line_no}: invalid JSON "
                    f"({e.msg}): {line!r}") from None
            o = _validate(obj, self._line_no, line)
            due = max(o.get("chunk", chunk_index), chunk_index)
            if o.get("command") == "reset_ir":
                self._resets.append(due)
                if not (set(o) - {"chunk", "command"}):
                    continue
            self._pending.append((due, self._line_no, o, self._line_no))

    def _fold(self, chunk_index: int) -> None:
        """Collapse events that no query can revisit (due <= furthest
        query - 1; queries look back at most one chunk — the Doppler
        lookahead) into the constant-size base."""
        self._max_q = max(self._max_q, chunk_index)
        watermark = self._max_q - 1
        if not self._pending or self._pending[0][0] > watermark \
                and all(d > watermark for d, *_ in self._pending):
            return
        self._pending.sort(key=lambda e: (e[0], e[1]))
        keep = []
        for due, seq, o, line_no in self._pending:
            if due <= watermark:
                self._base.apply(due, o, line_no)
            else:
                keep.append((due, seq, o, line_no))
        self._pending = keep

    def _state(self, chunk_index: int):
        """The overrides effective at ``chunk_index``: the folded base
        overlaid with pending events due <= chunk_index, by effective
        chunk then feed order — the line applied *latest* wins
        (hold-until-changed), exactly the mutable-hold semantics for
        in-order playback, but stable under the one-chunk lookahead."""
        self._fold(chunk_index)
        src, lis, fac = self._base.src, self._base.lis, self._base.fac
        obstacles = dict(self._base.obstacles)
        stop_due = self._base.stop_due
        for due, _seq, o, line_no in sorted(self._pending,
                                            key=lambda e: (e[0], e[1])):
            if due <= chunk_index:
                src = o.get("source", src)
                lis = o.get("listener", lis)
                fac = o.get("facing", fac)
                if "obstacle" in o:
                    key = o["obstacle"]
                    pos, ang, _ = obstacles.get(key, (None, None, 0))
                    obstacles[key] = (o.get("position", pos),
                                      o.get("angle", ang), line_no)
                if o.get("command") == "stop" and stop_due is None:
                    stop_due = due
        return src, lis, fac, obstacles, stop_due

    # -- the params_fn / facing_fn / scene_fn / control_fn replacements ------

    def params(self, base_params, chunk_index: int):
        """``base_params`` = the trajectory's ``params_fn(chunk_index)``
        output (tensors on one device); returns it with any held
        overrides applied, as float32 tensors on the device of
        ``base_params.source``."""
        self.poll(chunk_index)
        src_ov, lis_ov = self._state(chunk_index)[:2]
        p = base_params
        dev = p.source.device
        if src_ov is not None:
            shape = tuple(p.source.shape)
            ov = np.asarray(src_ov, np.float32)
            if len(shape) == 1:
                # single-source stream: accept [x, y] or [[x, y]]
                if ov.ndim == 2 and ov.shape == (1, 2):
                    ov = ov[0]
            else:
                ov = ov.reshape(-1, 2)
                if ov.shape[0] == 1 and shape[0] > 1:
                    ov = np.broadcast_to(ov, shape)
            if ov.shape != shape:
                raise PoseFeedError(
                    f"pose feed: source override shape {ov.shape} does "
                    f"not match the stream's {shape}")
            p = p._replace(source=torch.tensor(ov, dtype=torch.float32,
                                               device=dev))
        if lis_ov is not None:
            shape = tuple(p.listeners.shape)
            ov = lis_ov.reshape(-1, 2)
            if ov.shape[0] == 1 and shape[0] > 1:
                ov = np.broadcast_to(ov, shape)
            if ov.shape != shape:
                raise PoseFeedError(
                    f"pose feed: listener override shape {ov.shape} does "
                    f"not match the stream's {shape}")
            p = p._replace(listeners=torch.tensor(ov, dtype=torch.float32,
                                                  device=dev))
        return p

    def facing(self, base_facing, chunk_index: int):
        """Held facing override, else the trajectory's value. Polls
        (idempotent per arrived data, so params+facing in one chunk is
        fine in either order)."""
        self.poll(chunk_index)
        fac = self._state(chunk_index)[2]
        return fac if fac is not None else base_facing

    def scene(self, base_scene, chunk_index: int):
        """``base_scene`` with any held obstacle overrides re-flattened
        in (same padded wall count: no shape changes). Needs
        :meth:`bind_scene`; an obstacle line on an unbound feed, or one
        naming an unknown collider, errors naming the feed line. The
        rebuilt scene is memoized per override set, so chunks between
        moves reuse one host flatten."""
        self.poll(chunk_index)
        obstacles = self._state(chunk_index)[3]
        if not obstacles:
            return base_scene
        cache_key = tuple(sorted((str(k), pos, ang)
                                 for k, (pos, ang, _) in
                                 obstacles.items()))
        # the base scene rides the cache entry by IDENTITY (not id():
        # a reclaimed id can alias a fresh scene and serve stale
        # geometry silently)
        if self._scene_cache is not None \
                and self._scene_cache[0] == cache_key \
                and self._scene_cache[1] is base_scene:
            return self._scene_cache[2]
        scene = base_scene
        for key, (pos, ang, line_no) in obstacles.items():
            if self._rebuilder is None:
                raise PoseFeedError(
                    f"pose feed line {line_no}: obstacle override for "
                    f"{key!r}, but this stream has no steerable scene "
                    f"(no SceneBuilder bound — procedural/batched scenes "
                    f"are not steerable)")
            try:
                scene = self._rebuilder.move_collider(scene, key,
                                                      position=pos,
                                                      angle=ang)
            except (KeyError, ValueError) as e:
                raise PoseFeedError(
                    f"pose feed line {line_no}: {e}") from None
        self._scene_cache = (cache_key, base_scene, scene)
        return scene

    def control(self, chunk_index: int) -> Dict:
        """The pipeline ``control_fn``: ``{"stop": bool, "reset_ir":
        bool}`` for this chunk. ``reset_ir`` fires exactly once per
        feed line (consumed here); ``stop`` holds from its chunk on."""
        self.poll(chunk_index)
        stop_due = self._state(chunk_index)[4]
        due = [d for d in self._resets if d <= chunk_index]
        if due:
            self._resets = [d for d in self._resets if d > chunk_index]
        return {"stop": stop_due is not None and chunk_index >= stop_due,
                "reset_ir": bool(due)}


def _fd_path(fd: int) -> str:
    """/proc path of an fd (for the regular-file check); falls back to a
    non-file sentinel when /proc is unavailable."""
    p = f"/proc/self/fd/{fd}"
    return p if os.path.exists(p) else ""
