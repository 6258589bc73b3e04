"""Distributed round tracing: span journals + wire-propagated context.

Port of the JAX package's ``runtime/spans.py``; the journals are schema
v1, byte-compatible with it, so ``tools/sl_trace.py`` reads either
package's runs.

* :class:`Tracer` — one per participant.  Spans (name, participant,
  trace/span/parent ids, start and duration, queue, frame kind, bytes)
  are appended to a per-participant ``spans-{participant}.jsonl``
  journal by a thread-safe buffered :class:`SpanJournal`.  Parenting is
  implicit through a per-thread span stack (context-manager spans), or
  explicit for cross-participant edges.
* **Wire context** — :func:`pack_ctx` / :func:`unpack_ctx` encode a
  ``(trace_id, span_id, t_send)`` triple in 32 bytes that the TENSOR and
  chunk frame headers carry (``runtime/protocol.py``), so every
  Activation, Gradient and Update frame links the sender's *publish*
  span to the receiver's *consume* span, and ``t_send`` gives the
  frame's true RTT.

A disabled tracer returns a shared no-op span, sampling is one draw of
the global ``random`` (only below a sample rate of 1), and journal writes
buffer ``flush_every`` records between file appends.  Span timestamps
are ``time.time()`` so spans of different processes merge on one
timeline; durations inside one process use ``time.perf_counter()`` at
the call sites.

Not ported: the flight-recorder feed of each closed span (the blackbox).
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import random
import struct
import threading
import time
import uuid
from typing import Any

#: spans.jsonl record schema version (bump on breaking change)
SCHEMA_VERSION = 1

# Fixed 32 bytes: 16-byte trace id | 8-byte sender span id | f64 send
# time (epoch seconds).  A fixed size keeps frame lengths deterministic
# under chaos seeding (corruption positions depend on payload length).
_CTX = struct.Struct(">16s8sd")
CTX_BYTES = _CTX.size


def pack_ctx(trace_id: str, span_id: str, t_send: float | None = None
             ) -> bytes:
    """Encode a wire trace context (hex ids -> 32 opaque bytes)."""
    return _CTX.pack(bytes.fromhex(trace_id), bytes.fromhex(span_id),
                     time.time() if t_send is None else t_send)


def unpack_ctx(raw: bytes | None) -> tuple[str, str, float] | None:
    """Decode a wire trace context; None on absent or malformed input (a
    frame without one degrades to "no edge", never raises into a decode
    path)."""
    if not raw or len(raw) != CTX_BYTES:
        return None
    tid, sid, t_send = _CTX.unpack(raw)
    return tid.hex(), sid.hex(), t_send


class SpanJournal:
    """Thread-safe buffered JSONL appender for span records: the hot
    path pays a dict and a list append, and ``flush_every`` records go
    out in one file append; ``flush`` runs at round boundaries and on
    close."""

    def __init__(self, path: str | pathlib.Path, flush_every: int = 128):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # created eagerly: a run-scoped compat symlink to this journal
        # must never dangle
        self.path.touch(exist_ok=True)
        self._flush_every = max(1, flush_every)
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._closed = False

    def append(self, rec: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._buf.append(rec)
            if len(self._buf) < self._flush_every:
                return
            buf, self._buf = self._buf, []
        self._write(buf)

    def _write(self, buf: list[dict]) -> None:
        if not buf:
            return
        data = "".join(json.dumps(r) + "\n" for r in buf)
        with open(self.path, "a") as f:
            f.write(data)
            f.flush()

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        self._write(buf)

    def close(self) -> None:
        self.flush()
        with self._lock:
            self._closed = True


class _NullSpan:
    """Shared no-op span: the disabled or unsampled fast path."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One open span; ``end()`` (idempotent) writes the journal record.

    May be ended on another thread than the one that started it (the
    async sender ends *publish* spans): ``end`` touches no tracer
    thread state."""

    __slots__ = ("_tracer", "name", "id", "parent", "t0", "attrs",
                 "_thread", "_done")

    def __init__(self, tracer: "Tracer", name: str, parent: str | None,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.id = uuid.uuid4().hex[:16]
        self.parent = parent
        self.t0 = time.time()
        self.attrs = attrs
        self._thread = threading.current_thread().name
        self._done = False

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self._tracer._emit(self, time.time())

    def __enter__(self):
        self._tracer._push(self.id)
        return self

    def __exit__(self, *exc):
        self._tracer._pop()
        self.end()
        return False


class Tracer:
    """Per-participant span factory + journal.

    ``trace_id`` is run-scoped: the server makes one and sends it in
    START (``extra["trace_id"]``), so every participant's journal and
    every wire context carries the same id, across processes too
    (:meth:`adopt_trace_id`)."""

    def __init__(self, participant: str, enabled: bool = True,
                 sample_rate: float = 1.0,
                 journal_dir: str | pathlib.Path = ".",
                 trace_id: str | None = None, flush_every: int = 128):
        self.participant = participant
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self.trace_id = trace_id or uuid.uuid4().hex
        self._tls = threading.local()
        self._journal = (SpanJournal(
            pathlib.Path(journal_dir) / f"spans-{participant}.jsonl",
            flush_every) if enabled else None)

    # -- parenting stack (per thread) ---------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span_id: str | None) -> None:
        self._stack().append(span_id)

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def current_id(self) -> str | None:
        st = self._stack()
        return st[-1] if st else None

    # -- span creation ------------------------------------------------------

    def _sampled(self, always: bool) -> bool:
        if not self.enabled:
            return False
        if always or self.sample_rate >= 1.0:
            return True
        return random.random() < self.sample_rate

    def start(self, name: str, parent: str | None = None,
              always: bool = True, **attrs: Any):
        """Open a span (ended with ``span.end()``).  With
        ``always=False`` the configured sample rate applies (per-frame
        and per-batch spans); structural spans always record."""
        if not self._sampled(always):
            return NULL_SPAN
        if parent is None:
            parent = self.current_id()
        return Span(self, name, parent, attrs)

    def span(self, name: str, parent: str | None = None,
             always: bool = True, **attrs: Any):
        """Context-manager span; children opened on this thread inside
        the block inherit it as parent."""
        s = self.start(name, parent=parent, always=always, **attrs)
        if s is NULL_SPAN:
            return contextlib.nullcontext(NULL_SPAN)
        return s

    def record(self, name: str, t0: float, t1: float,
               parent: str | None = None, always: bool = False,
               **attrs: Any) -> str | None:
        """Write an already-timed span (the consume path times the
        decode before it knows the message carried a context)."""
        if not self._sampled(always):
            return None
        s = Span(self, name, parent if parent is not None
                 else self.current_id(), attrs)
        s.t0 = t0
        s._done = True
        self._emit(s, t1)
        return s.id

    def wire_context(self, span) -> bytes:
        """Wire bytes linking ``span`` to its receiver's consume span;
        empty when the span was not sampled."""
        if span is NULL_SPAN or span.id is None:
            return b""
        return pack_ctx(self.trace_id, span.id)

    def adopt_trace_id(self, trace_id: str) -> None:
        """Join the server's run-scoped trace (START extra)."""
        if trace_id:
            self.trace_id = trace_id

    # -- journal ------------------------------------------------------------

    def _emit(self, span: Span, t1: float) -> None:
        if self._journal is None:
            return
        rec = {"v": SCHEMA_VERSION, "trace": self.trace_id,
               "span": span.id, "parent": span.parent,
               "name": span.name, "part": self.participant,
               "thread": span._thread, "ts": round(span.t0, 6),
               "dur": round(max(0.0, t1 - span.t0), 6)}
        for k, v in span.attrs.items():
            if v is not None:
                rec[k] = v
        self._journal.append(rec)

    def flush(self) -> None:
        if self._journal is not None:
            self._journal.flush()

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()


def make_tracer(cfg, participant: str) -> Tracer:
    """A participant's tracer from ``cfg.observability`` (a disabled one
    when the config has no such block).

    Under ``observability.run-scoped`` the journal lands in the same
    ``artifacts/runs/<run_id>/`` directory as the logger's outputs
    (``runtime/log.py``), with a compat symlink at the flat path."""
    obs = getattr(cfg, "observability", None)
    if obs is None:
        return Tracer(participant, enabled=False)
    journal_dir = pathlib.Path(obs.journal_dir or cfg.log_path)
    if obs.enabled and getattr(obs, "run_scoped", False):
        from split_learning_torch.runtime.log import (
            compat_link, run_output_dir, write_run_owner,
        )
        out = run_output_dir(journal_dir)
        name = f"spans-{participant}.jsonl"
        try:
            out.mkdir(parents=True, exist_ok=True)
            ok = True
        except OSError:
            ok = False
        if ok:
            write_run_owner(out)
            # eager target so the link below never dangles
            (out / name).touch(exist_ok=True)
            if compat_link(journal_dir / name, out / name):
                journal_dir = out
    return Tracer(participant, enabled=obs.enabled,
                  sample_rate=obs.sample_rate,
                  journal_dir=journal_dir,
                  flush_every=obs.flush_every)
