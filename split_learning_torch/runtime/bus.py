"""Message transports for the control and data plane.

Port of the part of the JAX package's ``runtime/bus.py`` that the
in-process protocol round runs: :class:`Transport` (named byte queues
with per-queue publish-byte counters) and :class:`InProcTransport`
(thread-safe in-process queues: the server and every client thread of
one process share one instance).  Blocking ``get`` waits on a condition
variable, never by polling.

The TCP broker and transport, the sharded broker plane, and the
reliable, chaos and async wrapper layers come with the next slice
(``transport.kind: tcp``); :func:`make_transport` raises for them.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterable


class QueueClosed(Exception):
    pass


class Transport:
    """Named-queue message transport (byte payloads).

    Concrete transports call :meth:`_count` from ``publish`` so tests and
    metrics can audit wire traffic via :attr:`bytes_out`."""

    def __init__(self):
        # own lock: one transport is shared by server + client threads
        self._count_lock = threading.Lock()
        self.bytes_out: dict = {}

    def publish(self, queue: str, payload: bytes) -> None:
        raise NotImplementedError

    def _count(self, queue: str, payload: bytes) -> None:
        with self._count_lock:
            self.bytes_out[queue] = (self.bytes_out.get(queue, 0)
                                     + len(payload))

    def bytes_out_snapshot(self) -> dict:
        """Consistent copy of the per-queue publish-byte counters."""
        with self._count_lock:
            return dict(self.bytes_out)

    def get(self, queue: str, timeout: float | None = None) -> bytes | None:
        """Pop one message; block up to ``timeout`` (None = forever).
        Returns None on timeout."""
        raise NotImplementedError

    def purge(self, queues: Iterable[str] | None = None) -> None:
        """Drop pending messages (all queues if None)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcTransport(Transport):
    """Thread-safe in-process queues."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict[str, collections.deque] = \
            collections.defaultdict(collections.deque)
        self._closed = False

    def publish(self, queue: str, payload: bytes) -> None:
        self._count(queue, payload)
        with self._cond:
            if self._closed:
                raise QueueClosed(queue)
            self._queues[queue].append(payload)
            self._cond.notify_all()

    def get(self, queue: str, timeout: float | None = None) -> bytes | None:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._closed or self._queues[queue], timeout)
            if self._closed:
                raise QueueClosed(queue)
            if not ok:
                return None
            return self._queues[queue].popleft()

    def purge(self, queues: Iterable[str] | None = None) -> None:
        with self._cond:
            if queues is None:
                self._queues.clear()
            else:
                for q in queues:
                    self._queues.pop(q, None)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def make_transport(kind: str = "inproc") -> Transport:
    """A fresh transport of ``kind``; only ``inproc`` is ported."""
    if kind == "inproc":
        return InProcTransport()
    if kind == "tcp":
        raise NotImplementedError(
            "transport.kind tcp (the TCP broker and its transport) is not "
            "ported yet; it comes with the next protocol slice")
    raise ValueError(f"unknown transport kind {kind!r}; use inproc or tcp")
