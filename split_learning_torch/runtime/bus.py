"""Message transports for the control and data plane.

Port of the JAX package's ``runtime/bus.py`` as far as the protocol
round's two shapes run it:

* :class:`InProcTransport` — thread-safe in-process queues: the server
  and every client thread of one process share one instance
  (``run_inproc``);
* :class:`Broker` + :class:`TcpTransport` — the deployment shape: a
  length-prefixed TCP broker and its client.  The broker is one
  ``selectors`` event-loop thread whatever the connection count:
  blocked GETs are parked continuations with a deadline timer, a publish
  completes the oldest parked GET directly, reads and writes are
  buffered and may be partial, and each connection's send queue is
  capped (backpressure).  A GET on :data:`BROKER_STATS_QUEUE` answers
  with the broker's JSON stats frame.  The socket protocol is the
  reference's byte for byte, so either package's transport talks to
  either package's broker;
* :class:`AsyncTransport` — the outermost layer of a participant's
  stack (``transport.async-send``): a bounded send FIFO drained by one
  sender thread (a publish may be a thunk that builds its frame parts
  there), and lazy per-queue receive prefetchers for the data plane.

Blocking ``get`` waits on a condition variable or a socket, never by
polling.

Not ported yet (each raises ``NotImplementedError`` where a config asks
for it): the sharded broker plane (``broker.shards`` > 1), the
reliable layer (``transport.reliable``), chaos injection and the
native C++ broker.
"""

from __future__ import annotations

import collections
import fnmatch
import heapq
import json
import os
import selectors
import socket
import struct
import threading
import time
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


# --------------------------------------------------------------------------
# TCP broker
# --------------------------------------------------------------------------
# Frame: 1-byte op | 4-byte BE queue-name len | name | 8-byte BE payload len
# | payload.  Ops: P=publish, G=get(blocking; payload = 8-byte BE timeout in
# ms, 0 = forever), X=purge, R=reply (broker->client; a payload length of
# all ones means timeout).

_OP_PUB, _OP_GET, _OP_PURGE, _OP_REPLY = b"P", b"G", b"X", b"R"
_TIMEOUT_SENTINEL = 0xFFFFFFFFFFFFFFFF

#: frame sanity caps — a corrupt length prefix must fail the connection,
#: not drive the broker into a multi-terabyte allocation
MAX_NAME_BYTES = 1 << 16
MAX_FRAME_BYTES = 1 << 33          # 8 GiB

#: payloads at least this long go out as their own ``sendall`` after the
#: header instead of being joined to it (no copy of a 512 MB chunk)
_JOIN_BELOW = 1 << 16


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly ``n`` bytes, read into one preallocated buffer (a frame
    of gigabytes arrives in many short reads)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("socket closed")
        got += k
    return bytes(buf) if n < _JOIN_BELOW else buf


def _no_delay(sock: socket.socket) -> None:
    """Send each write at once: a GET is a small request waiting on a
    reply, which Nagle's algorithm would hold for the peer's delayed
    ACK."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def _frame_header(op: bytes, name: bytes, plen: int) -> bytes:
    return op + struct.pack(">I", len(name)) + name + struct.pack(">Q", plen)


def _send_frame(sock: socket.socket, op: bytes, name: bytes,
                payload: bytes) -> None:
    head = _frame_header(op, name, len(payload))
    if len(payload) < _JOIN_BELOW:
        sock.sendall(head + payload)
    else:
        sock.sendall(head)
        sock.sendall(payload)


def _recv_frame(sock: socket.socket) -> tuple[bytes, bytes, bytes | None]:
    op = _recv_exact(sock, 1)
    (nlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    if nlen > MAX_NAME_BYTES:
        raise ConnectionError(f"corrupt frame: queue-name length {nlen}")
    name = _recv_exact(sock, nlen)
    (plen,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if plen == _TIMEOUT_SENTINEL:
        return op, name, None
    if plen > MAX_FRAME_BYTES:
        raise ConnectionError(f"corrupt frame: payload length {plen}")
    return op, name, _recv_exact(sock, plen)


#: control queue: a GET on this name returns the broker's stats frame
#: (JSON) at once instead of popping a message
BROKER_STATS_QUEUE = "__broker__.stats"

#: read chunk per readable event
_RECV_CHUNK = 1 << 18


def queue_family(queue: str) -> str:
    """The family of a queue name: ``intermediate``, ``gradient``,
    ``rpc``, ``reply`` (the text before ``_queue``, else before the
    first ``_``)."""
    head = queue.split("_queue", 1)[0]
    return head if head != queue else queue.split("_", 1)[0]


class _ParkedGet:
    """One blocked GET continuation, parked on the event loop (a
    long-poll timer, not a blocked thread)."""

    __slots__ = ("conn", "queue", "deadline", "done")

    def __init__(self, conn: "_BrokerConn", queue: str,
                 deadline: float | None):
        self.conn = conn
        self.queue = queue
        self.deadline = deadline
        self.done = False


class _BrokerConn:
    """Per-connection state: incremental frame parser + buffered
    writer.  Never blocks the loop — partial reads accumulate in
    ``rbuf``, partial writes drain from ``wbuf`` on writable events."""

    __slots__ = ("sock", "rbuf", "wbuf", "woff", "wbytes", "paused",
                 "parked", "closed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf: collections.deque = collections.deque()
        self.woff = 0          # bytes of wbuf[0] already sent
        self.wbytes = 0        # total bytes buffered
        self.paused = False    # read interest dropped (backpressure)
        self.parked: list[_ParkedGet] = []
        self.closed = False


class Broker:
    """Event-loop TCP message broker: one ``selectors``-driven thread
    whatever the connection count.

    * blocked GETs are parked continuations with a deadline on the
      loop's timer heap — a publish to the queue completes the oldest
      parked GET directly, a deadline sends the timeout reply;
    * reads and writes are non-blocking and buffered per connection; a
      connection whose outbound buffer exceeds :attr:`SEND_QUEUE_CAP`
      stops being read until it drains below :attr:`SEND_QUEUE_RESUME`
      (backpressure instead of unbounded broker-side buffering);
    * a GET on :data:`BROKER_STATS_QUEUE` answers at once with the
      broker's JSON stats frame (:meth:`stats`);
    * :meth:`close` shuts every connection, so a blocked getter sees
      EOF.
    """

    #: outbound bytes buffered for one connection before the loop stops
    #: reading from it; resumes below the low-water mark
    SEND_QUEUE_CAP = 64 << 20
    SEND_QUEUE_RESUME = 8 << 20

    #: seconds a fixed port's bind is retried for
    BIND_TIMEOUT_S = 10.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # a restarted broker re-binds the same port while the previous
        # incarnation's connections may still be draining: retry briefly
        deadline = time.monotonic() + self.BIND_TIMEOUT_S
        while True:
            try:
                self._sock = socket.create_server((host, port))
                break
            except OSError:
                if port == 0 or time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)
        self.host, self.port = self._sock.getsockname()[:2]
        self.shard_id = f"broker@{self.host}:{self.port}"
        self._sock.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, None)
        # wake pipe: close() (any thread) writes one byte so the loop
        # notices shutdown without waiting out its select timeout
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._queues: dict[str, collections.deque] = {}
        self._parked: dict[str, collections.deque] = {}
        self._timers: list = []     # heap of (deadline, seq, _ParkedGet)
        self._tseq = 0
        self._conns: dict[int, _BrokerConn] = {}
        self._t0 = time.monotonic()
        self._stats = collections.Counter()
        self._depth = 0             # total stored messages
        self._depth_hwm = 0
        self._stored_bytes = 0      # payload bytes held in the queues
        self._stored_hwm = 0
        # payload bytes published / delivered, by queue family
        self._fam_in = collections.Counter()
        self._fam_out = collections.Counter()
        self._running = True
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"broker-{self.port}")
        self._thread.start()

    # -- event loop ----------------------------------------------------------

    def _loop(self) -> None:
        try:
            while self._running:
                timeout = 1.0
                if self._timers:
                    timeout = max(0.0, min(
                        timeout, self._timers[0][0] - time.monotonic()))
                for key, ready in self._sel.select(timeout):
                    if key.data is None:
                        self._accept()
                    elif key.data == "wake":
                        try:
                            self._wake_r.recv(64)
                        except OSError:
                            pass
                    else:
                        # the ready mask, not key.events (the registered
                        # interest): a read-ready wakeup must not burn a
                        # send syscall and vice versa
                        self._service(key.data, ready)
                self._fire_timers()
        finally:
            self._teardown()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._sock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            _no_delay(sock)
            conn = _BrokerConn(sock)
            self._conns[sock.fileno()] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _interest(self, conn: _BrokerConn) -> None:
        events = 0
        if not conn.paused:
            events |= selectors.EVENT_READ
        if conn.wbuf:
            events |= selectors.EVENT_WRITE
        try:
            if events:
                self._sel.modify(conn.sock, events, conn)
            else:
                # nothing to do for this conn right now: stay registered
                # read-only so a peer close still surfaces
                self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
                conn.paused = False
        except (KeyError, ValueError, OSError):
            pass

    def _service(self, conn: _BrokerConn, events: int) -> None:
        if conn.closed:
            return
        if events & selectors.EVENT_WRITE:
            self._flush(conn)
        if conn.closed or conn.paused:
            return
        if events & selectors.EVENT_READ:
            try:
                chunk = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(conn)
                return
            if not chunk:
                self._drop(conn)
                return
            self._stats["bytes_in"] += len(chunk)
            conn.rbuf += chunk
            self._parse(conn)

    def _parse(self, conn: _BrokerConn) -> None:
        buf = conn.rbuf
        off = 0
        while not conn.closed:
            if len(buf) - off < 5:
                break
            op = buf[off:off + 1]
            (nlen,) = struct.unpack_from(">I", buf, off + 1)
            if nlen > MAX_NAME_BYTES:
                self._drop(conn)
                return
            if len(buf) - off < 5 + nlen + 8:
                break
            name = bytes(buf[off + 5:off + 5 + nlen])
            (plen,) = struct.unpack_from(">Q", buf, off + 5 + nlen)
            if plen > MAX_FRAME_BYTES:
                # corrupt length prefix: fail the connection, never the
                # multi-terabyte allocation
                self._drop(conn)
                return
            if len(buf) - off < 13 + nlen + plen:
                break
            payload = bytes(buf[off + 13 + nlen:off + 13 + nlen + plen])
            off += 13 + nlen + plen
            self._handle(conn, bytes(op), name, payload)
        if off:
            del conn.rbuf[:off]

    def _handle(self, conn: _BrokerConn, op: bytes, name: bytes,
                payload: bytes) -> None:
        try:
            queue = name.decode()
        except UnicodeDecodeError:
            self._drop(conn)
            return
        if op == _OP_PUB:
            self._stats["published"] += 1
            self._publish(queue, payload)
        elif op == _OP_GET:
            if len(payload) != 8:
                self._drop(conn)
                return
            (ms,) = struct.unpack(">Q", payload)
            self._get(conn, queue, ms)
        elif op == _OP_PURGE:
            self._stats["purges"] += 1
            self._purge(None if not payload
                        else payload.decode().split(","))
        else:
            self._drop(conn)

    # -- queue machinery -----------------------------------------------------

    def _publish(self, queue: str, payload: bytes) -> None:
        self._fam_in[queue_family(queue)] += len(payload)
        parked = self._parked.get(queue)
        while parked:
            pg = parked.popleft()
            if not parked:
                del self._parked[queue]
            if pg.done or pg.conn.closed:
                continue
            pg.done = True
            self._deliver(pg.conn, queue, payload)
            return
        q = self._queues.get(queue)
        if q is None:
            q = self._queues[queue] = collections.deque()
        q.append(payload)
        self._depth += 1
        self._depth_hwm = max(self._depth_hwm, self._depth)
        self._stored_bytes += len(payload)
        self._stored_hwm = max(self._stored_hwm, self._stored_bytes)

    def _get(self, conn: _BrokerConn, queue: str, ms: int) -> None:
        if queue == BROKER_STATS_QUEUE:
            self._reply(conn, json.dumps(self.stats()).encode())
            return
        q = self._queues.get(queue)
        if q:
            payload = q.popleft()
            if not q:
                del self._queues[queue]
            self._depth -= 1
            self._stored_bytes -= len(payload)
            self._deliver(conn, queue, payload)
            return
        deadline = None if ms == 0 else time.monotonic() + ms / 1000.0
        pg = _ParkedGet(conn, queue, deadline)
        self._parked.setdefault(queue, collections.deque()).append(pg)
        conn.parked.append(pg)
        if len(conn.parked) > 32:
            # the list exists so _drop can cancel a dying connection's
            # continuations; compact completed ones as we go or a
            # long-poll loop grows it one entry per GET forever
            conn.parked = [p for p in conn.parked if not p.done]
        if deadline is not None:
            self._tseq += 1
            heapq.heappush(self._timers, (deadline, self._tseq, pg))

    def _fire_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, pg = heapq.heappop(self._timers)
            if pg.done or pg.conn.closed:
                continue
            pg.done = True
            self._stats["get_timeouts"] += 1
            self._enqueue(pg.conn, [_frame_header(_OP_REPLY, b"",
                                                  _TIMEOUT_SENTINEL)])
            # trim satisfied/expired heads so a poll-heavy queue's
            # parked deque cannot grow with dead continuations
            dq = self._parked.get(pg.queue)
            while dq and (dq[0].done or dq[0].conn.closed):
                dq.popleft()
            if dq is not None and not dq:
                self._parked.pop(pg.queue, None)

    def _purge(self, queues: list[str] | None) -> None:
        if queues is None:
            self._queues.clear()
            self._depth = 0
            self._stored_bytes = 0
        else:
            for q in queues:
                gone = self._queues.pop(q, None)
                if gone:
                    self._depth -= len(gone)
                    self._stored_bytes -= sum(len(p) for p in gone)

    # -- buffered writes -----------------------------------------------------

    def _deliver(self, conn: _BrokerConn, queue: str,
                 payload: bytes) -> None:
        self._fam_out[queue_family(queue)] += len(payload)
        self._reply(conn, payload)

    def _reply(self, conn: _BrokerConn, payload: bytes) -> None:
        self._stats["delivered"] += 1
        head = _frame_header(_OP_REPLY, b"", len(payload))
        # a big payload is sent from where it lies, never copied into a
        # joined frame
        self._enqueue(conn, [head + payload] if len(payload) < _JOIN_BELOW
                      else [head, payload])

    def _enqueue(self, conn: _BrokerConn, parts: list) -> None:
        if conn.closed:
            return
        for p in parts:
            if p:
                conn.wbuf.append(p)
                conn.wbytes += len(p)
        self._flush(conn)
        if conn.closed:
            return
        if conn.wbytes > self.SEND_QUEUE_CAP and not conn.paused:
            # backpressure: stop reading from a connection we cannot
            # drain — its GETs/publishes wait in its kernel buffers, not
            # in broker heap
            conn.paused = True
            self._stats["backpressure_pauses"] += 1
        self._interest(conn)

    def _flush(self, conn: _BrokerConn) -> None:
        try:
            while conn.wbuf:
                head = conn.wbuf[0]
                sent = conn.sock.send(memoryview(head)[conn.woff:])
                if sent <= 0:
                    break
                self._stats["bytes_out"] += sent
                conn.woff += sent
                conn.wbytes -= sent
                if conn.woff >= len(head):
                    conn.wbuf.popleft()
                    conn.woff = 0
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(conn)
            return
        if conn.paused and conn.wbytes < self.SEND_QUEUE_RESUME:
            conn.paused = False
        self._interest(conn)

    def _drop(self, conn: _BrokerConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        for pg in conn.parked:
            pg.done = True
        conn.parked.clear()
        self._conns.pop(conn.sock.fileno(), None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- stats + lifecycle ---------------------------------------------------

    def stats(self) -> dict:
        """The broker's self-telemetry frame (also served on
        :data:`BROKER_STATS_QUEUE`).  Loop-thread state read without a
        lock: every field is a single int/str read, at worst one event
        stale.  The reference's keys, plus the payload bytes the queues
        hold now (``stored_bytes``) and at most (``stored_bytes_hwm``),
        and the payload bytes published and delivered by queue family
        (:func:`queue_family`)."""
        parked = sum(sum(1 for pg in d if not pg.done)
                     for d in self._parked.values())
        return {
            "shard": self.shard_id, "host": self.host,
            "port": self.port, "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "conns": len(self._conns),
            "queues": len(self._queues),
            "depth": self._depth, "depth_hwm": self._depth_hwm,
            "parked_gets": parked,
            "threads": 1,
            "bytes_in": self._stats["bytes_in"],
            "bytes_out": self._stats["bytes_out"],
            "published": self._stats["published"],
            "delivered": self._stats["delivered"],
            "get_timeouts": self._stats["get_timeouts"],
            "purges": self._stats["purges"],
            "backpressure_pauses": self._stats["backpressure_pauses"],
            "stored_bytes": self._stored_bytes,
            "stored_bytes_hwm": self._stored_hwm,
            "published_bytes_by_family": dict(self._fam_in),
            "delivered_bytes_by_family": dict(self._fam_out),
        }

    def _teardown(self) -> None:
        # shutdown() before close(), listener and every connection: a
        # blocked client recv must see EOF, and the port must actually
        # be released so a same-port restart can bind it
        for s in [self._sock] + [c.sock for c in self._conns.values()]:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self._conns.clear()
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        self._closed.set()

    def close(self):
        self._running = False
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=10.0)
        self._closed.wait(timeout=10.0)


class _TicketLock:
    """A FIFO lock: threads enter in the order they asked.  A plain
    lock lets a thread that releases and at once re-acquires it (a
    sliced blocking get) starve another that waits (the sender's
    publish)."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._next = 0      # next ticket to hand out
        self._serving = 0   # ticket that holds the lock

    def __enter__(self):
        with self._cv:
            ticket = self._next
            self._next += 1
            self._cv.wait_for(lambda: self._serving == ticket)

    def __exit__(self, *exc):
        with self._cv:
            self._serving += 1
            self._cv.notify_all()


class TcpTransport(Transport):
    """Client of a :class:`Broker`: one socket behind a lock, so a
    blocking ``get`` holds the socket until it returns (the async layer
    slices such gets and gives receive prefetch its own connection).

    ``get`` returns a ``bytearray`` for a payload of 64 KiB or more (it
    is read in place, not copied into a ``bytes``).

    A mid-run ``ConnectionError`` (broker restart, transient reset) does
    not kill the process: every op reconnects with capped exponential
    backoff and retries, up to ``reconnect_timeout`` seconds per outage.
    Messages queued inside a restarted broker are gone."""

    def __init__(self, host: str, port: int, connect_timeout: float = 30.0,
                 reconnect_timeout: float = 15.0, faults=None):
        super().__init__()
        self.host, self.port = host, port
        self._reconnect_timeout = reconnect_timeout
        self._closed = False
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        # the broker may still be coming up (simultaneous launch): retry
        # with backoff instead of failing the whole process
        self._sock = self._connect(connect_timeout)
        # serialises the single socket: blocking I/O (and the reconnect
        # backoff) under it is this lock's purpose
        self._lock = _TicketLock()

    def _connect(self, timeout: float) -> socket.socket:
        deadline = time.monotonic() + timeout
        delay = 0.1
        while True:
            if self._closed:
                raise ConnectionError("transport closed")
            try:
                sock = socket.create_connection((self.host, self.port),
                                                timeout=10.0)
                sock.settimeout(None)
                _no_delay(sock)
                return sock
            except (ConnectionRefusedError, ConnectionResetError,
                    TimeoutError):
                # only not-up-yet errors; bad hostnames etc. fail fast
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)   # capped exponential backoff

    def _reconnect(self) -> None:
        """Steady-state reconnect: the broker died under us."""
        try:
            self._sock.close()
        except OSError:
            pass
        self.faults.inc("reconnects")
        self._sock = self._connect(self._reconnect_timeout)

    _MAX_OP_RETRIES = 5

    def _retry(self, op):
        """Run ``op`` (which uses ``self._sock``); on a connection-level
        failure reconnect and re-issue.  Caller holds ``self._lock``.
        Bounded per op: after ``_MAX_OP_RETRIES`` consecutive failures
        with successful reconnects the error surfaces to the caller."""
        attempts = 0
        while True:
            try:
                return op()
            except (ConnectionError, OSError):
                # a close() from our own side must still raise out
                if self._closed:
                    raise
                attempts += 1
                if attempts > self._MAX_OP_RETRIES:
                    raise
                self._reconnect()

    def publish(self, queue: str, payload: bytes) -> None:
        # fail fast on a frame the broker deterministically rejects:
        # _retry cannot tell a cap rejection from an outage
        if len(payload) > MAX_FRAME_BYTES:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds the "
                f"{MAX_FRAME_BYTES}-byte frame cap")
        self._count(queue, payload)
        with self._lock:
            self._retry(lambda: _send_frame(self._sock, _OP_PUB,
                                            queue.encode(), payload))

    def get(self, queue: str, timeout: float | None = None) -> bytes | None:
        ms = 0 if timeout is None else max(1, int(timeout * 1000))

        def once():
            _send_frame(self._sock, _OP_GET, queue.encode(),
                        struct.pack(">Q", ms))
            op, _, payload = _recv_frame(self._sock)
            if op != _OP_REPLY:
                raise ConnectionError(f"unexpected broker reply op {op!r}")
            return payload  # None on timeout

        with self._lock:
            # a reconnect mid-get re-issues the request: the original
            # GET (and any reply in flight) died with the old socket
            return self._retry(once)

    def purge(self, queues: Iterable[str] | None = None) -> None:
        payload = b"" if queues is None else ",".join(queues).encode()
        with self._lock:
            self._retry(lambda: _send_frame(self._sock, _OP_PURGE, b"",
                                            payload))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# async data plane: background sender + receive prefetch
# --------------------------------------------------------------------------

class AsyncTransport(Transport):
    """Outermost wrapper that takes serialisation and socket I/O off the
    training thread.

    * **Sender**: ``publish`` enqueues into a bounded FIFO (``send_depth``)
      drained by one background thread, so the hot loop never blocks on
      the wire.  The payload may be a callable returning bytes or a list
      of frame parts: the thunk (device-to-host fetch, codec, encode)
      then runs on the sender thread.  One thread drains the queue, so
      per-queue publish order is exactly the enqueue order.
    * **Prefetch**: queues matching :attr:`PREFETCH_QUEUES` get a lazy
      background prefetcher that pulls up to ``prefetch_depth`` frames
      ahead of the consumer, from its own connection when
      ``recv_factory`` makes one.
      The depth is small on purpose: shared per-cluster queues balance
      load across same-stage clients, and a deep prefetch would steal
      peers' work.
    * ``slice_gets`` bounds how long a pass-through blocking ``get`` may
      hold a lock-serialised inner transport (one TCP socket), so the
      sender thread's publishes interleave with the wait.

    A sender-thread failure is re-raised on the next ``publish`` or
    ``get``.  Counters, cumulative: :attr:`send_hwm`, the deepest the
    send FIFO has been; :attr:`publish_wait_s`, the seconds ``publish``
    callers waited for room in it; :attr:`thunk_s`, the sender's seconds
    in thunks; :attr:`send_s`, its seconds in the inner transport's
    ``publish`` (on TCP: the socket)."""

    deferred = True   # publish() accepts thunks / frame-part lists

    #: the data-plane queues that get a prefetcher
    PREFETCH_QUEUES = ("intermediate_queue*", "gradient_queue*")

    def __init__(self, inner: Transport, send_depth: int = 8,
                 prefetch_depth: int = 2, recv_factory=None,
                 slice_gets: bool = False, faults=None):
        super().__init__()
        self.inner = inner
        self._send_depth = max(1, send_depth)
        self._prefetch_depth = max(1, prefetch_depth)
        self._recv_factory = recv_factory
        self._slice_gets = slice_gets
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        self.send_hwm = 0
        self.publish_wait_s = self.thunk_s = self.send_s = 0.0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._sendq: collections.deque = collections.deque()
        self._inflight = 0      # popped by the sender, not yet published
        self._error: BaseException | None = None
        self._closed = threading.Event()
        self._prefetchers: dict[str, _Prefetcher] = {}
        self._sender = threading.Thread(target=self._send_loop,
                                        daemon=True, name="async-sender")
        self._sender.start()

    # -- sender ------------------------------------------------------------

    def _check_error(self):
        err = self._error
        if err is not None:
            raise err

    def publish(self, queue: str, payload) -> None:
        with self._cv:
            self._check_error()
            t0 = time.perf_counter()
            self._cv.wait_for(lambda: len(self._sendq) < self._send_depth
                              or self._error or self._closed.is_set())
            self.publish_wait_s += time.perf_counter() - t0
            self._check_error()
            if self._closed.is_set():
                raise QueueClosed(queue)
            self._sendq.append((queue, payload))
            self.send_hwm = max(self.send_hwm, len(self._sendq))
            self._cv.notify_all()

    def _send_loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._sendq or self._closed.is_set())
                if not self._sendq:
                    return   # closed and drained
                queue, payload = self._sendq.popleft()
                self._inflight += 1   # flush must see this frame too
                self._cv.notify_all()
            try:
                t0 = time.perf_counter()
                if callable(payload):
                    payload = payload()
                t1 = time.perf_counter()
                parts = (payload if isinstance(payload, (list, tuple))
                         else (payload,))
                for part in parts:
                    self.inner.publish(queue, part)
                self.thunk_s += t1 - t0
                self.send_s += time.perf_counter() - t1
            except BaseException as e:  # noqa: BLE001 — surfaced to the
                # training thread; the sender stops like a dead process
                with self._cv:
                    self._error = e
                    self._inflight -= 1
                    self._cv.notify_all()
                self.faults.inc("async_send_errors")
                return
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def flush(self, timeout: float | None = 30.0) -> bool:
        """Block until every enqueued frame reached the inner transport
        (or the sender died).  False on timeout.  Covers the frame the
        sender has popped but not yet published."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            def drained():
                return ((not self._sendq and not self._inflight)
                        or self._error is not None)
            remain = (None if deadline is None
                      else max(0.0, deadline - time.monotonic()))
            self._cv.wait_for(drained, remain)
            return not self._sendq and not self._inflight

    # -- receive -----------------------------------------------------------

    def _match(self, queue: str) -> bool:
        return any(fnmatch.fnmatchcase(queue, p)
                   for p in self.PREFETCH_QUEUES)

    def _prefetcher(self, queue: str) -> "_Prefetcher":
        with self._lock:
            pf = self._prefetchers.get(queue)
            if pf is None:
                src = (self._recv_factory()
                       if self._recv_factory is not None else self.inner)
                pf = _Prefetcher(queue, src,
                                 own_src=self._recv_factory is not None,
                                 depth=self._prefetch_depth,
                                 faults=self.faults)
                self._prefetchers[queue] = pf
            return pf

    def get(self, queue: str, timeout: float | None = None) -> bytes | None:
        self._check_error()
        if self._match(queue):
            return self._prefetcher(queue).pop(timeout)
        if not self._slice_gets or (timeout is not None and timeout <= 0.1):
            return self.inner.get(queue, timeout)
        # lock-serialised inner (one TCP socket): bounded slices let the
        # sender thread's publishes interleave with this wait
        deadline = None if timeout is None else time.monotonic() + timeout
        raw = None
        while raw is None:
            self._check_error()
            remain = (None if deadline is None
                      else deadline - time.monotonic())
            if remain is not None and remain <= 0:
                break
            raw = self.inner.get(
                queue, 0.1 if remain is None else min(remain, 0.1))
        return raw

    # -- plumbing ----------------------------------------------------------

    def purge(self, queues: Iterable[str] | None = None) -> None:
        self.inner.purge(queues)
        qs = None if queues is None else set(queues)
        with self._lock:
            pfs = list(self._prefetchers.items())
        for q, pf in pfs:
            if qs is None or q in qs:
                pf.clear()
        with self._cv:
            if qs is None:
                self._sendq.clear()
            else:
                self._sendq = collections.deque(
                    e for e in self._sendq if e[0] not in qs)
            self._cv.notify_all()

    def bytes_out_snapshot(self) -> dict:
        return self.inner.bytes_out_snapshot()

    def stop(self, close_inner: bool = True) -> None:
        self.flush(timeout=60.0)
        self._closed.set()
        with self._cv:
            self._cv.notify_all()
        self._sender.join(timeout=5.0)
        with self._lock:
            pfs = list(self._prefetchers.values())
            self._prefetchers.clear()
        for pf in pfs:
            pf.stop()
        if close_inner:
            self.inner.close()

    def close(self) -> None:
        self.stop(close_inner=True)


class _Prefetcher:
    """One queue's bounded look-ahead buffer + puller thread."""

    def __init__(self, queue: str, src: Transport, own_src: bool,
                 depth: int, faults):
        self.queue = queue
        self.src = src
        self._own_src = own_src
        self._depth = depth
        self._faults = faults
        self._buf: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"prefetch-{queue}")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: len(self._buf) < self._depth
                                    or self._closed)
                if self._closed:
                    return
            try:
                raw = self.src.get(self.queue, timeout=0.05)
            except QueueClosed:
                with self._cond:
                    self._closed = True
                    self._cond.notify_all()
                return
            except Exception:  # noqa: BLE001 — a transient transport
                # error must not kill the only thread filling the buffer
                if self._closed:
                    return
                self._faults.inc("prefetch_errors")
                time.sleep(0.1)
                continue
            if raw is not None:
                with self._cond:
                    self._buf.append(raw)
                    self._cond.notify_all()

    def pop(self, timeout: float | None) -> bytes | None:
        with self._cond:
            self._cond.wait_for(lambda: self._buf or self._closed, timeout)
            if self._buf:
                raw = self._buf.popleft()
                self._cond.notify_all()
                return raw
            if self._closed:
                raise QueueClosed(self.queue)
            return None

    def clear(self) -> None:
        with self._cond:
            self._buf.clear()
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        if self._own_src:
            try:
                self.src.close()
            except (QueueClosed, ConnectionError, OSError):
                pass


def make_transport(kind: str = "inproc", host: str = "127.0.0.1",
                   port: int = 5672, faults=None) -> Transport:
    """A fresh transport of ``kind``: in-process queues, or one
    connection to the TCP broker at ``host:port``."""
    if kind == "inproc":
        return InProcTransport()
    if kind == "tcp":
        return TcpTransport(host, port, faults=faults)
    raise ValueError(f"unknown transport kind {kind!r}; use inproc or tcp")
