"""``python -m split_learning_torch.broker`` — the standalone message
broker of the protocol deployment.

Port of the JAX package's ``broker.py``.  One broker: the Python
event-loop :class:`~split_learning_torch.runtime.bus.Broker` (one
``selectors`` thread whatever the connection count) on
``--host``/``--port`` until SIGTERM or SIGINT, then exit 0.  ``--port
0`` binds a free port; the first line printed names the port bound.  It
touches no GPU.

``--shards N`` hosts the sharded broker plane (``broker.shards``): this
process supervises N shard processes on ports ``--port ..
--port+N-1``, each its own event loop, and prints one line per shard.
Participants map every queue to its owning shard with ``shard_for``.
The supervisor forwards SIGTERM and SIGINT and exits when told to.  It
never restarts a dead shard: a shard's death is a fault that the
transport (per-shard reconnect and the reliable layer's redelivery) is
there to survive, so it reports the death once, with the command line
that restarts that shard on its port, and keeps the others up.

``--max-frame-gb`` caps one frame's payload (default 8 GiB): a broker
drops the connection that sends a longer one and counts it
``oversize_frames`` in its stats frame.  ``--python`` is accepted for
the JAX package's command lines and changes nothing: the port has only
the Python broker.

Not ported: the native C++ broker (the JAX package's
``native/src/broker.cpp``) and ``--journal-dir`` (the span journal and
the flight recorder).

Usage::

    python -m split_learning_torch.broker --host 127.0.0.1 --port 5672
    python -m split_learning_torch.broker --shards 2 --port 24000
"""

from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import threading
import time


def shard_command(host: str, port: int, shard_index: int = 0,
                  max_frame_gb: float | None = None) -> list[str]:
    """The command line of one broker shard bound to ``host:port``."""
    cmd = [sys.executable, "-m", "split_learning_torch.broker",
           "--host", host, "--port", str(port),
           "--shard-id", f"shard_{shard_index}@{host}:{port}"]
    if max_frame_gb is not None:
        cmd += ["--max-frame-gb", str(max_frame_gb)]
    return cmd


def spawn_shard(host: str, port: int, *, shard_index: int = 0,
                max_frame_gb: float | None = None) -> subprocess.Popen:
    """Start one broker shard process on ``host:port``, as the
    ``--shards`` supervisor starts each of its shards."""
    return subprocess.Popen(
        shard_command(host, port, shard_index, max_frame_gb))


def _supervise(args) -> int:
    """Host ``args.shards`` shard processes.  A shard that dies on its
    own is reported once, with its restart command, and remembered as a
    non-zero exit code while the others keep running; an operator's
    signal, or the death of the last shard, ends the plane.  Returns 0
    when told to stop with every shard alive, else 1."""
    stop = {"sig": None}

    def on_sig(signum, _frame):
        stop["sig"] = signum

    signal.signal(signal.SIGTERM, on_sig)
    signal.signal(signal.SIGINT, on_sig)
    procs = [spawn_shard(args.host, args.port + i, shard_index=i,
                         max_frame_gb=args.max_frame_gb)
             for i in range(args.shards)]
    for i in range(args.shards):
        print(f"broker shard {i}/{args.shards} on "
              f"{args.host}:{args.port + i}", flush=True)
    rc = 0
    dead: set = set()
    try:
        while stop["sig"] is None:
            for i, p in enumerate(procs):
                code = p.poll()
                if code is not None and i not in dead:
                    dead.add(i)
                    restart = " ".join(shard_command(
                        args.host, args.port + i, i, args.max_frame_gb))
                    print(f"broker shard {i} exited rc={code} "
                          f"(restart: {restart})", file=sys.stderr,
                          flush=True)
                    rc = 1
            if len(dead) == args.shards:
                print("all broker shards exited; stopping",
                      file=sys.stderr, flush=True)
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Split-learning TCP broker (Python event loop).")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5672,
                    help="port to bind (0 = any free port); with "
                         "--shards, the first shard's")
    ap.add_argument("--shards", type=int, default=1,
                    help="host a sharded broker plane: N shard processes "
                         "on ports --port..--port+N-1 (broker.shards in "
                         "the config); each queue is owned by one shard "
                         "(shard_for)")
    ap.add_argument("--shard-id", default=None,
                    help="this broker's identity in its stats frame (set "
                         "by the --shards supervisor)")
    ap.add_argument("--max-frame-gb", type=float, default=None,
                    help="one frame's payload cap (default 8 GiB): a "
                         "longer frame fails its connection and counts "
                         "oversize_frames; publishers check their own "
                         "process's cap, so lower it on both sides")
    ap.add_argument("--python", action="store_true",
                    help="accepted for the JAX package's command lines; "
                         "changes nothing (the port has only the Python "
                         "broker)")
    args = ap.parse_args(argv)

    if args.shards > 1:
        if args.port == 0:
            ap.error("--shards needs a fixed --port (the shards bind "
                     "consecutive ports from it)")
        return _supervise(args)

    from split_learning_torch.runtime import bus
    if args.max_frame_gb is not None:
        bus.MAX_FRAME_BYTES = int(args.max_frame_gb * (1 << 30))
    broker = bus.Broker(args.host, args.port, shard_id=args.shard_id)
    print(f"python broker on {broker.host}:{broker.port} "
          "(event loop, 1 thread)", flush=True)
    stop = threading.Event()
    # SIGTERM (kill, process managers) and SIGINT end the process cleanly
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        while not stop.wait(3600):
            pass
    finally:
        broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
