"""``python -m split_learning_torch.broker`` — the standalone message
broker of the protocol deployment.

Port of the JAX package's ``broker.py`` ``main`` for one broker: it
hosts the Python event-loop :class:`~split_learning_torch.runtime.bus.
Broker` (one ``selectors`` thread whatever the connection count) on
``--host``/``--port`` until SIGTERM or SIGINT, then exits 0.  It
touches no GPU.  ``--port 0`` binds a free port; the first line printed
names the port bound.

Not ported yet: the native C++ broker (the JAX package's
``native/src/broker.cpp``), the sharded plane (``--shards``), and
``--max-frame-gb`` and ``--journal-dir``.

Usage::

    python -m split_learning_torch.broker --host 127.0.0.1 --port 5672
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from split_learning_torch.runtime.bus import Broker


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Split-learning TCP broker (Python event loop).")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5672,
                    help="port to bind (0 = any free port)")
    args = ap.parse_args(argv)
    broker = Broker(args.host, args.port)
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
