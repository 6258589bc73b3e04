"""``python -m split_learning_torch.server`` — the protocol server
process.

Port of the JAX package's ``runtime/server.py`` ``main``: it reads
``--config``, builds its transport stack from the config
(``transport.kind: tcp`` connects to the broker at
``transport.host``/``transport.port``, or to the plane of
``broker.shards`` brokers on the ports from there up), waits for every
configured client to register, runs the round loop and sends STOP.
``--broker`` hosts the event-loop broker in this process as well (one
per shard).  The server runs on
the card; ``--device cpu`` asks for the CPU, and without a GPU and
without it the process fails at once.  With ``observability.http-port``
set it logs the telemetry exporter's URL (``/metrics`` and ``/fleet``,
for ``tools/sl_top.py --url``).

Usage::

    python -m split_learning_torch.broker --port 5672 &
    python -m split_learning_torch.server --config config.yaml
"""

from __future__ import annotations

import argparse

import torch

from split_learning_torch.config import from_yaml
from split_learning_torch.device import resolve_device
from split_learning_torch.runtime.bus import Broker
from split_learning_torch.runtime.server import ProtocolServer


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Split-learning protocol server (reference server.py "
                    "parity).")
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--broker", action="store_true",
                    help="also host the TCP broker in this process")
    ap.add_argument("--client_timeout", type=float, default=600.0)
    ap.add_argument("--ready_timeout", type=float, default=None,
                    help="READY barrier deadline (default: "
                         "--client_timeout)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = from_yaml(args.config)
    # float32 products in full float32, as run_local computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    brokers = []
    if args.broker and cfg.transport.kind == "tcp":
        # one event loop per shard: the one-command deployment keeps
        # working with broker.shards > 1 (``python -m
        # split_learning_torch.broker --shards N`` runs them as processes)
        brokers = [Broker(cfg.transport.host, cfg.transport.port + i,
                          shard_id=f"shard_{i}")
                   for i in range(cfg.broker.shards)]
    try:
        server = ProtocolServer(cfg, client_timeout=args.client_timeout,
                                ready_timeout=args.ready_timeout,
                                device=device)
        result = server.serve()
        for rec in result.history:
            acc = (f" val_acc={rec.val_accuracy:.4f}"
                   if rec.val_accuracy is not None else "")
            print(f"round {rec.round_idx}: ok={rec.ok} "
                  f"samples={rec.num_samples} val_loss={rec.val_loss}{acc}")
    finally:
        for broker in brokers:
            broker.close()
    return server


if __name__ == "__main__":
    main()
