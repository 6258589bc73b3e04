"""``python -m split_learning_torch.client`` — one protocol client
process.

Port of the JAX package's ``runtime/client.py`` ``main``: it reads
``--config``, builds its transport stack from the config, registers for
stage ``--layer_id`` and trains whatever shard each START hands it until
STOP.  The client runs on the card; ``--device cpu`` asks for the CPU,
and without a GPU and without it the process fails at once.

Usage::

    python -m split_learning_torch.client --config config.yaml --layer_id 1
"""

from __future__ import annotations

import argparse
import json
import uuid

import torch

from split_learning_torch.config import from_yaml
from split_learning_torch.device import resolve_device
from split_learning_torch.runtime.client import ProtocolClient


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Split-learning protocol client (reference client.py "
                    "parity).")
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--layer_id", type=int, required=True,
                    help="1-based stage index")
    ap.add_argument("--client_id", default=None)
    ap.add_argument("--cluster", type=int, default=None)
    ap.add_argument("--profile", default=None,
                    help="path to profiling.json (optional)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = from_yaml(args.config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = None
    if args.profile:
        with open(args.profile) as f:
            profile = json.load(f)
    client_id = (args.client_id
                 or f"client_{args.layer_id}_{uuid.uuid4().hex[:6]}")
    client = ProtocolClient(cfg, client_id, args.layer_id,
                            cluster=args.cluster, profile=profile,
                            device=device)
    client.run()
    return client


if __name__ == "__main__":
    main()
