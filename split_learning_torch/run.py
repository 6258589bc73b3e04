"""Single-process training cell: the whole deployment on one device.

Port of the JAX package's ``run.py``: logical clients are synthesized
from the config's per-stage counts, planned into clusters, and trained
by the in-process context — no transport in the hot path.  It runs on
the CUDA device unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises.

Usage (the default config is ``config.yaml``: VGG16/CIFAR10 cut at
layer 7)::

    python -m split_learning_torch.run
    python -m split_learning_torch.run --config configs/baseline5.yaml
"""

from __future__ import annotations

import argparse

import torch

from split_learning_torch.config import Config, from_yaml
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger
from split_learning_torch.runtime.loop import TrainResult, run_training
from split_learning_torch.runtime.plan import Registration, plan_clusters


def synthesize_registrations(cfg: Config,
                             profiles: dict | None = None) -> list:
    """Logical clients for in-process mode: ``client_{stage}_{i}`` per
    the config's per-stage counts."""
    regs = []
    for stage, count in enumerate(cfg.clients, start=1):
        for i in range(count):
            cid = f"client_{stage}_{i}"
            regs.append(Registration(
                client_id=cid, stage=stage,
                profile=(profiles or {}).get(cid)))
    return regs


def run_local(cfg: Config, device=None,
              logger: Logger | None = None,
              profiles: dict | None = None) -> TrainResult:
    """Plan and train ``cfg`` in this process on ``device`` (CUDA when
    ``None``)."""
    # float32 products in full float32, as the reference computes them
    # (bf16 configs cast every product's inputs to bf16 anyway)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = TorchContext(cfg, device=device)
    logger = logger or Logger.for_run(cfg, "server", console=True)
    plans = plan_clusters(cfg, synthesize_registrations(cfg, profiles))
    try:
        return run_training(cfg, ctx, plans, logger)
    finally:
        ctx.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run a full split-learning training cell in-process.")
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    cfg = from_yaml(args.config)
    result = run_local(cfg, device=args.device)
    for rec in result.history:
        acc = (f" val_acc={rec.val_accuracy:.4f}"
               if rec.val_accuracy is not None else "")
        print(f"round {rec.round_idx}: ok={rec.ok} "
              f"samples={rec.num_samples}{acc}")


if __name__ == "__main__":
    main()
