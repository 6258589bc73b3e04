"""The global round loop: train → aggregate → validate → checkpoint.

Port of the JAX package's ``runtime/loop.py``: after each round's updates
are aggregated the full model is validated; a NaN round logs "Training
failed!" and is not checkpointed; an exploded validation loss rolls back
to the last good weights; otherwise the checkpoint is (over)written by a
one-slot background writer and the next round begins; resume loads the
checkpoint and continues.

Left out so far (listed in ROADMAP.md): the span tracer, the per-round
MemoryWatch and kind=perf records, the on-demand profiler capture, the
blackbox recorder, the elastic membership refresh and the scheduler
hook.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Any

from split_learning_torch.config import Config
from split_learning_torch.runtime.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from split_learning_torch.runtime.context import TrainContext
from split_learning_torch.runtime.log import Logger
from split_learning_torch.runtime.plan import ClusterPlan
from split_learning_torch.runtime.strategies import make_strategy


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    ok: bool
    num_samples: int
    wall_s: float
    val_loss: float | None = None
    val_accuracy: float | None = None


@dataclasses.dataclass
class TrainResult:
    params: Any
    stats: Any
    history: list


def run_training(cfg: Config, ctx: TrainContext,
                 plans: list[ClusterPlan],
                 logger: Logger | None = None,
                 init_params: Any | None = None,
                 init_stats: Any | None = None) -> TrainResult:
    logger = logger or Logger.for_run(cfg, "server", console=False)
    strategy = make_strategy(cfg)

    start_round = 0
    params, stats = init_params, init_stats
    if cfg.checkpoint.load:
        ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
        if ck is not None:
            params = ctx.place(ck["params"])
            stats = ctx.place(ck["batch_stats"])
            start_round = ck["round_idx"]
            logger.info(f"Loaded checkpoint at round {start_round}.",
                        "green")
    if params is None:
        variables = ctx.init_variables()
        params = variables["params"]
        stats = variables.get("batch_stats", {})
    params = ctx.place(params)
    stats = ctx.place(stats or {})

    for plan in plans:
        logger.info(
            f"Cluster {plan.cluster_id}: cuts={plan.cuts} "
            f"clients={[len(ids) for ids in plan.clients]} "
            f"rejected={plan.rejected}", "cyan")

    history: list[RoundRecord] = []
    t_start = time.perf_counter()
    # one-slot async checkpoint writer: the save overlaps the next
    # round's training; trees are never mutated in place, so they are
    # safe to serialize from a thread
    ck_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    ck_future: concurrent.futures.Future | None = None
    try:
        for r in range(start_round, cfg.global_rounds):
            t0 = time.perf_counter()
            outcome = strategy.run_round(ctx, plans, r, params, stats)
            wall = time.perf_counter() - t0
            rec = RoundRecord(round_idx=r, ok=outcome.ok,
                              num_samples=outcome.num_samples, wall_s=wall)
            if not outcome.ok:
                logger.error(f"Round {r}: Training failed! "
                             f"(NaN detected; aggregation skipped)")
                history.append(rec)
                logger.metric(kind="round", **dataclasses.asdict(rec))
                continue
            prev_params, prev_stats = params, stats
            params, stats = outcome.params, outcome.stats
            if outcome.validate and cfg.checkpoint.validate:
                val = ctx.validate(params, stats)
                rec.val_loss, rec.val_accuracy = val.loss, val.accuracy
                rec.ok = val.ok
                logger.info(
                    f"Round {r}: samples={outcome.num_samples} "
                    f"val_loss={val.loss:.4f} val_acc={val.accuracy:.4f} "
                    f"({wall:.1f}s)", "green" if val.ok else "red")
                if not val.ok:
                    # keep the last good weights rather than training on
                    # from garbage
                    logger.error(f"Round {r}: Training failed! "
                                 f"(validation loss exploded)")
                    params, stats = prev_params, prev_stats
            else:
                logger.info(f"Round {r}: samples={outcome.num_samples} "
                            f"({wall:.1f}s)", "green")
            if rec.ok and cfg.checkpoint.save:
                if ck_future is not None:
                    ck_future.result()  # surface errors; keep order
                ck_future = ck_pool.submit(
                    save_checkpoint, cfg.checkpoint.directory,
                    cfg.model_key, params, stats, round_idx=r + 1)
            history.append(rec)
            logger.metric(kind="round", **dataclasses.asdict(rec),
                          **({"train_detail": outcome.metrics}
                             if outcome.metrics else {}))
            if cfg.limited_time and (time.perf_counter() - t_start
                                     > cfg.limited_time):
                logger.warning(f"Wall-clock budget {cfg.limited_time}s "
                               f"exhausted at round {r}.")
                break
    finally:
        # drain on every exit: a failed background save must surface
        if ck_future is not None:
            ck_future.result()  # the last checkpoint must be durable
        ck_pool.shutdown(wait=True)
    return TrainResult(params=params, stats=stats, history=history)
