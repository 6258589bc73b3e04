"""The global round loop: train → aggregate → validate → checkpoint.

Port of the JAX package's ``runtime/loop.py``: after each round's updates
are aggregated the full model is validated; a NaN round logs "Training
failed!" and is not checkpointed; an exploded validation loss rolls back
to the last good weights; otherwise the checkpoint is (over)written by a
one-slot background writer and the next round begins; resume loads the
checkpoint and continues.

Each round's record carries the device's peak allocated bytes over its
training (``train_peak_memory_bytes``) and the :class:`~split_learning_
torch.runtime.trace.StepTimer` summary of its ``train``, ``validate``
and ``checkpoint`` phases (``phases``).  Each round is a ``round`` span
with those phases as children on the context's tracer (a loop-owned one
when the context has none, as in process): the anchors that
``tools/sl_trace.py`` walks the critical path from.  The phase clocks
stop at the host, as the JAX package's do: on the card a phase's
trailing launches land in the next phase that waits for them.

Left out so far (listed in ROADMAP.md): the per-round MemoryWatch and
kind=perf records, the on-demand profiler capture, the blackbox
recorder, the elastic membership refresh and the scheduler hook.
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
from split_learning_torch.runtime.spans import make_tracer
from split_learning_torch.runtime.strategies import make_strategy
from split_learning_torch.runtime.trace import StepTimer


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    ok: bool
    num_samples: int
    wall_s: float
    val_loss: float | None = None
    val_accuracy: float | None = None
    #: the device's peak allocated bytes over the round's training,
    #: before validation (None where the context does not measure it)
    train_peak_memory_bytes: int | None = None


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
    # round tracing: the context's tracer when it has one (the protocol
    # server), else a loop-owned one, closed on exit
    tracer = getattr(ctx, "tracer", None)
    own_tracer = tracer is None
    if own_tracer:
        tracer = make_tracer(cfg, "server")

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
    timer = StepTimer()
    t_start = time.perf_counter()
    # one-slot async checkpoint writer: the save overlaps the next
    # round's training; trees are never mutated in place, so they are
    # safe to serialize from a thread
    ck_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    ck_future: concurrent.futures.Future | None = None
    try:
        for r in range(start_round, cfg.global_rounds):
            # one span a round, the loop's phases its children: the
            # anchor tools/sl_trace.py walks the critical path from
            with tracer.span("round", round=r) as round_span:
                ctx.reset_peak_memory()
                t0 = time.perf_counter()
                with timer.phase("train"), tracer.span("train", round=r):
                    outcome = strategy.run_round(ctx, plans, r, params,
                                                 stats)
                wall = time.perf_counter() - t0
                rec = RoundRecord(round_idx=r, ok=outcome.ok,
                                  num_samples=outcome.num_samples,
                                  wall_s=wall,
                                  train_peak_memory_bytes=ctx.peak_memory())
                if not outcome.ok:
                    logger.error(f"Round {r}: Training failed! "
                                 f"(NaN detected; aggregation skipped)")
                    history.append(rec)
                    logger.metric(kind="round", **dataclasses.asdict(rec),
                                  phases=timer.summary())
                    timer.reset()
                    # the failed round's spans hit the disk like a clean
                    # round's (end() is idempotent)
                    round_span.end()
                    tracer.flush()
                    continue
                prev_params, prev_stats = params, stats
                params, stats = outcome.params, outcome.stats
                if outcome.validate and cfg.checkpoint.validate:
                    with timer.phase("validate"), \
                            tracer.span("validate", round=r):
                        val = ctx.validate(params, stats)
                    rec.val_loss, rec.val_accuracy = val.loss, val.accuracy
                    rec.ok = val.ok
                    logger.info(
                        f"Round {r}: samples={outcome.num_samples} "
                        f"val_loss={val.loss:.4f} "
                        f"val_acc={val.accuracy:.4f} ({wall:.1f}s)",
                        "green" if val.ok else "red")
                    if not val.ok:
                        # keep the last good weights rather than training
                        # on from garbage
                        logger.error(f"Round {r}: Training failed! "
                                     f"(validation loss exploded)")
                        params, stats = prev_params, prev_stats
                else:
                    logger.info(f"Round {r}: samples={outcome.num_samples} "
                                f"({wall:.1f}s)", "green")
                if rec.ok and cfg.checkpoint.save:
                    with timer.phase("checkpoint"), \
                            tracer.span("checkpoint", round=r):
                        if ck_future is not None:
                            ck_future.result()  # surface errors; keep order
                        ck_future = ck_pool.submit(
                            save_checkpoint, cfg.checkpoint.directory,
                            cfg.model_key, params, stats, round_idx=r + 1)
                history.append(rec)
                logger.metric(kind="round", **dataclasses.asdict(rec),
                              phases=timer.summary(),
                              **({"train_detail": outcome.metrics}
                                 if outcome.metrics else {}))
                timer.reset()
            tracer.flush()
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
        if own_tracer:
            tracer.close()
        else:
            tracer.flush()
    return TrainResult(params=params, stats=stats, history=history)
