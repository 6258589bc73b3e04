"""Execution contexts: how a round strategy actually trains a cluster.

Port of the JAX package's ``runtime/context.py``.  A :class:`TrainContext`
exposes to the round strategies:

* ``init_variables() -> {"params", "batch_stats"}``;
* ``train_cluster(plan, params, stats, ...) -> list[Update]`` — one round
  (or ``epochs`` epochs) of split training for one cluster, returning
  per-(client, stage) shard updates;
* ``validate(params, stats) -> ValResult`` — full-model test pass.

:class:`TorchContext` is the counterpart of the JAX package's
MeshContext on one device: one device holds every stage, the stages are
shards of one model whose parameters stay on the device between steps,
and :class:`~split_learning_torch.parallel.pipeline.PipelineModel` runs
the microbatched split schedule.  The device-resident round fast path
(``train_cluster_resident``) is not ported: the FedAvg strategy calls
``train_cluster``, whose host-path semantics it matches.
"""

from __future__ import annotations

import numpy as np
import torch

from split_learning_torch.config import Config
from split_learning_torch.convert import tree_to
from split_learning_torch.data import make_data_loader, subset_seed
from split_learning_torch.device import resolve_device
from split_learning_torch.models import build_model, shard_params
from split_learning_torch.parallel.mesh import stage_ranges
from split_learning_torch.parallel.pipeline import PipelineModel
from split_learning_torch.runtime.plan import ClusterPlan
from split_learning_torch.runtime.protocol import Update
from split_learning_torch.runtime.validation import (
    ValResult, dataset_for_model, dataset_kwargs_for_model, make_eval_step,
    run_eval,
)


def make_optimizer(learning, params, lr: float | None = None
                   ) -> torch.optim.Optimizer:
    """Optimizer from a LearningConfig: ``optax.adamw`` (b1 0.9, b2
    0.999, eps 1e-8, the config's weight decay, passed explicitly since
    torch's AdamW default differs) or ``optax.sgd`` with momentum.
    ``clip_grad_norm`` is applied by the train step."""
    rate = lr if lr is not None else learning.learning_rate
    params = list(params)
    if learning.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=rate, betas=(0.9, 0.999),
                                 eps=1e-8,
                                 weight_decay=learning.weight_decay)
    if learning.optimizer == "sgd":
        return torch.optim.SGD(params, lr=rate,
                               momentum=learning.momentum)
    raise NotImplementedError(
        f"optimizer {learning.optimizer!r} (bf16 Adam moments / ZeRO-1, "
        "parallel/zero.py) is not ported yet; it comes with the "
        "parallel-planes slice")


class TrainContext:
    def init_variables(self) -> dict:
        raise NotImplementedError

    def train_cluster(self, plan: ClusterPlan, params, stats, *,
                      round_idx: int = 0, epochs: int = 1,
                      lr: float | None = None) -> list[Update]:
        raise NotImplementedError

    def validate(self, params, stats) -> ValResult:
        raise NotImplementedError

    def place(self, tree):
        """Move a state tree (e.g. a loaded checkpoint) to where this
        context keeps its parameters."""
        return tree

    def shutdown(self) -> None:
        pass


class TorchContext(TrainContext):
    """In-process backend: every stage on one device (CUDA by default).

    The model is built once, on the device, from a ``torch.Generator``
    seeded with ``cfg.seed``; each round loads the round's parameters into
    it, trains with a fresh optimizer (the reference rebuilds its
    optimizer every round) and hands back clones of the trained shards.
    """

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_kwargs = dict(cfg.model_kwargs or {})
        if cfg.compute_dtype == "bfloat16":
            self.model_kwargs.setdefault("dtype", torch.bfloat16)
        self.full_model = self._build()
        self.specs = self.full_model.specs
        self.dataset = dataset_for_model(cfg.model_key)
        self.dataset_kwargs = dataset_kwargs_for_model(
            cfg.model_key, self.model_kwargs)
        self._loader_cache: dict = {}
        self._pipes: dict = {}
        self._example = self._example_batch()

    def _build(self):
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return build_model(self.cfg.model_key, device=self.device,
                           generator=gen, **self.model_kwargs)

    # -- model/data geometry ------------------------------------------------

    def _example_batch(self) -> torch.Tensor:
        """Zeros shaped like one microbatch of model inputs."""
        mb = self.cfg.learning.batch_size
        ds = make_data_loader(self.dataset, 1, train=False,
                              synthetic_size=self.cfg.synthetic_size or 64,
                              dataset_kwargs=self.dataset_kwargs)
        x, _ = next(iter(ds))
        arr = np.asarray(x)
        return torch.zeros((mb,) + arr.shape[1:],
                           dtype=torch.from_numpy(arr).dtype,
                           device=self.device)

    def init_variables(self) -> dict:
        """Fresh initial variables drawn from ``cfg.seed`` (the same
        values every call)."""
        return {"params": self._build().state_tree(), "batch_stats": {}}

    def place(self, tree):
        return tree_to(tree, self.device)

    def _loader(self, client_key: str, label_counts: np.ndarray,
                round_idx: int = 0):
        refresh = self.cfg.distribution.refresh
        key = (client_key, tuple(np.asarray(label_counts).tolist()),
               round_idx if refresh else 0)
        if key not in self._loader_cache:
            if refresh:
                # evict this client's prior-round loaders: each holds a
                # materialized subset copy and is never reused
                for k in [k for k in self._loader_cache
                          if k[0] == client_key]:
                    del self._loader_cache[k]
            seed = subset_seed(self.cfg.seed, client_key, round_idx,
                               refresh)
            self._loader_cache[key] = make_data_loader(
                self.dataset, self.cfg.learning.batch_size,
                distribution=np.asarray(label_counts), train=True,
                seed=seed, synthetic_size=self.cfg.synthetic_size,
                dataset_kwargs=self.dataset_kwargs)
        return self._loader_cache[key]

    def _pipeline(self, cuts) -> PipelineModel:
        key = tuple(cuts)
        if key not in self._pipes:
            lrn = self.cfg.learning
            self._pipes[key] = PipelineModel(
                self.full_model, cuts=list(cuts),
                example_input=self._example,
                num_microbatches=lrn.control_count, remat=lrn.remat)
        return self._pipes[key]

    # -- the round ----------------------------------------------------------

    def _drive(self, pipe: PipelineModel, optimizer, loader, epochs: int):
        """Feed host batches through the pipeline for ``epochs``.

        Returns (final step loss as a float — the round's NaN sentinel,
        DISTINCT samples consumed): a loader shorter than the M-batch
        draw restarts mid-step, and those redraws must not inflate the
        client's aggregation weight, so the count is capped at the
        loader's own epoch (and dataset) size."""
        M, mb = pipe.num_microbatches, self.cfg.learning.batch_size
        steps_per_epoch = max(1, len(loader) // M)
        consumed = epochs * min(steps_per_epoch * M * mb,
                                loader.samples_per_epoch,
                                len(loader.dataset))
        clip = self.cfg.learning.clip_grad_norm
        loss = None
        for _ in range(epochs):
            it = iter(loader)
            for _ in range(steps_per_epoch):
                bx, by = [], []
                for _ in range(M):
                    try:
                        b = next(it)
                    except StopIteration:
                        it = iter(loader)
                        b = next(it)
                    bx.append(np.asarray(b[0]))
                    by.append(np.asarray(b[1]))
                x = torch.from_numpy(np.stack(bx)).to(self.device)
                labels = torch.from_numpy(
                    np.stack(by).astype(np.int32)).to(self.device)
                loss = pipe.train_step(optimizer, x, labels,
                                       clip_grad_norm=clip)
        return (float(loss) if loss is not None else 0.0), consumed

    def train_cluster(self, plan: ClusterPlan, params, stats, *,
                      round_idx: int = 0, epochs: int = 1,
                      lr: float | None = None) -> list[Update]:
        del stats   # no running statistics in the ported models
        stage1 = plan.stage1_clients
        if len(stage1) > 1:
            raise NotImplementedError(
                f"cluster {plan.cluster_id} trains {len(stage1)} stage-1 "
                "clients at once; lockstep multi-column training with "
                "shared later-stage gradient sync is not ported yet (it "
                "comes with the VGG16/CIFAR10 slice)")
        cid, counts = stage1[0], plan.label_counts[0]
        pipe = self._pipeline(plan.cuts)
        self.full_model.load_state_tree(params)
        self.full_model.train()
        optimizer = make_optimizer(self.cfg.learning,
                                   self.full_model.parameters(), lr)
        loss, consumed = self._drive(
            pipe, optimizer, self._loader(cid, counts, round_idx), epochs)
        del optimizer   # its moments are re-initialised every round
        trained = {name: {k: t.clone() for k, t in sd.items()}
                   for name, sd in self.full_model.state_tree().items()}
        return self._extract_updates(plan, cid, trained, loss, consumed)

    def _extract_updates(self, plan: ClusterPlan, cid: str, params,
                         loss: float, consumed: int) -> list[Update]:
        """Per-(client, stage) shard updates from the trained model."""
        ranges = stage_ranges(len(self.specs), plan.cuts)
        ok = bool(np.isfinite(loss))
        out: list[Update] = []
        for s, (a, b) in enumerate(ranges, start=1):
            logical = plan.clients[s - 1] or [f"_stage{s}"]
            out.append(Update(
                client_id=cid if s == 1 else logical[0], stage=s,
                cluster=plan.cluster_id,
                params=shard_params(params, self.specs, a, b),
                batch_stats={}, num_samples=int(consumed), ok=ok))
        return out

    def validate(self, params, stats) -> ValResult:
        del stats   # no running statistics in the ported models
        if not hasattr(self, "_val_cache"):
            # loader and eval step are cached: validation runs every round
            loader = make_data_loader(
                self.dataset, self.cfg.val_batch_size, train=False,
                synthetic_size=self.cfg.synthetic_size,
                dataset_kwargs=self.dataset_kwargs)
            self._val_cache = (loader, make_eval_step(self.full_model))
        loader, step = self._val_cache
        self.full_model.load_state_tree(params)
        self.full_model.eval()
        return run_eval(step, loader, self.device, self.cfg.val_max_batches)

