"""Execution contexts: how a round strategy actually trains a cluster.

Port of the JAX package's ``runtime/context.py``.  A :class:`TrainContext`
exposes to the round strategies:

* ``init_variables() -> {"params", "batch_stats"}``;
* ``train_cluster(plan, params, stats, ...) -> list[Update]`` — one round
  (or ``epochs`` epochs) of split training for one cluster (or for a
  subset of its stage-1 clients, each from its own tree if given),
  returning per-(client, stage) shard updates with their parameters and
  BatchNorm statistics;
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

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from split_learning_torch.config import Config
from split_learning_torch.convert import tree_to
from split_learning_torch.data import make_data_loader, subset_seed
from split_learning_torch.device import resolve_device
from split_learning_torch.models import SplitModel, build_model, shard_params
from split_learning_torch.ops.fedavg import fedavg_trees
from split_learning_torch.ops.lora import (
    lora_init, lora_merge, lora_trainable, split_frozen,
)
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
                      client_subset: list | None = None,
                      per_client_params: dict | None = None,
                      lr: float | None = None,
                      sync_all_later_stages: bool = False,
                      send_params: bool | dict = True,
                      send_weights: bool | dict = True) -> list[Update]:
        raise NotImplementedError

    def validate(self, params, stats) -> ValResult:
        raise NotImplementedError

    def place(self, tree):
        """Move a state tree (e.g. a loaded checkpoint) to where this
        context keeps its parameters."""
        return tree

    def reset_peak_memory(self) -> None:
        """Start a new peak of :meth:`peak_memory`."""

    def peak_memory(self) -> int | None:
        """Peak bytes allocated on the device since
        :meth:`reset_peak_memory`; None where it is not measured."""
        return None

    def shutdown(self) -> None:
        pass


def client_groups(n_columns: int, n_logical: int) -> list[list[int]]:
    """Partition the columns into ``n_logical`` contiguous groups."""
    n_logical = max(1, min(n_logical, n_columns))
    bounds = [round(i * n_columns / n_logical)
              for i in range(n_logical + 1)]
    return [list(range(bounds[i], bounds[i + 1]))
            for i in range(n_logical)]


@dataclasses.dataclass
class _Column:
    """One stage-1 client's lockstep training state."""
    model: SplitModel
    pipe: PipelineModel
    optimizer: torch.optim.Optimizer
    loader: Any
    #: the column's LoRA adapters, or None when it trains its parameters
    lora: dict | None = None


class TorchContext(TrainContext):
    """In-process backend: every stage on one device (CUDA by default).

    The model is built once, on the device, from a ``torch.Generator``
    seeded with ``cfg.seed``; each round loads the round's parameters and
    BatchNorm statistics into it, trains with a fresh optimizer (the
    reference rebuilds its optimizer every round) and hands back clones
    of the trained shards.

    A cluster with several stage-1 clients trains them as lockstep
    columns, as the JAX package's mesh does with every column on the
    mesh at once: each column starts from the round's trees with its own
    model copy, loader and optimizer, and all columns take each step
    together.  A later stage with fewer logical clients than columns is
    shared: within each :func:`client_groups` group its layer gradients
    are averaged before every column's optimizer step (the reference's
    shared later-stage client, which trains on every feeder's
    activations), so the group's columns hold equal shard parameters.
    The columns run one after another on the device.

    With ``learning.lora-rank > 0`` every column trains LoRA adapters
    over the target kernels of its model (:meth:`_lora_partition`) and
    the classifier (the model's last layer); the rest of the model is
    frozen.  The adapters' initial values are drawn once per context,
    from ``cfg.seed``, and every column starts from them in every round,
    so that a sync group's columns stay equal.  A column's trained
    parameters are its merged weights (peft's ``merge_and_unload``): the
    fold sees full trees, never adapters.
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
        # column i > 0 trains on its own copy of the model
        self._columns: list[SplitModel] = [self.full_model]
        self._example = self._example_batch()
        self._lora_init: dict | None = None

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
        model = self._build()
        return {"params": model.state_tree(),
                "batch_stats": model.stats_tree()}

    def place(self, tree):
        return tree_to(tree, self.device)

    def reset_peak_memory(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_memory(self) -> int | None:
        if self.device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.device)

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

    def _column_model(self, i: int) -> SplitModel:
        while len(self._columns) <= i:
            self._columns.append(self._build())
        return self._columns[i]

    def _pipeline(self, cuts, column: int = 0) -> PipelineModel:
        key = (tuple(cuts), column)
        if key not in self._pipes:
            lrn = self.cfg.learning
            self._pipes[key] = PipelineModel(
                self._column_model(column), cuts=list(cuts),
                example_input=self._example,
                num_microbatches=lrn.control_count, remat=lrn.remat)
        return self._pipes[key]

    def _sync_groups(self, plan: ClusterPlan, n_cols: int,
                     sync_all: bool = False) -> dict:
        """``{layer name: column groups}`` for the parametric layers of
        every later stage with fewer logical clients than columns (the
        JAX package's ``_sync_map`` with every column on the mesh);
        ``sync_all`` makes every later stage one group (SDA: the later
        stages train on every feeder's batches)."""
        ranges = stage_ranges(len(self.specs), plan.cuts)
        sync: dict = {}
        for s in range(2, len(ranges) + 1):
            n_logical = (1 if sync_all
                         else max(1, len(plan.clients[s - 1])))
            if n_logical >= n_cols:
                continue   # every column its own logical client
            groups = client_groups(n_cols, n_logical)
            a, b = ranges[s - 1]
            for spec in self.specs[a:b]:
                if spec.make is not None:
                    sync[spec.name] = groups
        return sync

    def _lora_partition(self, model: SplitModel):
        """(adapters, trainable tensors) of one column for a LoRA round:
        fresh copies of the context's adapter init over the target
        kernels of every layer but the last, that last layer (the
        classifier) unfrozen, every other parameter frozen.  With no
        target kernel in the model, the whole model trains, with a
        warning (adapters None)."""
        lrn = self.cfg.learning
        head = self.specs[-1].name
        if self._lora_init is None:
            frozen, _ = split_frozen(model.state_tree(), [head])
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed)
            self._lora_init = lora_init(gen, frozen, model,
                                        targets=lrn.lora_targets,
                                        rank=lrn.lora_rank)
            if not self._lora_init:
                warnings.warn(
                    "lora_rank set but no target kernels in this model; "
                    "training full parameters instead", stacklevel=3)
        if not self._lora_init:
            return None, model.parameters()
        adapters = {layer: {key: {n: t.clone() for n, t in entry.items()}
                            for key, entry in entries.items()}
                    for layer, entries in self._lora_init.items()}
        return adapters, lora_trainable(model, adapters, [head])

    # -- the round ----------------------------------------------------------

    @staticmethod
    def _trainables(c: _Column, name: str) -> dict:
        """Layer ``name``'s parameters and its LoRA factors in column
        ``c``."""
        out = dict(c.model.layers[name].named_parameters())
        for key, entry in (c.lora or {}).get(name, {}).items():
            out.update({f"{key}.lora_{n}": t for n, t in entry.items()})
        return out

    @torch.no_grad()
    def _sync_grads(self, cols: list[_Column], sync: dict) -> None:
        """Average each synced layer's gradients (its LoRA factors' too)
        within its groups: the sum in column order, divided by the group
        size."""
        for name, groups in sync.items():
            for grp in groups:
                if len(grp) < 2:
                    continue
                per_col = [self._trainables(cols[i], name) for i in grp]
                for pname in per_col[0]:
                    grads = [p[pname].grad for p in per_col]
                    if any(g is None for g in grads):
                        continue
                    total = grads[0].clone()
                    for g in grads[1:]:
                        total += g
                    total /= torch.tensor(float(len(grp)),
                                          device=total.device)
                    for g in grads:
                        g.copy_(total)

    def _drive(self, cols: list[_Column], sync: dict, epochs: int):
        """Feed host batches through every column in lockstep for
        ``epochs``.

        Returns (each column's final step loss as a float — the round's
        NaN sentinel, each column's DISTINCT samples consumed): a loader
        shorter than the M-batch draw restarts mid-step, and those
        redraws must not inflate the client's aggregation weight, so the
        count is capped at the loader's own epoch (and dataset) size."""
        M, mb = self.cfg.learning.control_count, self.cfg.learning.batch_size
        steps_per_epoch = max(1, min(len(c.loader) for c in cols) // M)
        consumed = [epochs * min(steps_per_epoch * M * mb,
                                 c.loader.samples_per_epoch,
                                 len(c.loader.dataset)) for c in cols]
        clip = self.cfg.learning.clip_grad_norm
        losses = [None] * len(cols)
        for _ in range(epochs):
            iters = [iter(c.loader) for c in cols]
            for _ in range(steps_per_epoch):
                for i, c in enumerate(cols):
                    bx, by = [], []
                    for _ in range(M):
                        try:
                            b = next(iters[i])
                        except StopIteration:
                            iters[i] = iter(c.loader)
                            b = next(iters[i])
                        bx.append(np.asarray(b[0]))
                        by.append(np.asarray(b[1]))
                    x = torch.from_numpy(np.stack(bx)).to(self.device)
                    labels = torch.from_numpy(
                        np.stack(by).astype(np.int32)).to(self.device)
                    c.optimizer.zero_grad(set_to_none=True)
                    losses[i] = c.pipe.accumulate(x, labels)
                if sync:
                    self._sync_grads(cols, sync)
                for c in cols:
                    c.pipe.apply(c.optimizer, clip)
        return ([float(v) if v is not None else 0.0 for v in losses],
                consumed)

    def train_cluster(self, plan: ClusterPlan, params, stats, *,
                      round_idx: int = 0, epochs: int = 1,
                      client_subset: list | None = None,
                      per_client_params: dict | None = None,
                      lr: float | None = None,
                      sync_all_later_stages: bool = False,
                      send_params: bool | dict = True,
                      send_weights: bool | dict = True) -> list[Update]:
        """Train the plan's stage-1 clients (those in ``client_subset``
        when given, in the plan's order) as lockstep columns, each from
        its own tree in ``per_client_params`` or else from ``params``.
        Column ``i`` is the ``i``-th trained client, as in the JAX
        package's chunk of columns, and keys its dropout by ``(i,
        round_idx)``.  ``send_params`` and ``send_weights`` are the
        protocol's wire economy: in process there is no wire, so they
        are ignored."""
        del send_params, send_weights
        stage1 = [c for c in plan.stage1_clients
                  if client_subset is None or c in client_subset]
        if not stage1:
            return []
        trees = per_client_params or {}
        lrn = self.cfg.learning
        cols = []
        for i, cid in enumerate(stage1):
            model = self._column_model(i)
            model.load_state_tree(trees.get(cid, params))
            model.load_stats_tree(stats or {})
            model.train()
            # each column's masks: a function of (column, round), as the
            # JAX package keys its dropout
            model.seed_dropout(i + round_idx * 1000)
            counts = plan.label_counts[plan.stage1_clients.index(cid)]
            if lrn.lora_rank > 0:
                adapters, trainable = self._lora_partition(model)
            else:
                adapters, trainable = None, model.parameters()
            pipe = self._pipeline(plan.cuts, i)
            pipe.lora = (None if adapters is None else
                         (adapters, lrn.lora_alpha, lrn.lora_rank))
            cols.append(_Column(
                model, pipe, make_optimizer(lrn, trainable, lr),
                self._loader(cid, counts, round_idx), adapters))
        sync = self._sync_groups(plan, len(cols), sync_all_later_stages)
        losses, consumed = self._drive(cols, sync, epochs)
        trained = []
        for c in cols:
            c.optimizer = None   # its moments are re-initialised every round
            tree = c.model.state_tree()
            if c.lora is not None:
                # merge_and_unload: the fold sees merged full trees
                with torch.no_grad():
                    tree = lora_merge(tree, c.lora, lrn.lora_alpha,
                                      lrn.lora_rank)
            trained.append((_clone(tree), _clone(c.model.stats_tree())))
        return self._extract_updates(plan, stage1, trained, losses,
                                     consumed, sync)

    def _extract_updates(self, plan: ClusterPlan, stage1: list,
                         trained: list, losses: list, consumed: list,
                         sync: dict) -> list[Update]:
        """Per-(logical client, stage) shard updates from the trained
        columns: one stage-1 update per column; for a later stage one
        update per sync group (or per column when it is not shared),
        holding the group's first column's parameters (equal across the
        group by construction), the consumed-weighted FedAvg of its
        columns' statistics (each column normalised its own batches) and
        the sum of their samples."""
        ranges = stage_ranges(len(self.specs), plan.cuts)
        ok = [bool(np.isfinite(v)) for v in losses]
        out: list[Update] = []
        a, b = ranges[0]
        for i, cid in enumerate(stage1):
            p, st = trained[i]
            out.append(Update(
                client_id=cid, stage=1, cluster=plan.cluster_id,
                params=shard_params(p, self.specs, a, b),
                batch_stats=shard_params(st, self.specs, a, b),
                num_samples=int(consumed[i]), ok=ok[i]))
        for s in range(2, len(ranges) + 1):
            a, b = ranges[s - 1]
            names = [sp.name for sp in self.specs[a:b] if sp.make]
            groups = (sync.get(names[0]) if names else None) or [
                [i] for i in range(len(trained))]
            logical = plan.clients[s - 1] or [f"_stage{s}"]
            for gi, grp in enumerate(groups):
                p, st = trained[grp[0]]
                group_stats = shard_params(st, self.specs, a, b)
                if group_stats and len(grp) > 1:
                    group_stats = fedavg_trees(
                        [shard_params(trained[i][1], self.specs, a, b)
                         for i in grp],
                        [max(1, int(consumed[i])) for i in grp])
                out.append(Update(
                    client_id=logical[min(gi, len(logical) - 1)],
                    stage=s, cluster=plan.cluster_id,
                    params=shard_params(p, self.specs, a, b),
                    batch_stats=group_stats,
                    num_samples=int(sum(consumed[i] for i in grp)),
                    ok=all(ok[i] for i in grp)))
        return out

    def validate(self, params, stats) -> ValResult:
        if not hasattr(self, "_val_cache"):
            # loader and eval step are cached: validation runs every round
            loader = make_data_loader(
                self.dataset, self.cfg.val_batch_size, train=False,
                synthetic_size=self.cfg.synthetic_size,
                dataset_kwargs=self.dataset_kwargs)
            self._val_cache = (loader, make_eval_step(self.full_model))
        loader, step = self._val_cache
        self.full_model.load_state_tree(params)
        self.full_model.load_stats_tree(stats or {})
        self.full_model.eval()
        return run_eval(step, loader, self.device, self.cfg.val_max_batches)


def _clone(tree: dict) -> dict:
    return {name: {k: t.clone() for k, t in sd.items()}
            for name, sd in tree.items()}
