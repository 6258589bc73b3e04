"""Split-learning pipeline on one device.

Port of the JAX package's ``parallel/pipeline.py`` for the case where one
device holds every stage:

* each stage is its own shard module (:meth:`SplitModel.shard` of the
  full model), and the activation crosses every cut explicitly: stage
  *k*'s output is detached and handed to stage *k+1* as a leaf that
  requires grad, and in the backward the gradient at that leaf is handed
  back to stage *k*'s output — what the activation and gradient queues
  carry in the reference;
* the reference's ``control-count`` in-flight cap is the microbatch
  count: every step draws ``num_microbatches`` loader batches, runs each
  through the stages forward and then backward, and accumulates the
  gradients of the mean microbatch loss into ONE synchronous optimizer
  update;
* **streamed loss**: the last stage computes its microbatch's loss
  inside its own (optionally recomputed) block, so an LM head's logits
  are consumed where they are produced and are never kept for the
  backward;
* **remat policy** (``remat=``): ``"all"`` recomputes every stage in the
  backward, ``"none"`` stores every stage's activations, and ``"wide"``
  (default) recomputes exactly the stages whose per-sample boundary
  width (max of input and output) exceeds ``REMAT_WIDE_THRESHOLD``.
  Recompute is ``torch.utils.checkpoint`` with ``use_reentrant=False``;
  a recomputed stage replays its dropout generators' states, so it
  draws the masks of its first run;
* **BatchNorm statistics**: every stage's train-mode forward leaves its
  new running statistics pending and the schedule keeps them once per
  microbatch, after that microbatch's backward, in microbatch order —
  the JAX scan carries them tick by tick — so a recomputed stage does
  not update them twice.

The replicated/sliced multi-device layouts, TP/SP/EP and LoRA wait for
later slices.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from split_learning_torch.models.split import SplitModel
from split_learning_torch.parallel.mesh import stage_ranges


class PipelineModel:
    """Stage shards + schedule for one split of a model on one device.

    Owns no parameters: the stages share the modules of ``full_model``.
    ``example_input`` is one microbatch (or any batch) of model inputs on
    the model's device; one sample of it runs through the stages once to
    measure the boundary widths for the remat policy.
    """

    #: per-sample boundary width (elements) above which the ``wide``
    #: remat policy recomputes a stage
    REMAT_WIDE_THRESHOLD = 65536

    def __init__(self, full_model: SplitModel, cuts: Sequence[int],
                 example_input: torch.Tensor, num_microbatches: int = 4,
                 remat: str = "wide"):
        self.full_model = full_model
        self.specs = full_model.specs
        self.n_layers = len(self.specs)
        self.cuts = list(cuts)
        self.ranges = stage_ranges(self.n_layers, self.cuts)
        self.n_stages = len(self.ranges)
        self.num_microbatches = num_microbatches
        if remat not in ("all", "wide", "none"):
            raise ValueError(
                f"remat must be 'all', 'wide' or 'none'; got {remat!r}")
        self.stage_models = [full_model.shard(a, b) for a, b in self.ranges]
        self.mb_size = example_input.shape[0]

        # per-sample boundary widths: one sample through the stages
        with torch.no_grad():
            x = example_input[:1]
            widths = [x[0].numel()]
            for m in self.stage_models:
                x = m(x, train=False)
                widths.append(x[0].numel())
        if remat == "all":
            self.stage_remat = [True] * self.n_stages
        elif remat == "none":
            self.stage_remat = [False] * self.n_stages
        else:
            self.stage_remat = [
                max(widths[s], widths[s + 1]) > self.REMAT_WIDE_THRESHOLD
                for s in range(self.n_stages)]

    @staticmethod
    def loss_from_logits(logits, labels):
        """Mean softmax cross entropy over every token; the logits stay
        in the model's compute dtype, as the reference feeds bf16 logits
        to its cross entropy.  Per-token losses first, then one mean
        (accumulated in float32, rounded once to the logits' dtype), as
        optax's ``softmax_cross_entropy_with_integer_labels(...).mean()``
        reduces: ``F.cross_entropy``'s own mean reduction of bf16 loses
        up to a bf16 ulp more."""
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long(),
                               reduction="none").mean()

    def _stage_apply(self, s: int, x, labels):
        out = self.stage_models[s](x, train=True)
        if s == self.n_stages - 1:
            # streamed loss: reduce the logits inside the stage block
            return self.loss_from_logits(out, labels).float()
        return out

    def _replaying(self, s: int):
        """Stage ``s``'s apply for ``torch.utils.checkpoint``: its
        recompute restores the dropout generators to their states at the
        first run (checkpoint preserves only the default generators),
        then puts back the states it found."""
        fn = functools.partial(self._stage_apply, s)
        model = self.stage_models[s]
        first = model.rng_state()
        calls = []

        def apply(h, labels):
            if not calls:
                calls.append(1)
                return fn(h, labels)
            now = model.rng_state()
            model.set_rng_state(first)
            try:
                return fn(h, labels)
            finally:
                model.set_rng_state(now)
        return apply

    def microbatch_backward(self, x, labels, loss_scale: float):
        """Forward one microbatch stage by stage, then backward stage by
        stage, accumulating ``loss_scale * d loss`` into the parameters'
        ``.grad``, then keep the microbatch's BatchNorm statistics.
        Returns the microbatch loss (detached)."""
        inputs, outputs = [], []
        h = x
        for s in range(self.n_stages):
            if s > 0:
                # the cut: the next stage receives the activation as a
                # fresh leaf; its gradient is handed back below
                h = h.detach().requires_grad_(h.is_floating_point())
            if self.stage_remat[s]:
                out = checkpoint(self._replaying(s), h, labels,
                                 use_reentrant=False)
            else:
                out = self._stage_apply(s, h, labels)
            inputs.append(h)
            outputs.append(out)
            h = out
        loss = outputs[-1]
        grad = None
        for s in reversed(range(self.n_stages)):
            if s == self.n_stages - 1:
                (loss * loss_scale).backward()
            else:
                outputs[s].backward(grad)
            if s > 0:
                grad = inputs[s].grad
            outputs[s] = None   # free the stage's graph as soon as done
        self.full_model.commit_stats()
        return loss.detach()

    def accumulate(self, x, labels) -> torch.Tensor:
        """The gradients of one synchronous update, from
        ``num_microbatches`` microbatches (``x``/``labels`` are (M, mb,
        ...)), into the parameters' ``.grad`` (which must start empty).
        Returns the mean microbatch loss (a device scalar)."""
        M = self.num_microbatches
        total = None
        for m in range(M):
            loss = self.microbatch_backward(x[m], labels[m], 1.0 / M)
            total = loss if total is None else total + loss
        return total / M

    @staticmethod
    def apply(optimizer: torch.optim.Optimizer,
              clip_grad_norm: float | None = None) -> None:
        """Clip (``optax.clip_by_global_norm``) and step on the
        accumulated gradients."""
        if clip_grad_norm:
            clip_by_global_norm(
                [p for g in optimizer.param_groups for p in g["params"]],
                clip_grad_norm)
        optimizer.step()

    def train_step(self, optimizer: torch.optim.Optimizer, x, labels,
                   clip_grad_norm: float | None = None) -> torch.Tensor:
        """One synchronous update from ``num_microbatches`` microbatches:
        ``x``/``labels`` are (M, mb, ...).  Returns the mean microbatch
        loss (a device scalar)."""
        optimizer.zero_grad(set_to_none=True)
        loss = self.accumulate(x, labels)
        self.apply(optimizer, clip_grad_norm)
        return loss


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: when the global gradient norm
    exceeds ``max_norm``, scale every gradient by ``max_norm / norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
