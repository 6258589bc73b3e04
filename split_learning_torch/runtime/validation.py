"""Server-side full-model validation.

Port of the JAX package's ``runtime/validation.py``: after aggregation
the full model runs the test set in eval mode (BatchNorm normalises with
the running statistics the caller loaded, dropout is the identity); a
NaN or exploded loss marks the round failed, which the round loop uses
to skip checkpointing.  Loss and accuracy are counted per token for
token datasets.  The full model takes the dataset's own inputs (token
ids for BERT, whose layers pass the padding mask beside the hidden
states to the pooler), so the pass is the same for every model.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

_MODEL_DATASET = {
    # model registry key -> dataset provider name
    "VGG16_CIFAR10": "CIFAR10",
    "VGG16_CIFAR100": "CIFAR100",
    "VGG16_MNIST": "MNIST",
    "BERT_AGNEWS": "AGNEWS",
    "BERT_EMOTION": "EMOTION",
    "KWT_SPEECHCOMMANDS": "SPEECHCOMMANDS",
}


def dataset_for_model(model_key: str) -> str:
    if model_key in _MODEL_DATASET:
        return _MODEL_DATASET[model_key]
    # registry convention {MODEL}_{DATASET}
    return model_key.rsplit("_", 1)[-1]


# datasets whose providers accept a ``vocab`` kwarg (token data)
_TOKEN_DATASETS = {"TINYSTORIES", "AGNEWS", "EMOTION"}


def dataset_kwargs_for_model(model_key: str,
                             model_kwargs: dict | None) -> dict:
    """Dataset-provider kwargs implied by the model's build kwargs: a
    model with an overridden ``vocab_size`` must draw token ids inside
    its own embedding table."""
    mk = model_kwargs or {}
    if (dataset_for_model(model_key) in _TOKEN_DATASETS
            and mk.get("vocab_size")):
        return {"vocab": int(mk["vocab_size"])}
    return {}


@dataclasses.dataclass
class ValResult:
    loss: float
    accuracy: float
    num_samples: int

    @property
    def ok(self) -> bool:
        """Round acceptance: reject NaN/exploded loss."""
        return bool(np.isfinite(self.loss) and abs(self.loss) < 1e5)


def make_eval_step(model):
    """``step(x, labels) -> (summed loss, correct count)`` as device
    scalars; the cross entropy runs on the logits in the model's compute
    dtype, as in the reference."""
    @torch.no_grad()
    def step(x, labels):
        logits = model(x, train=False)
        labels = labels.long()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), reduction="none").sum()
        correct = (logits.argmax(dim=-1) == labels).sum()
        return loss, correct
    return step


def run_eval(step, loader, device, max_batches: int | None) -> ValResult:
    total_loss, total_correct, n = 0.0, 0, 0
    for i, (x, labels) in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        loss, correct = step(torch.from_numpy(np.asarray(x)).to(device),
                             torch.from_numpy(np.asarray(labels)).to(device))
        total_loss += float(loss)
        total_correct += int(correct)
        n += int(np.asarray(labels).size)   # token-level for LM labels
    return ValResult(loss=total_loss / max(n, 1),
                     accuracy=total_correct / max(n, 1), num_samples=n)

