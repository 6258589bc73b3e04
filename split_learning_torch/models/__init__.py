"""Split-aware model zoo: TinyLlama and VGG16 (CIFAR-10, CIFAR-100,
MNIST).

Every model is an ordered list of indexed
:class:`~split_learning_torch.models.split.LayerSpec` entries; the
generic :class:`~split_learning_torch.models.split.SplitModel` builds any
contiguous slice of it.  The rest of the JAX package's zoo (ResNet, ViT,
BERT, KWT, MobileNet, the MoE TinyLlama) waits for later slices.
"""

from split_learning_torch.models.split import (
    LayerSpec, SplitModel, build_model, model_registry, register_model,
    shard_params, merge_shard_params, num_layers,
)
import split_learning_torch.models.llama  # noqa: F401  (TinyLlama_*)
import split_learning_torch.models.vgg  # noqa: F401  (VGG16_*)

__all__ = [
    "LayerSpec", "SplitModel", "build_model", "model_registry",
    "register_model", "shard_params", "merge_shard_params", "num_layers",
]
