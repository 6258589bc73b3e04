"""Split-aware model zoo: TinyLlama, VGG16 (CIFAR-10, CIFAR-100,
MNIST), ResNet-50 (CIFAR-100, CIFAR-10), ViT (CIFAR-10, MNIST, and
ViT-S/16 on CIFAR-10), BERT-base (AG-News, Emotion; 15 macro-layers or
27 fine-grained ones) and KWT-1 (SpeechCommands).

Every model is an ordered list of indexed
:class:`~split_learning_torch.models.split.LayerSpec` entries; the
generic :class:`~split_learning_torch.models.split.SplitModel` builds any
contiguous slice of it; a layer's input and output may be a tuple of
tensors (BERT's ``(hidden, mask)``).  The rest of the JAX package's zoo
(MobileNet, the MoE TinyLlama) waits for later slices.
"""

from split_learning_torch.models.split import (
    LayerSpec, SplitModel, build_model, model_registry, register_model,
    shard_params, merge_shard_params, num_layers,
)
import split_learning_torch.models.llama  # noqa: F401  (TinyLlama_*)
import split_learning_torch.models.vgg  # noqa: F401  (VGG16_*)
import split_learning_torch.models.resnet  # noqa: F401  (ResNet50_*)
import split_learning_torch.models.vit  # noqa: F401  (ViT_*)
import split_learning_torch.models.bert  # noqa: F401  (BERT_*)
import split_learning_torch.models.kwt  # noqa: F401  (KWT_*)

__all__ = [
    "LayerSpec", "SplitModel", "build_model", "model_registry",
    "register_model", "shard_params", "merge_shard_params", "num_layers",
]
