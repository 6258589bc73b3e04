"""Datasets and loaders (framework-free copies of the JAX package's
``data`` modules; batches are numpy arrays, byte-equal to the
reference's for the same seeds)."""

from split_learning_torch.data.loader import (
    ArrayDataset, DataLoader, cifar_augment, label_count_subset, subset_seed,
)
from split_learning_torch.data.datasets import (
    get_dataset, make_data_loader, register_dataset, dataset_registry,
)

__all__ = [
    "ArrayDataset", "DataLoader", "cifar_augment", "label_count_subset",
    "subset_seed", "get_dataset", "make_data_loader", "register_dataset",
    "dataset_registry",
]
