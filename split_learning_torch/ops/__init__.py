"""Tensor ops: FedAvg folds and the flash-attention kernels."""
