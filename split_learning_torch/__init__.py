"""PyTorch/CUDA port of the split-learning framework.

The JAX package (``split_learning_tpu``) is the reference this port is
held against; module names and layout follow it so every counterpart is
easy to find.  The port imports ``torch`` and never JAX, and keeps its
own copies of the framework-free modules it needs (``config``,
``data``, ``planner``, ``runtime/log``).

Entry points run on the CUDA device unless the caller asks for the CPU
(:func:`split_learning_torch.device.resolve_device`).  The attention of
the TinyLlama decoder runs through hand-written CUDA flash-attention
kernels (``csrc/flash_attention.cu``) on the card, and through their
plain PyTorch versions for tensors on the CPU.
"""

__version__ = "0.1.0"
