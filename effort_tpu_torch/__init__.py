"""effort-tpu's PyTorch + CUDA port.

The same engine as the JAX package `effort_tpu` (bucketMul: an approximate
vector-matrix multiply whose runtime "effort" knob picks how much of each
weight matrix is read), written in PyTorch, with its kernels written by hand
for NVIDIA Hopper (CUDA C++ under `csrc/`, built on first use).

Layout mirrors the JAX package:
  - config:   configuration dataclasses (own copy, same JSON schema)
  - ops:      bucketized weight format, effort selection, bucketMul math
  - kernels:  kernel wrappers + plain PyTorch versions, the nvcc build
  - models:   decode forward pass, weight synthesis, generation engine
  - utils:    CUDA-event timing

Importing the package builds nothing and needs no GPU: kernels are built
the first time a CUDA tensor reaches them.
"""

__version__ = "0.1.0"

from effort_tpu_torch.config import BucketConfig, ModelConfig  # noqa: F401
