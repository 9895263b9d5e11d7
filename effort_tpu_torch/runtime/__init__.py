"""Host runtime: safetensors IO, the tokenizers and the C++ helper that
backs them (native/, built at first use)."""

from effort_tpu_torch.runtime.safetensors_io import (  # noqa: F401
    MultiShardReader, SafeTensorReader, SafeTensorWriter)
