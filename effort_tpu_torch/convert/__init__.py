"""Offline conversion of HF checkpoints to the bucket format, and the
activation calibration that feeds its baked relayout."""

from effort_tpu_torch.convert.convert import (  # noqa: F401
    HF_NAME_MAPS, config_from_hf, convert_checkpoint)
