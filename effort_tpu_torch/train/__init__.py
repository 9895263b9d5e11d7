"""Training: train small Mistral-family models in the port, export HF
safetensors, and feed the convert -> serve -> eval pipeline, so that
quality at an effort can be measured on weights with real margins."""

from effort_tpu_torch.train.trainer import (TrainConfig,
                                            byte_corpus_from_files,
                                            export_hf, forward, init_params,
                                            next_token_loss, train)

__all__ = ["TrainConfig", "byte_corpus_from_files", "export_hf",
           "forward", "init_params", "next_token_loss", "train"]
