"""Inference entry points of the port."""

from segtpu_torch.infer.predict import (output_activation, predict,
                                        predict_proba)

__all__ = ["output_activation", "predict", "predict_proba"]
