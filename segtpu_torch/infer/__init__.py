"""Inference entry points of the port: whole-image, tiled and TTA
inference, and the serving export (the HTTP server is
``segtpu_torch.infer.serve``)."""

from segtpu_torch.infer.export import (ServingModel, export_serving,
                                       load_serving, save_serving)
from segtpu_torch.infer.predict import (output_activation, predict,
                                        predict_proba)
from segtpu_torch.infer.tiled import (make_tiled_predictor,
                                      make_tiled_predictor_many,
                                      tiled_predict)
from segtpu_torch.infer.tta import (d4_average_apply, tta_predict,
                                    tta_predict_proba)

__all__ = ["ServingModel", "d4_average_apply", "export_serving",
           "load_serving", "make_tiled_predictor",
           "make_tiled_predictor_many", "output_activation", "predict",
           "predict_proba", "save_serving", "tiled_predict", "tta_predict",
           "tta_predict_proba"]
