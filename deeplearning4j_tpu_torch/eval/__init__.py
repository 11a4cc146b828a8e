"""Evaluation of the port: multiclass metrics (counterpart of
``deeplearning4j_tpu/eval``)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    Evaluation, ConfusionMatrix)
