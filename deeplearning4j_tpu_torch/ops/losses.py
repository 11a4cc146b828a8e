"""Loss functions: port of ``deeplearning4j_tpu/ops/losses.py``.

The same ``LossFunction`` names.  Every loss is computed in fp32 (inputs
may arrive in bf16) and reduced as a mean over rows; the per-example
forms give the unreduced ``[B]`` vector.  The fused softmax and sigmoid
cross-entropies take logits.
"""

from __future__ import annotations

import enum

import torch

Tensor = torch.Tensor

_EPS = 1e-10


class LossFunction(str, enum.Enum):
    MSE = "mse"
    EXPLL = "expll"                      # exponential log-likelihood (Poisson)
    XENT = "xent"                        # binary cross-entropy
    MCXENT = "mcxent"                    # multiclass cross-entropy
    RMSE_XENT = "rmse_xent"
    SQUARED_LOSS = "squared_loss"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"


def per_example_score(labels: Tensor, loss: LossFunction | str,
                      output: Tensor) -> Tensor:
    """Per-row losses, shape ``labels.shape[:-1]``; :func:`score` is
    their mean.  ``output`` is the post-activation prediction."""
    loss = LossFunction(loss)
    labels = labels.float()
    output = output.float()

    if loss in (LossFunction.MSE, LossFunction.SQUARED_LOSS):
        per = torch.sum((labels - output) ** 2, dim=-1)
        if loss is LossFunction.MSE:
            per = per / labels.shape[-1]
        return per
    if loss is LossFunction.RMSE_XENT:
        return torch.sqrt(torch.sum((labels - output) ** 2, dim=-1) + _EPS)
    if loss in (LossFunction.XENT, LossFunction.RECONSTRUCTION_CROSSENTROPY):
        p = torch.clamp(output, _EPS, 1.0 - _EPS)
        return -torch.sum(labels * torch.log(p)
                          + (1.0 - labels) * torch.log1p(-p), dim=-1)
    if loss in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        p = torch.clamp(output, _EPS, 1.0)
        return -torch.sum(labels * torch.log(p), dim=-1)
    if loss is LossFunction.EXPLL:
        # Poisson NLL: output - labels * log(output)
        p = torch.clamp(output, min=_EPS)
        return torch.sum(p - labels * torch.log(p), dim=-1)
    if loss is LossFunction.COSINE_PROXIMITY:
        num = torch.sum(labels * output, dim=-1)
        den = (torch.linalg.norm(labels, dim=-1)
               * torch.linalg.norm(output, dim=-1) + _EPS)
        return -(num / den)
    raise ValueError(f"unhandled loss {loss}")


def score(labels: Tensor, loss: LossFunction | str, output: Tensor) -> Tensor:
    """Mean loss over the rows."""
    return torch.mean(per_example_score(labels, loss, output))


def per_example_softmax_cross_entropy_with_logits(labels: Tensor,
                                                  logits: Tensor) -> Tensor:
    """Per-row MCXENT on logits, through ``log_softmax``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(labels.float() * logp, dim=-1)


def softmax_cross_entropy_with_logits(labels: Tensor,
                                      logits: Tensor) -> Tensor:
    return torch.mean(per_example_softmax_cross_entropy_with_logits(
        labels, logits))


def per_example_sigmoid_binary_cross_entropy_with_logits(
        labels: Tensor, logits: Tensor) -> Tensor:
    logits = logits.float()
    labels = labels.float()
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.sum(per, dim=-1)


def sigmoid_binary_cross_entropy_with_logits(labels: Tensor,
                                             logits: Tensor) -> Tensor:
    return torch.mean(per_example_sigmoid_binary_cross_entropy_with_logits(
        labels, logits))
