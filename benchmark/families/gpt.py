"""The GPT family: the program's ``models/gpt`` under a configuration in
the layout of ``openai-community/gpt2``'s ``config.json``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.families.weights import Leaf
from benchmark.reference import transformer as ref
from benchmark.traffic import generators


def sizes(conf: Dict[str, Any]) -> Dict[str, int]:
    H = conf["n_embd"]
    return {"layers": conf["n_layer"], "hidden": H, "heads": conf["n_head"],
            "head_dim": H // conf["n_head"],
            "ffn": conf.get("n_inner") or 4 * H,
            "vocab": conf["vocab_size"], "max_len": conf["n_positions"],
            "eps": conf["layer_norm_epsilon"]}


def port_config(conf: Dict[str, Any]):
    """The program's config: ``gpt.gpt_config`` at the published widths,
    with the file's LayerNorm epsilon, dropout, compute dtype and
    recomputation."""
    from deeplearning4j_tpu_torch.models import gpt

    s = sizes(conf)
    port = conf["port"]
    cfg = gpt.gpt_config(vocab_size=s["vocab"], max_len=s["max_len"],
                         hidden=s["hidden"], n_layers=s["layers"],
                         n_heads=s["heads"])
    return dataclasses.replace(
        cfg, ffn_dim=s["ffn"], layer_norm_eps=s["eps"],
        dropout=conf["resid_pdrop"], compute_dtype=port["compute_dtype"],
        remat=port["remat"])


def leaves(conf: Dict[str, Any]) -> List[Leaf]:
    s = sizes(conf)
    L, H, NH, D, Fd = (s["layers"], s["hidden"], s["heads"], s["head_dim"],
                       s["ffn"])
    return [
        ("embed", "tok", (s["vocab"], H), "matrix"),
        ("embed", "pos", (s["max_len"], H), "matrix"),
        ("embed", "type", (1, H), "matrix"),
        ("embed", "ln_g", (H,), "gain"), ("embed", "ln_b", (H,), "bias"),
        ("blocks", "wq", (L, H, NH, D), "matrix"),
        ("blocks", "wk", (L, H, NH, D), "matrix"),
        ("blocks", "wv", (L, H, NH, D), "matrix"),
        ("blocks", "wo", (L, NH, D, H), "matrix"),
        ("blocks", "bq", (L, NH, D), "bias"),
        ("blocks", "bk", (L, NH, D), "bias"),
        ("blocks", "bv", (L, NH, D), "bias"),
        ("blocks", "bo", (L, H), "bias"),
        ("blocks", "ln1_g", (L, H), "gain"),
        ("blocks", "ln1_b", (L, H), "bias"),
        ("blocks", "w1", (L, H, Fd), "matrix"),
        ("blocks", "b1", (L, Fd), "bias"),
        ("blocks", "w2", (L, Fd, H), "matrix"),
        ("blocks", "b2", (L, H), "bias"),
        ("blocks", "ln2_g", (L, H), "gain"),
        ("blocks", "ln2_b", (L, H), "bias"),
    ]


# -- training ---------------------------------------------------------------

def make_train_step(cfg, optimizer, device):
    from deeplearning4j_tpu_torch.models import gpt
    _, step_fn = gpt.make_train_step(cfg, optimizer=optimizer,
                                     device=device)
    return step_fn


def batches(traffic: Dict[str, Any], conf: Dict[str, Any], seed: int,
            device) -> List[torch.Tensor]:
    ids = generators.lm_packed(traffic, conf["vocab_size"], seed)
    dev = torch.from_numpy(ids).to(device)
    return list(dev.unbind(0))


def shape(traffic: Dict[str, Any], conf: Dict[str, Any]) -> Dict[str, Any]:
    return {**sizes(conf), "batch": traffic["batch"], "seq": traffic["seq"],
            "causal": True, "key_mask": False}


def targets(batch: torch.Tensor) -> float:
    """The number of predicted positions the loss averages over."""
    return float(batch.shape[0] * (batch.shape[1] - 1))


def reference_loss_sum(params, batch: torch.Tensor, rows: slice, eps: float,
                       mm) -> torch.Tensor:
    return ref.gpt_loss_sum(params, batch[rows], eps, mm)


def n_rows(batch: torch.Tensor) -> int:
    return batch.shape[0]


# -- serving ----------------------------------------------------------------

def reference_logits(params, ids: np.ndarray, eps: float, mm,
                     device) -> torch.Tensor:
    """``[T, V]`` logits of one sequence."""
    t = torch.from_numpy(np.asarray(ids, np.int64))[None].to(device)
    return ref.gpt_logits(params, t, eps, mm)[0]
