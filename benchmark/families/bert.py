"""The BERT family: the program's ``models/bert`` under a configuration
in the layout of ``google-bert/bert-base-uncased``'s ``config.json``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from benchmark.families.weights import Leaf
from benchmark.reference import transformer as ref
from benchmark.traffic import generators


def sizes(conf: Dict[str, Any]) -> Dict[str, int]:
    H = conf["hidden_size"]
    return {"layers": conf["num_hidden_layers"], "hidden": H,
            "heads": conf["num_attention_heads"],
            "head_dim": H // conf["num_attention_heads"],
            "ffn": conf["intermediate_size"], "vocab": conf["vocab_size"],
            "max_len": conf["max_position_embeddings"],
            "types": conf["type_vocab_size"], "eps": conf["layer_norm_eps"]}


def port_config(conf: Dict[str, Any]):
    """``bert.bert_base``'s config with the file's sizes, dropout,
    compute dtype and recomputation."""
    from deeplearning4j_tpu_torch.models import bert

    s = sizes(conf)
    port = conf["port"]
    return dataclasses.replace(
        bert.bert_base(), vocab_size=s["vocab"], max_len=s["max_len"],
        type_vocab_size=s["types"], hidden=s["hidden"],
        n_layers=s["layers"], n_heads=s["heads"], ffn_dim=s["ffn"],
        dropout=conf["hidden_dropout_prob"], layer_norm_eps=s["eps"],
        compute_dtype=port["compute_dtype"], remat=port["remat"])


def leaves(conf: Dict[str, Any]) -> List[Leaf]:
    s = sizes(conf)
    L, H, NH, D, Fd, V = (s["layers"], s["hidden"], s["heads"],
                          s["head_dim"], s["ffn"], s["vocab"])
    return [
        ("embed", "tok", (V, H), "matrix"),
        ("embed", "pos", (s["max_len"], H), "matrix"),
        ("embed", "type", (s["types"], H), "matrix"),
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
        ("mlm", "w", (H, H), "matrix"), ("mlm", "b", (H,), "bias"),
        ("mlm", "ln_g", (H,), "gain"), ("mlm", "ln_b", (H,), "bias"),
        ("mlm", "out_b", (V,), "bias"),
        ("pooler", "w", (H, H), "matrix"), ("pooler", "b", (H,), "bias"),
    ]


def make_train_step(cfg, optimizer, device):
    from deeplearning4j_tpu_torch.models import bert
    _, step_fn = bert.make_train_step(cfg, optimizer=optimizer,
                                      device=device)
    return step_fn


_FIELDS = ("token_ids", "attention_mask", "type_ids", "labels", "mlm_mask")


def batches(traffic: Dict[str, Any], conf: Dict[str, Any], seed: int,
            device) -> list:
    """The program's ``bert.Batch`` tuples, on the device."""
    from deeplearning4j_tpu_torch.models import bert

    raw = generators.mlm_pairs(traffic, conf["vocab_size"], seed)
    cols = [torch.from_numpy(a).to(device).unbind(0) for a in raw]
    return [bert.Batch(*parts) for parts in zip(*cols)]


def shape(traffic: Dict[str, Any], conf: Dict[str, Any]) -> Dict[str, Any]:
    return {**sizes(conf), "batch": traffic["batch"], "seq": traffic["seq"],
            "causal": False, "key_mask": True}


def targets(batch) -> float:
    return max(float(batch.mlm_mask.sum().item()), 1.0)


def reference_loss_sum(params, batch, rows: slice, eps: float,
                       mm) -> torch.Tensor:
    part = {f: getattr(batch, f)[rows] for f in _FIELDS}
    return ref.bert_loss_sum(params, part, eps, mm)


def n_rows(batch) -> int:
    return batch.token_ids.shape[0]
