"""Faults planted under the timed path, for the tests and the readings
that show the comparison catches them (never used by a run):

- ``unchanged``: the training step returns its state as it got it (the
  loss is still the model's);
- ``half_batch``: the training loss is the mean over the first half of
  the batch's rows, the rest left out;
- ``token``: every token is replaced by its successor where the
  sampler produces it;
- ``seed``: the sampler draws every request's noise from seed 0, not
  from the request's own seed;
- ``temperature``: the sampler draws at half the request's temperature.

The exchange between chips has no fault here: every cell runs on one.
"""

from __future__ import annotations

import contextlib

TRAIN_FAULTS = ("unchanged", "half_batch")
SERVE_FAULTS = ("token", "seed", "temperature")


@contextlib.contextmanager
def planted(name: str, family: str):
    """Patch the program for the duration of the block; build the step or
    the engine inside it."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "half_batch" and family == "gpt":
        from deeplearning4j_tpu_torch.models import gpt
        orig = gpt.lm_loss

        def half(cfg, params, token_ids, *a, **kw):
            return orig(cfg, params, token_ids[:token_ids.shape[0] // 2],
                        *a, **kw)
        patch(gpt, "lm_loss", half)
    elif name == "half_batch" and family == "bert":
        from deeplearning4j_tpu_torch.models import bert
        orig = bert.mlm_loss

        def half(cfg, params, batch, *a, **kw):
            n = batch.token_ids.shape[0] // 2
            return orig(cfg, params, bert.Batch(*(t[:n] for t in batch)),
                        *a, **kw)
        patch(bert, "mlm_loss", half)
    elif name == "unchanged":
        import importlib
        fam = importlib.import_module(f"benchmark.families.{family}")
        orig_make = fam.make_train_step

        def make(cfg, optimizer, device):
            import torch
            prog = importlib.import_module(
                f"deeplearning4j_tpu_torch.models.{family}")
            loss_of = prog.lm_loss if family == "gpt" else prog.mlm_loss

            def step(state, batch, generator=None):
                with torch.no_grad():
                    return state, loss_of(cfg, state.params, batch)
            return step
        patch(fam, "make_train_step", make)
    elif name == "token":
        from deeplearning4j_tpu_torch.models import gpt
        orig = gpt.sample_token

        def shifted(logits, key, temperature):
            tok = orig(logits, key, temperature)
            return ((tok + 1) % logits.shape[-1]).to(tok.dtype)
        patch(gpt, "sample_token", shifted)
    elif name == "seed":
        from deeplearning4j_tpu_torch.models import gpt
        orig = gpt._slot_key

        def no_seed(seed, pos):
            return orig(seed * 0, pos)
        patch(gpt, "_slot_key", no_seed)
    elif name == "temperature":
        from deeplearning4j_tpu_torch.models import gpt
        orig = gpt.sample_token

        def half(logits, key, temperature):
            return orig(logits, key, temperature * 0.5)
        patch(gpt, "sample_token", half)
    else:
        raise ValueError(f"no fault {name!r} for family {family!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
