"""Causal-LM training through the sharded-fit spine.

Port of ``deeplearning4j_tpu/models/lm_fit.py``: :class:`CausalLM`, a
GPT (``TransformerConfig``) or Mixture-of-Experts
(``MoETransformerConfig``) causal LM in the trainable surface the
data-parallel training loops use (the ``MultiLayerNetwork`` duck type:
``_backprop_machinery``, ``_init_ustate``, ``_pad_chunk``,
``_pad_rows``, ``_notify_fit_start``, ``_note_skips``,
``conf.grad_accum``), so ``runtime/resilience.ResilientFit`` drives it
with snapshots, rollback and exact resume.

The step (built by ``parallel/sharded_fit``) is the reference's:

- batches are ``DataSet(token_ids, token_ids)``, ids ``[B, T]`` int32;
  the targets are the ids shifted by one;
- the loss is the masked next-token NLL SUM (zero-padded rows weigh 0),
  plus for MoE ``aux_loss_weight * aux * valid targets``, divided once
  by the global count of valid targets, which also undoes the loss
  scale under bf16;
- ``grad_accum`` microbatches accumulate in fp32; under a data mesh the
  loss sum and the gradients are summed over the data axis before the
  divide, and the guard's verdict comes after the sum;
- the update is SGD with momentum (``m = mu m + g``, ``p -= lr m``)
  with fp32 state mirroring the params; ``mixed_precision="bf16"``
  casts the fp32 masters inside the differentiated function and threads
  the dynamic loss scale through the updater state (``(momentum,
  {"scale", "good_steps"})``), its transition bypassing the guard.

**Attention.**  The step's attention is
``ops/flash_attention.make_attn_fn("auto")``, the port's rule for every
trainer: on the card the flash kernels (B1 forward, again in the
recompute under ``cfg.remat``; B2 and B3 backward), on the CPU the plain
attention.  This differs from the reference, whose step takes XLA's
attention on a mesh of one (``lm_fit.py:200-205``); the plain attention
the CPU runs is what the reference computes there.

A rank's dropout stream is a generator seeded ``fold(seed, rank)``
(``rank``: the data index, 0 without a mesh), so a mesh of one trains
bit for bit as ``mesh=None`` and the ranks of a model group draw the
same masks.  The params keep the reference's tree, so
``runtime/checkpoint``'s ``save_pytree`` / ``load_pytree`` carry them
between the packages; ``params_flat`` walks the leaves in JAX's order
(dict keys sorted).

**The model axis** (the GPT family on a ``data x model`` mesh, run
SPMD: every rank makes the same calls with the same batches): the
step's params and momentum are laid out by ``gpt.shard_specs`` (heads
and the ffn axis over ``model``, the tied embedding over vocab when the
degree divides it), the forward carries the ``tensor_parallel``
collectives, gradients are summed over the data axis only, and the
guard's verdict is reduced over the whole mesh.  ``self.params`` is
the global tree on every rank: a fit lays it out (``shard_tree``) and
gathers the result back (``gather_tree``), so ``params_flat`` and the
checkpoints are the ``mesh=None`` ones.

**The MoE family on a mesh** (the reference's :183-212): the params
are laid out by ``moe.shard_specs`` and every MoE layer dispatches
through ``parallel/expert.make_gspmd_moe_ffn``.  On a ``model`` axis
the expert tables split over ``model``: each rank runs its ``E / m``
experts on the replicated tokens and the combine's sum over experts is
one all-reduce over ``model``.  On a ``data x expert`` mesh the rows of
a data index are replicated over its expert group; each MoE layer
routes the rank's block of their tokens, moves them to their experts
by all-to-all and gathers the outputs back, so every other leaf's
gradient is the same on the group's ranks, and all gradients sum over
``data`` only (the expert tables' already hold every shard's
contribution).  Capacity is the block's own, as in the reference.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP
item): ``pipe_microbatches > 1`` (the pipeline, A7.1b) and meshes with
pipe or seq axes above 1 (A7.1b, A7.5).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import gpt
from deeplearning4j_tpu_torch.models import moe as moe_lm
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.models.moe import MoETransformerConfig
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.ops.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel import (collectives, sharded_fit,
                                               tensor_parallel as tpar)
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                    check_mesh_axes,
                                                    expert_degree,
                                                    mesh_signature,
                                                    model_degree, pad_rows,
                                                    shard_rows)
from deeplearning4j_tpu_torch.runtime import compile_cache, resilience, \
    telemetry
from deeplearning4j_tpu_torch.runtime.metrics import dp_metrics

Tensor = torch.Tensor
PyTree = Any

MIXED_PRECISION_POLICIES = ("off", "bf16")


class _LMConf:
    """The mutable conf surface the data-parallel training loops read."""

    __slots__ = ("grad_accum",)

    def __init__(self, grad_accum: int = 1):
        self.grad_accum = grad_accum


def _sorted_leaves(tree) -> List[Tensor]:
    """Leaves in JAX's flatten order: every dict's keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in
                _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _sorted_leaves(v)]
    return [tree]


class CausalLM:
    """A GPT-family or MoE causal LM with the sharded-fit trainable
    surface (module docstring).  ``device`` (None = CUDA, raising
    without it) holds the params and runs the steps."""

    def __init__(self, cfg: Union[TransformerConfig, MoETransformerConfig],
                 *, lr: float = 0.1, momentum: float = 0.0,
                 mixed_precision: str = "off", grad_accum: int = 1,
                 pipe_microbatches: int = 1, device: DeviceLike = None):
        if not cfg.causal:
            raise ValueError("CausalLM needs a causal TransformerConfig")
        if mixed_precision not in MIXED_PRECISION_POLICIES:
            raise ValueError(
                f"mixed_precision must be one of "
                f"{MIXED_PRECISION_POLICIES}, got {mixed_precision!r}")
        if pipe_microbatches < 1:
            raise ValueError(
                f"pipe_microbatches must be >= 1, got {pipe_microbatches}")
        if pipe_microbatches > 1:
            raise NotImplementedError(
                "pipe_microbatches > 1 (the GPipe schedule of a pipe mesh) "
                "is not ported to the PyTorch package yet (ROADMAP A7.1b)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.mixed_precision = mixed_precision
        self.pipe_microbatches = int(pipe_microbatches)
        self.conf = _LMConf(grad_accum)
        self.params: Optional[PyTree] = None
        self.listeners: List = []
        self.guard_skips = 0
        #: the dynamic loss scale ``{"scale", "good_steps"}`` after the
        #: last fit (None when mixed precision is off)
        self.loss_scale: Optional[dict] = None
        self._bp_cache = {}

    @property
    def _is_moe(self) -> bool:
        return isinstance(self.cfg, MoETransformerConfig)

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> "CausalLM":
        """Fresh params from ``seed``, drawn on the device (the draws
        are not JAX's: carry JAX's params through the checkpoint
        format)."""
        fam = moe_lm if self._is_moe else gpt
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = fam.init_params(gen, self.cfg, self.device)
        return self

    def _require_params(self) -> PyTree:
        if self.params is None:
            self.init()
        return self.params

    def params_flat(self) -> Tensor:
        """Every leaf as one flat fp32 CPU tensor, in JAX's leaf order:
        the cross-run and cross-package equality probe."""
        return torch.cat([t.detach().reshape(-1).float().cpu()
                          for t in _sorted_leaves(self._require_params())])

    def num_param_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self._require_params()))

    # -- machinery ---------------------------------------------------------
    def _conf_signature(self):
        return ("causal_lm", repr(self.cfg), self.lr, self.momentum,
                self.mixed_precision, self.pipe_microbatches)

    def _mp_on(self) -> bool:
        return self.mixed_precision == "bf16"

    @staticmethod
    def _init_ustate(train_step, updaters, params):
        return train_step.init_ustate(params)

    def _backprop_machinery(self, mesh=None):
        """``(train_step, ())``: the data-parallel engine step
        ``train_step(params, ustate, iteration, (ids, ids, n_valid),
        gen)`` shared module-wide by (config signature, mesh signature,
        accumulation); the SGD + momentum update is inside it, so there
        are no per-layer updaters.  ``train_step.epochs`` is the staged
        fit loop and ``train_step.init_ustate`` builds the state.  On a
        model axis the step takes this rank's slice of the params and
        momentum (``train_step.param_specs`` / ``.ustate_specs``, the
        layout ``shard_state`` / ``gather_state`` apply)."""
        check_mesh_axes(mesh)
        accum = max(self.conf.grad_accum, 1)
        memo_key = (mesh_signature(mesh), accum)
        if memo_key not in self._bp_cache:
            self._bp_cache[memo_key] = compile_cache.get_or_build(
                ("lm_backprop", self._conf_signature(), str(self.device))
                + memo_key, lambda: self._build_machinery(mesh, accum))
        return self._bp_cache[memo_key], ()

    def _build_machinery(self, mesh, accum: int):
        from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
        from deeplearning4j_tpu_torch.parallel.expert import \
            make_gspmd_moe_ffn

        cfg = self.cfg
        lr, mu = self.lr, self.momentum
        mp_on = self._mp_on()
        is_moe = self._is_moe
        rank = mesh.rank if mesh is not None else 0
        attn_fn = make_attn_fn("auto", mesh=mesh)
        moe_ffn_fn = make_gspmd_moe_ffn(mesh, cfg.moe) if is_moe else None
        tp = tpar.model_group(mesh)
        if is_moe and (tp is not None or expert_degree(mesh) > 1):
            specs = moe_lm.shard_specs(cfg, model_degree(mesh),
                                       expert_degree=expert_degree(mesh))
        else:
            specs = gpt.shard_specs(cfg, model_degree(mesh)) if tp else None
        agree = sharded_fit.agree_over_mesh(mesh)

        def loss_sum(params, ids, rmask, gen):
            """Masked next-token NLL SUM (+ the MoE aux scaled by the
            valid count): the unit microbatches and ranks sum."""
            if mp_on:
                params = sharded_fit.mp_cast(params)
            if is_moe:
                hidden, aux = moe_lm.encode(cfg, params, ids, attn_fn,
                                            moe_ffn_fn, tp)
            else:
                hidden = tfm.encode(cfg, params, ids, None, None, gen,
                                    attn_fn=attn_fn, tp=tp)
            logits = gpt.lm_logits(cfg, params, hidden[:, :-1], tp)
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, ids[:, 1:].long()[..., None])[..., 0]
            nll = -torch.sum(ll * rmask[:, None])
            if is_moe:
                count = torch.sum(rmask) * (ids.shape[1] - 1)
                nll = nll + cfg.aux_loss_weight * aux * count
            return nll

        def grads_of(params, ids, rmask, gen, scale):
            """(unscaled loss sum, fp32 grads of the scaled sum)."""
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            params)
            with torch.enable_grad():
                s = loss_sum(live, ids, rmask, gen)
                obj = s * scale if mp_on else s
            g = torch.autograd.grad(obj, tree_leaves(live),
                                    allow_unused=True, materialize_grads=True)
            return s.detach(), list(g)

        def dp_step(params, ustate, batch, gen, iteration):
            if mp_on:
                mom, ls = ustate
                scale = ls["scale"]
            else:
                mom, ls, scale = ustate, None, None
            ids, _, n_valid = batch          # the labels are the ids
            B, T = ids.shape
            rmask = ((rank * B + torch.arange(B, device=ids.device))
                     < n_valid).float()
            count = n_valid.float() * (T - 1)
            if accum == 1:
                lsum, grads = grads_of(params, ids, rmask, gen, scale)
            else:
                mb = B // accum
                lsum, grads = None, None
                for i in range(accum):
                    sl = slice(i * mb, (i + 1) * mb)
                    s, g = grads_of(params, ids[sl], rmask[sl], gen, scale)
                    if grads is None:
                        # fp32 accumulators, zero-started as the
                        # reference's scan carry
                        grads = [torch.zeros(gg.shape, dtype=torch.float32,
                                             device=gg.device) + gg.float()
                                 for gg in g]
                        lsum = 0.0 + s
                    else:
                        grads = [a + gg.float() for a, gg in zip(grads, g)]
                        lsum = lsum + s
            if mesh is not None:
                lsum, grads = collectives.psum((lsum, grads), mesh)
            denom = torch.clamp(count, min=1.0)
            score = lsum / denom
            gdenom = denom * scale if mp_on else denom
            grads = [g / gdenom for g in grads]
            new_mom = [mu * m + g for m, g in zip(tree_leaves(mom), grads)]
            new_params = [p - lr * m for p, m in
                          zip(tree_leaves(params), new_mom)]
            new_params, new_mom, skipped = resilience.guard_update(
                tree_leaves(params), tree_leaves(mom), new_params, new_mom,
                (score, grads), agree=agree)
            new_params = _like(params, new_params)
            new_mom = _like(mom, new_mom)
            if mp_on:
                return (new_params,
                        (new_mom, sharded_fit.next_loss_scale(ls, skipped)),
                        score, skipped)
            return new_params, new_mom, score, skipped

        ustate_specs = specs
        if specs is not None and mp_on:
            ustate_specs = (specs, {"scale": tpar.P(),
                                    "good_steps": tpar.P()})
        step = sharded_fit.build_sharded_step(
            dp_step, mesh, label="lm.train_step", param_specs=specs,
            ustate_specs=ustate_specs)
        epochs = sharded_fit.build_scanned_epochs(
            dp_step, mesh, label="lm.train_epochs", step=step)

        def init_ustate(params):
            mom = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            if mp_on:
                return (mom, sharded_fit.init_loss_scale(
                    tree_leaves(params)[0].device))
            return mom

        def shard_state(tree, which="params"):
            """This rank's slice of a global params (or updater state)
            tree."""
            sp = specs if which == "params" else ustate_specs
            return tree if sp is None else tpar.shard_tree(tree, sp, mesh)

        def gather_state(tree, which="params"):
            """The global tree back from this rank's slice."""
            sp = specs if which == "params" else ustate_specs
            return tree if sp is None else tpar.gather_tree(tree, sp, mesh)

        step.takes_n_valid = True
        step.init_ustate = init_ustate
        step.mixed_precision = mp_on
        step.epochs = epochs
        step.shard_state = shard_state
        step.gather_state = gather_state
        return step

    # -- training-loop hooks (shared with MultiLayerNetwork) ---------------
    def _pad_chunk(self, mesh, accum: int) -> int:
        ndp = mesh.shape[DATA_AXIS] if mesh is not None else 1
        return ndp * max(accum, 1) * self.pipe_microbatches

    @staticmethod
    def _pad_rows(arr, target: int) -> Tensor:
        return pad_rows(arr, target)

    def _notify_fit_start(self) -> None:
        for ls in self.listeners:
            hook = getattr(ls, "on_fit_start", None)
            if callable(hook):
                hook(self)

    def _note_skips(self, skips) -> None:
        self.guard_skips += resilience.note_skips(skips, where="lm")

    # -- fit ---------------------------------------------------------------
    def fit_backprop(self, data: Union[DataSet, Sequence[DataSet]],
                     num_epochs: int = 1, seed: int = 2,
                     mesh=None) -> None:
        """Train on ``data`` (``DataSet(ids, ids)`` batches, the same
        list on every rank): each batch zero-padded to the shard x accum
        multiple, stacked, cut to this rank's rows and staged on the
        device once; then the captured step replays for every (epoch,
        batch).  Listeners are replayed from the per-step losses
        afterwards."""
        batches = [data] if isinstance(data, DataSet) else list(data)
        if not batches:
            return
        check_mesh_axes(mesh)
        self._notify_fit_start()
        accum = max(self.conf.grad_accum, 1)
        chunk = self._pad_chunk(mesh, accum)
        ndp = mesh.shape[DATA_AXIS] if mesh is not None else 1
        step, _ = self._backprop_machinery(mesh)
        params = step.shard_state(tree_map(torch.clone,
                                           self._require_params()))
        ustate = step.init_ustate(params)
        sizes = [int(b.features.shape[0]) for b in batches]
        if min(sizes) < ndp:
            raise ValueError(
                f"batch of {min(sizes)} cannot shard over data-parallel "
                f"degree {ndp}: every device needs at least one example")
        target = max(-(-s // chunk) * chunk for s in sizes)
        with telemetry.span("lm.stage", batches=len(batches),
                            sharded=mesh is not None):
            xs = torch.stack([
                self._pad_rows(torch.as_tensor(b.features).to(torch.int32),
                               target) for b in batches])
            if mesh is not None:
                xs = shard_rows(xs, mesh, 1)
            xs = xs.to(self.device)
            nvs = torch.tensor(sizes, dtype=torch.int32, device=self.device)
        it = torch.zeros((), dtype=torch.int32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            resilience.fold(seed, mesh.rank if mesh is not None else 0))
        with telemetry.span("lm.dispatch", staged=True, data_degree=ndp,
                            accum=accum, steps=num_epochs * len(batches)):
            params, ustate, it, scores, skips = step.epochs(
                params, ustate, it, (xs, xs, nvs), gen, num_epochs)
            dp_metrics.note_dispatch(steps=int(scores.numel()), accum=accum,
                                     data_degree=ndp)
            self._note_skips(skips)
        if self.listeners:
            for j, s in enumerate(scores.reshape(-1).tolist()):
                for ls in self.listeners:
                    ls.iteration_done(self, j, s)
        # the API boundary: the step's state is the engine's
        self.params = tree_map(torch.clone, step.gather_state(params))
        self.loss_scale = (tree_map(torch.clone, ustate[1]) if self._mp_on()
                           else None)


def _like(tree, leaves: List[Tensor]):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
