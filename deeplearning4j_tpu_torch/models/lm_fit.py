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
- ``n_micro = grad_accum * pipe_microbatches`` slices of the batch are
  walked in order, their gradients accumulated in fp32 (:254-283) at
  any mesh; under a data mesh the loss sum and the gradients are summed
  over the data axis before the divide, and the guard's verdict comes
  after the sum;
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

**The pipe axis** (the reference lays the stacked blocks out
stage-major over ``pipe``, ``shard_specs(pipe_degree=)``, and lets XLA
move the activations; the port runs the GPipe schedule of
``parallel/pipeline.run_schedule``): a rank holds its stage's
contiguous layers and runs them for each slice; activations go forward
by ``collectives.ring_permute`` and their gradients come back through
its backward.  Stage 0 embeds, the last stage applies the tied readout
and the loss, and the MoE family's stages each add their layers' aux.
The reference's contract (``sharded_fit.py:42-46``) holds: a change of
pipe degree alone is a pure layout change, the fit at ``pipe=2``
``torch.equal`` to the one at ``pipe=1``.  The port keeps ``pipe=1``'s
reduction order for that: every tick's block weights enter the graph
as a leaf of their own, so each slice's gradient comes out whole and
the slices accumulate in order; the replicated embedding's two halves
(stage 0's lookup, the last stage's readout) are summed over ``pipe``
slice by slice, as autograd sums them at ``pipe=1``; and the dropout
masks are drawn by every stage for every layer in ``pipe=1``'s order,
each stage keeping its own.  The guard's verdict is agreed over the
whole mesh.

**The seq axis** (the reference's ``test_seq_sharded_fit_matches_
reference``): a rank holds its ``T / seq`` tokens of each row through
the whole stack (embedded at their absolute positions), attention is
ring attention (``make_attn_fn("auto", mesh)``), the target of a
block's last position is the next block's first token (every rank has
the rows' global ids), and the NLL sum and the replicated gradients
are summed over ``("data", "seq")``.  The dropout masks are drawn a
rank of the block it holds, so with dropout they are not
``mesh=None``'s.
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
from deeplearning4j_tpu_torch.ops.updaters import (tree_leaves, tree_map,
                                                   tree_unflatten)
from deeplearning4j_tpu_torch.parallel import (collectives, pipeline,
                                               sharded_fit,
                                               tensor_parallel as tpar)
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS,
                                                    SEQ_TOKEN_AXES,
                                                    check_mesh_axes,
                                                    expert_degree,
                                                    mesh_signature,
                                                    model_degree, pad_rows,
                                                    pipe_degree, seq_degree,
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
        n_micro = accum * self.pipe_microbatches
        p_deg, s_deg = pipe_degree(mesh), seq_degree(mesh)
        attn_fn = make_attn_fn("auto", mesh=mesh)
        moe_ffn_fn = make_gspmd_moe_ffn(mesh, cfg.moe) if is_moe else None
        tp = tpar.model_group(mesh)
        if is_moe and (tp is not None or expert_degree(mesh) > 1
                       or p_deg > 1):
            specs = moe_lm.shard_specs(cfg, model_degree(mesh), p_deg,
                                       expert_degree=expert_degree(mesh))
        elif tp is not None or p_deg > 1:
            specs = gpt.shard_specs(cfg, model_degree(mesh), p_deg)
        else:
            specs = None
        agree = sharded_fit.agree_over_mesh(mesh)
        # the gradients' and the loss's sum: over data, and over the
        # sequence blocks on a seq axis
        dp_axis = (mesh, SEQ_TOKEN_AXES) if s_deg > 1 else mesh

        def cast(tree):
            return sharded_fit.mp_cast(tree) if mp_on else tree

        def tokens(ids):
            """``(this rank's tokens, their targets, position offset)``:
            the whole rows without a seq axis (targets shifted by one),
            else the rank's block; the last block has one target less."""
            T = ids.shape[1]
            if s_deg == 1:
                return ids, ids[:, 1:], 0
            if T % s_deg:
                raise ValueError(f"sequence of {T} tokens does not split "
                                 f"over a seq axis of {s_deg}")
            tl = T // s_deg
            off = mesh.seq_rank * tl
            return (ids[:, off:off + tl], ids[:, off + 1:min(off + tl + 1, T)],
                    off)

        def nll_sum(embed_p, hidden, targets, rmask):
            """The masked NLL sum of ``hidden``'s first ``targets``
            positions through the tied readout."""
            n = targets.shape[1]
            logits = gpt.lm_logits(cfg, {"embed": embed_p}, hidden[:, :n],
                                   tp)
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
            return -torch.sum(ll * rmask[:, None])

        def aux_count(ids, rmask):
            return torch.sum(rmask) * (ids.shape[1] - 1)

        def loss_sum(params, ids, rmask, gen):
            """Masked next-token NLL SUM (+ the MoE aux scaled by the
            valid count): the unit microbatches and ranks sum."""
            params = cast(params)
            loc, targets, off = tokens(ids)
            if is_moe:
                hidden, aux = moe_lm.encode(cfg, params, loc, attn_fn,
                                            moe_ffn_fn, tp, off)
            else:
                hidden = tfm.encode(cfg, params, loc, None, None, gen,
                                    attn_fn=attn_fn, tp=tp,
                                    position_offset=off)
            nll = nll_sum(params["embed"], hidden, targets, rmask)
            if is_moe:
                nll = nll + cfg.aux_loss_weight * aux * aux_count(ids, rmask)
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

        def pipe_slices(params, ids, rmask, gen, scale):
            """Each slice's ``(loss sum, grads)`` on a pipe mesh: one
            GPipe schedule over the ``n_micro`` slices (module
            docstring), the embedding's gradients summed over ``pipe``
            slice by slice."""
            mb = ids.shape[0] // n_micro
            s = mesh.pipe_rank
            L = cfg.n_layers
            lps = L // p_deg

            def leaves_of(tree):
                return [tree_map(lambda t: t.detach().requires_grad_(True),
                                 tree) for _ in range(n_micro)]

            emb = leaves_of(params["embed"])
            blk = leaves_of(params["blocks"])
            sl = [slice(i * mb, (i + 1) * mb) for i in range(n_micro)]
            toks = [tokens(ids[q]) for q in sl]
            like = torch.empty((mb, toks[0][0].shape[1], cfg.hidden),
                               device=ids.device)
            masks = None
            if not is_moe and gen is not None and cfg.dropout > 0.0:
                masks = [[tfm._dropout_masks(cfg, like, gen)
                          for _ in range(L)][s * lps:(s + 1) * lps]
                         for _ in range(n_micro)]
            terms, sums = [], [torch.zeros((), device=ids.device)
                               for _ in range(n_micro)]

            def add(i, term):
                terms.append(term * scale if mp_on else term)
                sums[i] = sums[i] + term.detach()

            def inject(i):
                loc, _, off = toks[i]
                return tfm.embed(cfg, {"embed": cast(emb[i])}, loc, None,
                                 off, tp=tp)

            def stage(i, x):
                p = cast(blk[i])
                if not is_moe:
                    return tfm.run_blocks(cfg, p, x, None, None, attn_fn, tp,
                                          masks[i] if masks else None)
                x, auxs = moe_lm.run_blocks(cfg, p, x, attn_fn, moe_ffn_fn,
                                            tp)
                add(i, cfg.aux_loss_weight * auxs.sum() / L
                    * aux_count(ids[sl[i]], rmask[sl[i]]))
                return x

            def emit(i, y):
                add(i, nll_sum(cast(emb[i]), y, toks[i][1], rmask[sl[i]]))

            with torch.enable_grad():
                anchor = pipeline.run_schedule(stage, n_micro,
                                               (mesh, PIPE_AXIS), inject,
                                               like, emit, tie=blk[0])
                obj = 0.0 * anchor.sum()
                for term in terms:
                    obj = obj + term
            g = torch.autograd.grad(
                obj, tree_leaves(emb) + tree_leaves(blk), allow_unused=True,
                materialize_grads=True)
            n_emb = len(tree_leaves(params["embed"]))
            g_emb = [torch.stack(g[k::n_emb][:n_micro])
                     for k in range(n_emb)]
            g_emb = _sum_over_pipe(g_emb, mesh)
            g_blk = g[n_micro * n_emb:]
            n_blk = len(g_blk) // n_micro
            lsums = collectives.psum(torch.stack(sums), (mesh, PIPE_AXIS))

            def slice_grads(i):
                """Slice ``i``'s gradients in the params' leaf order."""
                groups = {
                    "embed": tree_unflatten(params["embed"],
                                            [e[i] for e in g_emb]),
                    "blocks": tree_unflatten(
                        params["blocks"], g_blk[i * n_blk:(i + 1) * n_blk])}
                return tree_leaves({k: groups[k] for k in params})

            return [(lsums[i], slice_grads(i)) for i in range(n_micro)]

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
            if p_deg > 1:
                slices = pipe_slices(params, ids, rmask, gen, scale)
            else:
                mb = B // n_micro
                slices = (grads_of(params, ids[i * mb:(i + 1) * mb],
                                   rmask[i * mb:(i + 1) * mb], gen, scale)
                          for i in range(n_micro))
            if n_micro == 1:
                lsum, grads = next(iter(slices))
            else:
                lsum, grads = None, None
                for s, g in slices:
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
                lsum, grads = collectives.psum((lsum, grads), dp_axis)
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


def _sum_over_pipe(grads: List[Tensor], mesh) -> List[Tensor]:
    """The replicated leaves' ``[n_micro, ...]`` slice gradients summed
    over ``pipe``: stage 0's lookup half and the last stage's readout
    half of the tied embedding meet here, slice by slice."""
    return collectives.psum(grads, (mesh, PIPE_AXIS))


def _like(tree, leaves: List[Tensor]):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
