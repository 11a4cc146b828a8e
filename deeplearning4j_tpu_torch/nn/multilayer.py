"""MultiLayerNetwork: a stack of layers and an output layer.

Port of the single-device part of ``deeplearning4j_tpu/nn/multilayer.py``:
the constructor and size wiring (:62-113), ``init``, ``feed_forward``,
``hidden_activations`` and ``loss`` (:134-174), ``output`` / ``predict``
/ ``score`` through the serving engine (:206-251), ``fit_backprop``'s
single-device path (:879-978), ``fit_iterator`` (:1134-1236),
``evaluate`` and the params plumbing and serialization (:1267-1315).

Params are a list of per-layer dicts of fp32 tensors on the network's
``device`` (None = CUDA), in the reference's layouts, so
``params_flat``, ``to_bytes`` and ``from_bytes`` move between the
packages unchanged.

The train step is one function: forward, ``torch.autograd.grad`` of the
loss, each layer's own ``dl4j_updater`` (batch size 1: the loss is
already a mean), then the in-step guard (``runtime/resilience.
guard_update``, as in the reference).  The guard keeps params and
updater state when the loss or a gradient is not finite, with
``torch.where`` on a device flag; the flags are summed once at the end
of a fit (``resilience.note_skips``) into ``guard_skips``, so a step
costs no host sync.  A uniform list of batches within
``SCAN_MAX_DATASET_BYTES`` is stacked on the device once and the steps
index into it (the counterpart of the reference's scanned epoch).
Every fit loop checks ``resilience.preemption_requested()`` at each
step boundary and stops cleanly when a ``PreemptionGuard`` has seen a
notice (reference :1120-1130; the staged loop has step boundaries too,
where the reference's single-dispatch scan has none).
``_backprop_machinery`` / ``_init_ustate`` / ``_notify_fit_start`` are
the hooks ``runtime/resilience.ResilientFit`` drives.

The step and the serving forward run through the compile engine
(``runtime/compile_cache``), shared by every network of the same conf
JSON (reference :176-201, :496-577): on the card the step is one CUDA
graph a batch shape, replayed every step.  It writes the params, the
updater state and its device iteration counter in place (they are
donated): the network's own params are copied into the engine's buffers
on the first step, and the fit clones the trained ones back out (the
API boundary).

``fit`` is the reference's (:1238-1246): greedy layer-wise
``pretrain`` when the conf asks for it, ``finetune`` of the output
layer on the merged batches through ``optimize/solver.Solver`` (or
whole-network Hessian-free for a HESSIAN_FREE conf), then
``fit_backprop`` when the conf asks for it.  ``pretrain``'s
gradient-descent step is one captured step a layer, shared by (layer
index, conf JSON); its random stream is a generator re-seeded with
``fold(seed, layer, iteration)`` before each step (the reference's
``fold_in(fold_in(key, layer), iteration)``), so two pretrains with one
seed give equal params.  ``prepare_resilient_fit`` is ``fit``'s front
half for ``runtime/resilience.ResilientFit``.

Not ported (each raises ``NotImplementedError`` naming ROADMAP A7): the
data-parallel, accumulation and mixed-precision fit paths (``mesh``,
``grad_accum > 1``, ``mixed_precision="bf16"``).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    LayerKind, MIXED_PRECISION_POLICIES, MultiLayerConfiguration,
    OptimizationAlgorithm)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import make_preprocessor
from deeplearning4j_tpu_torch.nn.layers import make_layer
from deeplearning4j_tpu_torch.nn.layers.base import Layer, PretrainLayer
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
from deeplearning4j_tpu_torch.nn.params import (pack_params, param_leaves,
                                                unpack_params)
from deeplearning4j_tpu_torch.ops.updaters import (apply_descent,
                                                   copy_into, dl4j_updater,
                                                   tree_map)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.optimize.solver import (Objective, Solver,
                                                      value_and_grad)
from deeplearning4j_tpu_torch.runtime import (compile_cache, resilience,
                                              telemetry)

Tensor = torch.Tensor
Params = List[Dict[str, Tensor]]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})")


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _as_tensor(a, device: torch.device) -> Tensor:
    """``a`` on ``device``; float64 becomes fp32, as JAX (without x64)
    takes numpy arrays."""
    t = torch.as_tensor(a)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


class MultiLayerNetwork:
    #: a uniform batch list up to this size is stacked on the device
    #: once; above it, fit_backprop moves batch by batch
    SCAN_MAX_DATASET_BYTES = 256 * 1024 * 1024

    def __init__(self, conf: MultiLayerConfiguration,
                 params: Optional[Params] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.conf = conf
        self._wire_layer_sizes()
        if conf.use_drop_connect:
            # net-level useDropConnect turns every layer's dropout into
            # weight masking
            for c in conf.confs:
                c.drop_connect = True
        self.layers: List[Layer] = [make_layer(c) for c in conf.confs]
        self.params: Optional[Params] = params
        self.listeners: List[IterationListener] = []
        self._in_pre = {i: make_preprocessor(spec)
                        for i, spec in conf.input_preprocessors.items()}
        self._out_pre = {i: make_preprocessor(spec)
                         for i, spec in conf.output_preprocessors.items()}
        self._serving_engine_memo = None
        self._machinery_memo = None
        #: in-step guard skips summed over this network's fits
        self.guard_skips = 0

    # -- wiring (init:325 parity) ------------------------------------------
    def _wire_layer_sizes(self) -> None:
        confs = self.conf.confs
        sizes = self.conf.hidden_layer_sizes
        if sizes:
            n_in = confs[0].n_in
            if n_in <= 0:
                raise ValueError("first layer needs n_in when using "
                                 "hidden_layer_sizes")
            dims = [n_in] + list(sizes)
            for i, c in enumerate(confs[:-1]):
                if i < len(dims) - 1:
                    c.n_in, c.n_out = dims[i], dims[i + 1]
            out = confs[-1]
            out.n_in = dims[-1]
            if out.n_out <= 0:
                raise ValueError("output layer needs n_out")
        else:
            for prev, cur in zip(confs[:-1], confs[1:]):
                if cur.n_in <= 0 and cur.kind not in (
                        LayerKind.CONVOLUTION, LayerKind.SUBSAMPLING):
                    cur.n_in = prev.n_out

    # -- init --------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Fresh params from ``seed`` (default: the first layer conf's),
        drawn on the CPU and moved to the device: one seed gives the same
        weights on every device."""
        seed = self.conf.confs[0].seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        self.params = [layer.init(gen, self.device) for layer in self.layers]
        return self

    def _require_params(self) -> Params:
        if self.params is None:
            self.init()
        return self.params  # type: ignore[return-value]

    @property
    def output_layer(self) -> OutputLayer:
        last = self.layers[-1]
        if not isinstance(last, OutputLayer):
            raise TypeError("last layer is not an OutputLayer")
        return last

    # -- forward (feedForward:462 parity) ----------------------------------
    def feed_forward(self, params: Params, x: Tensor,
                     gen: Optional[torch.Generator] = None,
                     train: bool = False,
                     upto: Optional[int] = None) -> List[Tensor]:
        """Returns [input, act_0, ..., act_{upto-1}]."""
        n = len(self.layers) if upto is None else upto
        acts = [x]
        for i in range(n):
            h = acts[-1]
            if i in self._in_pre:
                h = self._in_pre[i](h, gen)
            h = self.layers[i].activate(params[i], h, gen=gen, train=train)
            if i in self._out_pre:
                h = self._out_pre[i](h, gen)
            acts.append(h)
        return acts

    def hidden_activations(self, params: Params, x: Tensor,
                           gen: Optional[torch.Generator] = None,
                           train: bool = False) -> Tensor:
        """Activations entering the output layer."""
        return self.feed_forward(params, x, gen, train,
                                 upto=len(self.layers) - 1)[-1]

    def loss(self, params: Params, x: Tensor, labels: Tensor,
             gen: Optional[torch.Generator] = None,
             train: bool = False) -> Tensor:
        """End-to-end supervised loss (backprop is autograd of this)."""
        h = self.hidden_activations(params, x, gen, train)
        if len(self.layers) - 1 in self._in_pre:
            h = self._in_pre[len(self.layers) - 1](h, gen)
        return self.output_layer.loss(params[-1], h, labels)

    # -- the engine's entries (reference :176-201, :496-577) ---------------
    def _machinery(self):
        """``(train_step, serving_forward)`` through the compile engine,
        shared module-wide by conf JSON."""
        if self._machinery_memo is None:
            self._machinery_memo = compile_cache.get_or_build(
                ("multilayer", self.conf.to_json()), self._build_machinery)
        return self._machinery_memo

    def _build_machinery(self):
        # close over a replica rebuilt from the conf JSON, never over
        # self: the shared entry outlives this network and must not pin
        # it (or its trained params)
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device="cpu")
        updaters = net._updaters()

        def train_step(params, ustate, iteration, x, y, gen):
            new_p, new_u, score, skipped = net._train_step(
                updaters, params, ustate, x, y, gen, iteration)
            with torch.no_grad():
                copy_into(params, new_p)
                copy_into(ustate, new_u)
                iteration.add_(1)
            return params, ustate, iteration, score, skipped

        def forward(params, x):
            return net.feed_forward(params, x)[-1]

        return (compile_cache.cached_graph(
                    train_step, label="multilayer.train_step",
                    donate_argnums=(0, 1, 2)),
                compile_cache.cached_graph(forward,
                                           label="serving.forward"))

    def _backprop_machinery(self, mesh=None):
        """``(train_step, updaters)``: the captured engine step
        ``train_step(params, ustate, iteration, x, y, gen) -> (params,
        ustate, iteration, score, skipped)`` shared by conf JSON, and this
        conf's per-layer updaters; the counterpart of the reference's
        ``_backprop_machinery`` (:442-470; the scanned ``train_epochs``
        has no counterpart: the staged loop replays the step).  A
        ``mesh`` raises (data-parallel machinery, ROADMAP A7)."""
        self._check_fit_conf(mesh)
        return self._machinery()[0], self._updaters()

    @staticmethod
    def _init_ustate(train_step, updaters, params):
        """Fresh updater state for an engine step: the per-layer list
        (the reference's mixed-precision step carries its own
        initializer, ROADMAP A7)."""
        return [u.init(p) for u, p in zip(updaters, params)]

    @staticmethod
    def _preempt_stop(where: str) -> bool:
        """Step-boundary preemption check of the fit loops: True when an
        installed ``resilience.PreemptionGuard`` has seen a notice; the
        loop then finishes cleanly with the params trained so far (the
        final snapshot belongs to ``ResilientFit``).  One global read
        when no guard is installed."""
        if resilience.preemption_requested():
            telemetry.event("multilayer.preempt_stop", where=where)
            return True
        return False

    # -- inference (output:1147 / predict:1057 / score:1213) ---------------
    def serving_engine(self, buckets: Optional[Sequence[int]] = None,
                       max_batch_size: Optional[int] = None):
        """The bucketed inference engine serving this network's live
        params on its device.  The default-configured engine is memoized;
        pass ``buckets`` / ``max_batch_size`` for a custom ladder."""
        from deeplearning4j_tpu_torch.serving.engine import (
            DEFAULT_MAX_BATCH, InferenceEngine)
        custom = buckets is not None or max_batch_size is not None
        if not custom and self._serving_engine_memo is not None:
            return self._serving_engine_memo
        eng = InferenceEngine(
            self._machinery()[1], params=self._require_params,
            buckets=buckets,
            max_batch_size=max_batch_size or DEFAULT_MAX_BATCH,
            device=self.device)
        if not custom:
            self._serving_engine_memo = eng
        return eng

    def output(self, x, params: Optional[Params] = None) -> Tensor:
        """The output layer's activations for the rows of ``x`` (numpy
        or a tensor), through the serving engine's bucket ladder."""
        if getattr(x, "ndim", None) == 1:
            # one unbatched example has no batch dim to bucket
            p = params if params is not None else self._require_params()
            with torch.inference_mode():
                return self.feed_forward(p, _as_tensor(x, self.device))[-1]
        return self.serving_engine().infer(x, params=params)

    def predict(self, x) -> Tensor:
        return torch.argmax(self.output(x), dim=-1)

    def score(self, data: DataSet, params: Optional[Params] = None) -> float:
        """Mean loss on ``data``."""
        params = params if params is not None else self._require_params()
        with torch.inference_mode():
            return float(self.loss(params,
                                   _as_tensor(data.features, self.device),
                                   _as_tensor(data.labels, self.device)))

    # -- pretrain (pretrain:144 parity) ------------------------------------
    def pretrain(self, data: Union[DataSet, Sequence[DataSet]],
                 seed: int = 0) -> None:
        """Greedy layer-wise: train each pretrainable layer on the
        activations of the stack below it, batch by batch (reference
        :253-360).

        For GRADIENT_DESCENT (the default) the step is captured ONCE per
        layer with the batch as an argument, shared through the engine
        by (layer index, conf JSON); each step's draws come from a
        generator re-seeded with ``fold(seed, layer, iteration)``.
        Line-search algorithms (CG/LBFGS) run a full Solver per batch
        (they are full-batch methods; the reference does the same), its
        generator seeded with ``fold(seed, layer, batch)``."""
        # the API boundary: the steps update the engine's copies; the
        # caller's params are never written
        params = list(self._require_params())
        batches = [data] if isinstance(data, DataSet) else list(data)
        self._notify_fit_start()
        for i, layer in enumerate(self.layers):
            if not isinstance(layer, PretrainLayer):
                continue
            conf = self.conf.confs[i]

            # Inputs to layer i under the CURRENT stack params (greedy).
            def layer_input(x, _i=i) -> Tensor:
                with torch.no_grad():
                    return self.feed_forward(
                        params, _as_tensor(x, self.device), upto=_i)[-1]

            with telemetry.span("multilayer.pretrain_layer", layer=i,
                                algo=conf.optimization_algo.value):
                if conf.optimization_algo in (
                        OptimizationAlgorithm.GRADIENT_DESCENT,
                        OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT):
                    params[i] = self._pretrain_gd(i, conf, params[i],
                                                  batches, layer_input, seed)
                else:
                    for b, batch in enumerate(batches):
                        inputs = layer_input(batch.features)
                        objective = Objective(
                            value_and_grad=lambda p, d, x=inputs, ly=layer:
                                ly.pretrain_core(p, d, x),
                            value=lambda p, d, x=inputs, ly=layer:
                                ly.pretrain_core(p, d, x)[0],
                            batch_size=1,
                            draw=lambda g, x=inputs, ly=layer: ly.draw(g, x))
                        solver = Solver(conf, objective,
                                        listeners=self.listeners)
                        gen = torch.Generator(device=self.device)
                        gen.manual_seed(resilience.fold(seed, i, b))
                        params[i] = solver.optimize(params[i], gen)
        self.params = params

    def _pretrain_gd(self, i: int, conf, p, batches, layer_input,
                     seed: int):
        """Layer ``i``'s gradient-descent pretraining: the engine's step
        over every batch, ``num_iterations`` steps a batch; returns the
        trained params (out of the engine's buffers)."""
        sig = self.conf.to_json()

        def build():
            # a detached replica rebuilt from the conf JSON: the shared
            # entry neither pins this network nor sees later mutations
            rep = MultiLayerNetwork(MultiLayerConfiguration.from_json(sig),
                                    device="cpu")
            rlayer, rc = rep.layers[i], rep.conf.confs[i]
            rupdater = dl4j_updater(
                lr=rc.lr, momentum=rc.momentum,
                momentum_schedule=rc.momentum_after,
                use_adagrad=rc.use_adagrad, l2=rc.l2,
                use_regularization=rc.use_regularization,
                constrain_unit_norm=rc.constrain_gradient_to_unit_norm)

            def gd_step(p, ustate, inputs, gen, it):
                score, grads = rlayer.pretrain_value_and_grad(p, gen, inputs)
                with torch.no_grad():
                    # batch_size=1: objectives are batch MEANS
                    updates, new_ustate = rupdater.update(ustate, grads, p,
                                                          it, 1)
                    new_p, new_ustate, skipped = resilience.guard_update(
                        p, ustate, apply_descent(p, updates), new_ustate,
                        (score, grads))
                    copy_into(p, new_p)
                    copy_into(ustate, new_ustate)
                    it.add_(1)
                return p, ustate, it, score, skipped

            return (compile_cache.cached_graph(
                gd_step, label=f"multilayer.pretrain_gd[{i}]",
                donate_argnums=(0, 1, 4)), rupdater)

        gd_step, updater = compile_cache.get_or_build(
            ("multilayer_pretrain_gd", i, sig), build)
        ustate = updater.init(p)
        it = torch.zeros((), dtype=torch.int32, device=self.device)
        gen = torch.Generator(device=self.device)
        n, skips = 0, []
        for batch in batches:
            inputs = layer_input(batch.features)
            for _ in range(conf.num_iterations):
                # a distinct stream per (seed, layer, iteration): fold(seed,
                # iteration) alone would replay one layer's noise in the next
                gen.manual_seed(resilience.fold(seed, i, n))
                p, ustate, it, score, skipped = gd_step(p, ustate, inputs,
                                                        gen, it)
                skips.append(skipped)
                if self.listeners:
                    for ls in self.listeners:
                        ls.iteration_done(self, n, float(score))
                n += 1
        self._note_skips(skips)
        return tree_map(torch.clone, p)

    # -- Hessian-free (fit:1006-1009 + backPropGradient2:856 parity) -------
    def fit_hessian_free(self, data: DataSet,
                         num_iterations: Optional[int] = None) -> None:
        """Whole-network Hessian-free optimization: Gauss-Newton products
        through the full stack (the autodiff equivalent of the
        reference's R-operator backPropGradient2/getBackPropRGradient)."""
        from deeplearning4j_tpu_torch.optimize.hessian_free import (
            GNObjective, StochasticHessianFree)

        params = self._require_params()
        out = self.output_layer
        last = len(self.layers) - 1
        x = _as_tensor(data.features, self.device)
        labels = _as_tensor(data.labels, self.device)

        def logits_fn(p):
            h = self.hidden_activations(p, x)
            if last in self._in_pre:
                h = self._in_pre[last](h, None)
            return out.pre_output(p[last], h)

        obj = GNObjective(
            logits_fn=logits_fn,
            loss_from_logits=lambda z: out.loss_from_logits(z, labels))
        hf = StochasticHessianFree(
            obj,
            num_iterations=num_iterations
            or self.conf.confs[-1].num_iterations,
            listeners=self.listeners)
        with telemetry.span("multilayer.hessian_free",
                            rows=int(x.shape[0])):
            self.params = hf.optimize(params)

    # -- finetune (finetune:987 parity) ------------------------------------
    def finetune(self, data: DataSet, seed: int = 1) -> None:
        """Train ONLY the output layer on last-hidden activations; with
        HESSIAN_FREE configured, optimize the WHOLE network instead (the
        reference's finetune does exactly this split, fit:1006-1009).

        The hidden activations of the whole set are computed once, in
        one forward outside the solver's loop, and the objective closes
        over them (reference :409-413).  That forward holds every
        layer's activations of every row at once: for LeNet on the full
        60,000-image MNIST, conv1's alone are 60,000 x 24 x 24 x 20 fp32
        values, ~2.8 GB, as in the reference."""
        if (self.conf.confs[-1].optimization_algo
                is OptimizationAlgorithm.HESSIAN_FREE):
            self.fit_hessian_free(data)
            return
        params = self._require_params()
        x = _as_tensor(data.features, self.device)
        with torch.no_grad():
            h = self.hidden_activations(params, x)
            # Same boundary transform as loss(): the output layer must
            # train on exactly what it sees at inference.
            last = len(self.layers) - 1
            if last in self._in_pre:
                h = self._in_pre[last](h, None)
        with telemetry.span("multilayer.finetune", rows=int(x.shape[0])):
            params[-1], _ = self.finetune_output(
                h, _as_tensor(data.labels, self.device), seed)
        self.params = params

    def finetune_output(self, h: Tensor, labels: Tensor, seed: int = 1):
        """``finetune``'s solver run on given last-hidden activations
        ``h`` (after the output layer's input preprocessor): the output
        layer's params trained from the network's current ones, and the
        optimizer (its ``score_history`` and ``trials_history``).  The
        network is not changed."""
        out_layer = self.output_layer

        def loss(p):
            return out_layer.loss(p, h, labels)

        vag = value_and_grad(loss)
        objective = Objective(value_and_grad=lambda p, d: vag(p),
                              value=lambda p, d: loss(p), batch_size=1)
        solver = Solver(self.conf.confs[-1], objective,
                        listeners=self.listeners)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        trained = solver.optimize(self._require_params()[-1], gen)
        return trained, solver.optimizer

    # -- fit (fit:918 parity: pretrain -> finetune -> optional backprop) ---
    def fit(self, data: Union[DataSet, Sequence[DataSet]],
            num_epochs: int = 1) -> None:
        batches = [data] if isinstance(data, DataSet) else list(data)
        if self.conf.pretrain:
            self.pretrain(batches)
        merged = DataSet.merge(batches) if len(batches) > 1 else batches[0]
        self.finetune(merged)
        if self.conf.backprop:
            self.fit_backprop(batches, num_epochs=num_epochs)

    def prepare_resilient_fit(self, data: Union[DataSet, Sequence[DataSet]]
                              ) -> tuple:
        """``fit()``'s front half for EXTERNAL training drivers
        (``cli train --checkpoint-dir`` -> ``runtime.resilience
        .ResilientFit``): the same finetune pass on the merged batches,
        and the mesh ``fit_backprop`` would use, returned as
        ``(batch_list, mesh)`` for the driver's constructor.  On one
        device the mesh is None.  Pretrain confs are the caller's
        problem to refuse (the driver only replays the backprop step)."""
        batches = [data] if isinstance(data, DataSet) else list(data)
        merged = DataSet.merge(batches) if len(batches) > 1 else batches[0]
        self.finetune(merged)
        mesh = self._resolve_fit_mesh(
            "auto", min(int(b.features.shape[0]) for b in batches))
        return batches, mesh

    def _resolve_fit_mesh(self, mesh, min_batch: int):
        """The reference's sharded-by-default policy (:831-866) on one
        device: ``None``/``False``/``"auto"`` give None (the single-
        device path); an explicit mesh raises (ROADMAP A7)."""
        if mesh is None or mesh is False or mesh == "auto":
            return None
        raise _not_ported("data-parallel fit (mesh=)", "A7")

    # -- backprop training ---------------------------------------------------
    def _check_fit_conf(self, mesh) -> None:
        policy = getattr(self.conf, "mixed_precision", "off")
        if policy not in MIXED_PRECISION_POLICIES:
            raise ValueError(
                f"mixed_precision must be one of "
                f"{MIXED_PRECISION_POLICIES}, got {policy!r}")
        if mesh is not None:
            raise _not_ported("data-parallel fit (mesh=)", "A7")
        if self.conf.grad_accum > 1:
            raise _not_ported("gradient accumulation (grad_accum > 1)",
                              "A7")
        if policy == "bf16":
            raise _not_ported('mixed_precision="bf16"', "A7")

    def _updaters(self):
        """Each layer's own updater from its conf (ConfOverride parity:
        per-layer lr / momentum / l2 take effect)."""
        return [dl4j_updater(
            lr=c.lr, momentum=c.momentum, momentum_schedule=c.momentum_after,
            use_adagrad=c.use_adagrad, l2=c.l2,
            use_regularization=c.use_regularization,
            constrain_unit_norm=c.constrain_gradient_to_unit_norm,
        ) for c in self.conf.confs]

    def _train_step(self, updaters, params: Params, ustate: list,
                    x: Tensor, y: Tensor, gen: torch.Generator,
                    iteration):
        """One step: (params, ustate, loss, skipped), all on the device;
        ``skipped`` is an int32 flag, 1 where the guard dropped the
        update.  ``iteration`` (the momentum schedule's clock) is an int
        or a 0-d device tensor."""
        live = [tree_map(lambda t: t.detach().requires_grad_(True), p)
                for p in params]
        leaves = param_leaves(live)
        with torch.enable_grad():
            score = self.loss(live, x, y, gen, train=True)
        # a pretrain layer's visible bias takes no part in the supervised
        # loss: its gradient is zero, as jax.grad gives it
        grads_flat = [torch.zeros_like(p) if g is None else g for p, g in
                      zip(leaves, torch.autograd.grad(score, leaves,
                                                      allow_unused=True))]
        score = score.detach()
        it = iter(grads_flat)
        grads = [{key: next(it) for key in sorted(p)} for p in params]
        with torch.no_grad():
            new_params, new_ustate = [], []
            for upd, p, u, g in zip(updaters, params, ustate, grads):
                u_i, s_i = upd.update(u, g, p, iteration, 1)
                new_params.append(apply_descent(p, u_i))
                new_ustate.append(s_i)
            new_params, new_ustate, skipped = resilience.guard_update(
                params, ustate, new_params, new_ustate,
                (score, list(grads_flat)))
        return new_params, new_ustate, score, skipped

    def fit_backprop(self, data: Union[DataSet, Sequence[DataSet]],
                     num_epochs: int = 1, seed: int = 2,
                     mesh=None) -> None:
        """Supervised minibatch training of the whole network on its
        device.  A uniform list of batches (same shapes, within
        ``SCAN_MAX_DATASET_BYTES``) is staged on the device once and
        listeners are replayed from the per-step losses after the steps;
        a ragged list or a lone DataSet moves batch by batch.  ``seed``
        seeds the dropout generator.  ``mesh`` must be None (the
        data-parallel path is ROADMAP A7)."""
        self._check_fit_conf(mesh)
        batches = [data] if isinstance(data, DataSet) else list(data)
        if not batches:
            return
        self._notify_fit_start()
        with telemetry.span("multilayer.fit", path="single",
                            epochs=num_epochs, batches=len(batches)):
            self._fit_backprop_single(batches, num_epochs, seed)

    def _fit_state(self, seed: int):
        """A fit's working state: a copy of the network's params (the
        step donates them), fresh updater state, the device iteration
        counter and the dropout generator."""
        params = [tree_map(torch.clone, p) for p in self._require_params()]
        ustate = [u.init(p) for u, p in zip(self._updaters(), params)]
        it = torch.zeros((), dtype=torch.int32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return params, ustate, it, gen

    def _fit_backprop_single(self, batches, num_epochs: int,
                             seed: int) -> None:
        step = self._machinery()[0]
        params, ustate, it, gen = self._fit_state(seed)
        stop = False
        total_bytes = sum(_nbytes(b.features) + _nbytes(b.labels)
                          for b in batches)
        uniform = (len(batches) > 1
                   and total_bytes <= self.SCAN_MAX_DATASET_BYTES
                   and len({(tuple(b.features.shape), tuple(b.labels.shape))
                            for b in batches}) == 1)
        n = 0
        skips = []
        if uniform:
            with telemetry.span("multilayer.stage",
                                batches=len(batches)) as sp:
                xs = _as_tensor(torch.stack([torch.as_tensor(b.features)
                                             for b in batches]), self.device)
                ys = _as_tensor(torch.stack([torch.as_tensor(b.labels)
                                             for b in batches]), self.device)
                sp.set(bytes=_nbytes(xs) + _nbytes(ys))
            scores = []
            with telemetry.span("multilayer.dispatch", staged=True,
                                steps=num_epochs * len(batches)):
                for epoch in range(num_epochs):
                    if stop:
                        break
                    with telemetry.span("multilayer.epoch", epoch=epoch):
                        for j in range(len(batches)):
                            if self._preempt_stop("fit_backprop"):
                                stop = True
                                break
                            params, ustate, it, score, skipped = step(
                                params, ustate, it, xs[j], ys[j], gen)
                            scores.append(score)
                            skips.append(skipped)
                self._note_skips(skips)
            if self.listeners and scores:
                for j, s in enumerate(torch.stack(scores).tolist()):
                    for ls in self.listeners:
                        ls.iteration_done(self, j, s)
        else:
            for epoch in range(num_epochs):
                if stop:
                    break
                with telemetry.span("multilayer.epoch", epoch=epoch):
                    for batch in batches:
                        if self._preempt_stop("fit_backprop"):
                            stop = True
                            break
                        params, ustate, it = self._step_and_notify(
                            step, params, ustate, it, batch, gen, n, skips)
                        n += 1
            self._note_skips(skips)
        self._set_trained(params)

    def _set_trained(self, params: Params) -> None:
        """The API boundary: the step's params share the engine's
        buffers; the network keeps a clone, so the fit's state set is
        free for the next fit of this conf."""
        self.params = [tree_map(torch.clone, p) for p in params]

    def _step_and_notify(self, step, params, ustate, it, batch, gen, n,
                         skips):
        """Step ``n`` on ``batch`` (moved to the device) and the
        listeners (a host sync only when there are listeners)."""
        params, ustate, it, score, skipped = step(
            params, ustate, it, _as_tensor(batch.features, self.device),
            _as_tensor(batch.labels, self.device), gen)
        skips.append(skipped)
        if self.listeners:
            for ls in self.listeners:
                ls.iteration_done(self, n, float(score))
        return params, ustate, it

    def _note_skips(self, skips) -> None:
        """Book the guard's per-step flags with one host sync a fit
        (``resilience.note_skips``) into ``guard_skips``."""
        self.guard_skips += resilience.note_skips(skips, where="multilayer")

    def _notify_fit_start(self) -> None:
        for ls in self.listeners:
            hook = getattr(ls, "on_fit_start", None)
            if callable(hook):
                hook(self)

    def fit_iterator(self, it, num_epochs: int = 1, seed: int = 2,
                     mesh=None) -> None:
        """Streaming supervised backprop from a ``DataSetIterator``: each
        pulled batch moves to the device and takes one step; updater
        state persists over the whole call.  Pretrain confs raise, as in
        the reference."""
        if self.conf.pretrain or not self.conf.backprop:
            raise ValueError(
                "fit_iterator is the streaming backprop trainer; this "
                "conf wants pretrain/finetune (pretrain="
                f"{self.conf.pretrain}, backprop={self.conf.backprop})")
        self._check_fit_conf(mesh)
        self._notify_fit_start()
        step = self._machinery()[0]
        params, ustate, counter, gen = self._fit_state(seed)
        n = 0
        skips = []
        stop = False
        with telemetry.span("multilayer.fit", path="iterator",
                            epochs=num_epochs):
            for epoch in range(num_epochs):
                if stop:
                    break
                with telemetry.span("multilayer.epoch", epoch=epoch):
                    it.reset()
                    while it.has_next():
                        if self._preempt_stop("fit_iterator"):
                            stop = True
                            break
                        params, ustate, counter = self._step_and_notify(
                            step, params, ustate, counter, it.next(), gen,
                            n, skips)
                        n += 1
            self._note_skips(skips)
        self._set_trained(params)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, data: DataSet):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        with telemetry.span("multilayer.eval",
                            rows=int(data.features.shape[0])):
            ev = Evaluation(num_classes=data.num_outcomes())
            ev.eval(data.labels, self.output(data.features))
            return ev

    # -- params plumbing (pack:773 / unPack:817 / merge:1321) ----------------
    def params_flat(self) -> Tensor:
        return pack_params(self._require_params())

    def set_params_flat(self, flat) -> None:
        self.params = unpack_params(torch.as_tensor(flat),
                                    self._require_params())

    def merge(self, others: Sequence["MultiLayerNetwork"]) -> None:
        """Parameter averaging with peers (distributed merge:1321)."""
        all_params = [self._require_params()] + \
            [o._require_params() for o in others]
        n = float(len(all_params))
        self.params = [tree_map(lambda *ps: sum(ps) / n, *layers)
                       for layers in zip(*all_params)]

    def clone(self) -> "MultiLayerNetwork":
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            self.conf.to_json()), device=self.device)
        if self.params is not None:
            net.params = [tree_map(torch.clone, p) for p in self.params]
        return net

    # -- serialization (conf JSON + flat params :93-97) ----------------------
    def to_bytes(self) -> bytes:
        """An npz of the conf JSON and the fp32 flat params: the
        reference's format, which either package reads."""
        buf = io.BytesIO()
        np.savez(buf, conf=self.conf.to_json(),
                 params=self.params_flat().detach().cpu().numpy())
        return buf.getvalue()

    @staticmethod
    def from_bytes(blob: bytes,
                   device: DeviceLike = None) -> "MultiLayerNetwork":
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            conf = MultiLayerConfiguration.from_json(str(z["conf"]))
            net = MultiLayerNetwork(conf, device=device).init()
            net.set_params_flat(torch.from_numpy(z["params"]))
        return net

    def set_listeners(self, listeners: Sequence[IterationListener]) -> None:
        self.listeners = list(listeners)

    def num_params(self) -> int:
        return int(self.params_flat().shape[0])
