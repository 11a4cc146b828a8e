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

Not ported (each raises ``NotImplementedError``): the data-parallel,
accumulation and mixed-precision fit paths (``mesh``, ``grad_accum >
1``, ``mixed_precision="bf16"``: ROADMAP A7), and ``fit``,
``finetune``, ``pretrain`` and ``fit_hessian_free``, which need
``optimize/solver.py`` (ROADMAP A5).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    LayerKind, MIXED_PRECISION_POLICIES, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import make_preprocessor
from deeplearning4j_tpu_torch.nn.layers import make_layer
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
from deeplearning4j_tpu_torch.nn.params import (pack_params, param_leaves,
                                                unpack_params)
from deeplearning4j_tpu_torch.ops.updaters import (apply_descent,
                                                   copy_into, dl4j_updater,
                                                   tree_map)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
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

    # -- paths that wait for later slices -----------------------------------
    def pretrain(self, data, seed: int = 0) -> None:
        raise _not_ported("greedy layer-wise pretrain (optimize/solver.py)",
                          "A5")

    def finetune(self, data, seed: int = 1) -> None:
        raise _not_ported("finetune (optimize/solver.py)", "A5")

    def fit_hessian_free(self, data, num_iterations=None) -> None:
        raise _not_ported("Hessian-free (optimize/hessian_free.py)", "A5")

    def fit(self, data, num_epochs: int = 1) -> None:
        """``fit`` is pretrain -> finetune -> backprop; it needs the
        solver.  ``fit_backprop`` trains the backprop stage alone."""
        raise _not_ported("fit (pretrain and finetune through "
                          "optimize/solver.py); use fit_backprop", "A5")

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
        grads_flat = torch.autograd.grad(score, leaves)
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
