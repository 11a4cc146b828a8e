"""Typed layer/network configuration with builders and JSON round-trip.

Reference parity:
- ``NeuralNetConfiguration`` (nn/conf/NeuralNetConfiguration.java:50) — the
  per-layer hyperparameter bag: lr / momentum (+``momentumAfter`` schedule) /
  l2 / dropout / sparsity / ``useAdaGrad`` / weightInit / lossFunction /
  nIn,nOut / activation / RBM visible+hidden units / conv filter/stride /
  optimization algorithm / iterations / seed, with a fluent ``Builder``
  (``:958``) and a ``ListBuilder`` (``:814``) producing the per-layer list.
- ``MultiLayerConfiguration`` (nn/conf/MultiLayerConfiguration.java:32) —
  ``hiddenLayerSizes``, ``pretrain``, ``backward``, input/output
  preprocessor maps, JSON serde (``fromJson``/``toJson``).
- per-layer overrides ``ConfOverride`` (nn/conf/override/ConfOverride.java).

Port of ``deeplearning4j_tpu/nn/conf/configuration.py``, kept line for
line: the JSON (``to_json``, sorted keys, indent 2) is the serialization
format both packages read, so the same builder calls give the same
string in either, and either package's JSON builds the same network.
Validation goes through the port's own ``ops.losses`` and
``ops.registry``.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class OptimizationAlgorithm(str, enum.Enum):
    """Parity: nn/api/OptimizationAlgorithm.java."""
    GRADIENT_DESCENT = "gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    HESSIAN_FREE = "hessian_free"
    LBFGS = "lbfgs"
    ITERATION_GRADIENT_DESCENT = "iteration_gradient_descent"


class WeightInit(str, enum.Enum):
    """Parity: nn/weights/WeightInit.java (VI/ZERO/SIZE/DISTRIBUTION/
    NORMALIZED/UNIFORM) + modern additions for the new model families."""
    VI = "vi"
    ZERO = "zero"
    SIZE = "size"
    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    HE = "he"
    LECUN = "lecun"


class HiddenUnit(str, enum.Enum):
    """Parity: RBM.HiddenUnit (rbm/RBM.java:76-80)."""
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"
    RECTIFIED = "rectified"


class VisibleUnit(str, enum.Enum):
    """Parity: RBM.VisibleUnit."""
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"
    LINEAR = "linear"


class LayerKind(str, enum.Enum):
    """What the reference expresses via layer classes + LayerFactories."""
    DENSE = "dense"
    OUTPUT = "output"
    RBM = "rbm"
    AUTOENCODER = "autoencoder"
    RECURSIVE_AUTOENCODER = "recursive_autoencoder"
    CONVOLUTION = "convolution"
    SUBSAMPLING = "subsampling"
    LSTM = "lstm"
    EMBEDDING = "embedding"
    BATCH_NORM = "batch_norm"


@dataclass
class NeuralNetConfiguration:
    """Per-layer hyperparameter bag. All fields JSON-serializable."""

    kind: LayerKind = LayerKind.DENSE
    n_in: int = 0
    n_out: int = 0
    activation: str = "sigmoid"
    weight_init: WeightInit = WeightInit.XAVIER
    dist: Tuple[str, float, float] = ("normal", 0.0, 0.01)  # DISTRIBUTION init
    loss_function: str = "mcxent"

    # optimization
    lr: float = 1e-1
    momentum: float = 0.5
    momentum_after: Dict[int, float] = field(default_factory=dict)
    l2: float = 0.0
    use_regularization: bool = False
    use_adagrad: bool = True
    optimization_algo: OptimizationAlgorithm = OptimizationAlgorithm.GRADIENT_DESCENT
    num_iterations: int = 100
    batch_size: int = 0  # 0 = whole input
    constrain_gradient_to_unit_norm: bool = False
    minimize: bool = True
    step_function: str = "default"

    # regularization / stochasticity
    dropout: float = 0.0
    drop_connect: bool = False
    sparsity: float = 0.0
    corruption_level: float = 0.3      # denoising AutoEncoder
    seed: int = 123

    # RBM
    visible_unit: VisibleUnit = VisibleUnit.BINARY
    hidden_unit: HiddenUnit = HiddenUnit.BINARY
    k: int = 1                          # CD-k Gibbs steps

    # convolution / subsampling (NHWC input, HWIO filters)
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: str = "VALID"
    n_channels: int = 1
    n_filters: int = 4
    pool_size: Tuple[int, int] = (2, 2)
    pool_type: str = "max"

    # LSTM / recurrent
    hidden_size: int = 0
    truncate_bptt: int = 0

    # compute precision: products run in compute_dtype; params stay fp32
    dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # free-form extras (forward-compatible, replaces string-keyed Configuration)
    extras: Dict[str, Any] = field(default_factory=dict)

    # -- builder -----------------------------------------------------------
    class Builder:
        """Fluent builder, parity with NeuralNetConfiguration.Builder:958."""

        def __init__(self, **kw):
            self._c = NeuralNetConfiguration(**kw)

        def __getattr__(self, name):
            # Generic fluent setter: any dataclass field name works as a
            # method, e.g. .lr(0.1).momentum(0.9).n_in(784)
            if name.startswith("_"):
                raise AttributeError(name)
            if name not in NeuralNetConfiguration.__dataclass_fields__:
                raise AttributeError(
                    f"NeuralNetConfiguration has no field '{name}'")

            def setter(value):
                setattr(self._c, name, value)
                return self
            return setter

        def list(self, n_layers: int) -> "ListBuilder":
            return ListBuilder(self._c, n_layers)

        def build(self) -> "NeuralNetConfiguration":
            conf = copy.deepcopy(self._c)
            conf.validate()
            return conf

    @staticmethod
    def builder(**kw) -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder(**kw)

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["momentum_after"] = {str(k): v for k, v in self.momentum_after.items()}
        for key, val in list(d.items()):
            if isinstance(val, enum.Enum):
                d[key] = val.value
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "NeuralNetConfiguration":
        d = dict(d)
        d["kind"] = LayerKind(d.get("kind", "dense"))
        d["weight_init"] = WeightInit(d.get("weight_init", "xavier"))
        d["visible_unit"] = VisibleUnit(d.get("visible_unit", "binary"))
        d["hidden_unit"] = HiddenUnit(d.get("hidden_unit", "binary"))
        d["optimization_algo"] = OptimizationAlgorithm(
            d.get("optimization_algo", "gradient_descent"))
        d["momentum_after"] = {int(k): float(v)
                               for k, v in d.get("momentum_after", {}).items()}
        for tup_field in ("dist", "kernel_size", "stride", "pool_size"):
            if tup_field in d and isinstance(d[tup_field], list):
                d[tup_field] = tuple(d[tup_field])
        known = NeuralNetConfiguration.__dataclass_fields__
        conf = NeuralNetConfiguration(
            **{k: v for k, v in d.items() if k in known})
        conf.validate()   # workers rebuilding from JSON fail fast too
        return conf

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "NeuralNetConfiguration":
        return NeuralNetConfiguration.from_dict(json.loads(s))

    def validate(self) -> None:
        """Fail-fast checks: unknown activation / loss names raise here
        (at build time) rather than deep inside a jitted forward pass."""
        from deeplearning4j_tpu_torch.ops.losses import LossFunction
        from deeplearning4j_tpu_torch.ops.registry import get_activation
        get_activation(self.activation)        # raises ValueError if unknown
        LossFunction(self.loss_function)       # raises ValueError if unknown

    def copy_with(self, **kw) -> "NeuralNetConfiguration":
        c = copy.deepcopy(self)
        for k, v in kw.items():
            if k not in NeuralNetConfiguration.__dataclass_fields__:
                raise AttributeError(f"no field '{k}'")
            setattr(c, k, v)
        return c


class ListBuilder:
    """Parity: NeuralNetConfiguration.ListBuilder:814 — clones the base conf
    per layer, applies per-layer overrides (``ConfOverride`` equivalent), and
    yields a MultiLayerConfiguration builder."""

    def __init__(self, base: NeuralNetConfiguration, n_layers: int):
        self._confs = [copy.deepcopy(base) for _ in range(n_layers)]
        self._mlc_kwargs: Dict[str, Any] = {}

    def override(self, layer: int,
                 fn: Callable[[NeuralNetConfiguration], None] | None = None,
                 **kw) -> "ListBuilder":
        conf = self._confs[layer]
        if fn is not None:
            fn(conf)
        for k, v in kw.items():
            setattr(conf, k, v)
        return self

    def hidden_layer_sizes(self, *sizes: int) -> "ListBuilder":
        self._mlc_kwargs["hidden_layer_sizes"] = list(sizes)
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._mlc_kwargs["pretrain"] = flag
        return self

    def backward(self, flag: bool) -> "ListBuilder":
        self._mlc_kwargs["backprop"] = flag
        return self

    def grad_accum(self, k: int) -> "ListBuilder":
        """Microbatch gradient-accumulation factor (see
        MultiLayerConfiguration.grad_accum)."""
        if k < 1:
            raise ValueError(f"grad_accum must be >= 1, got {k}")
        self._mlc_kwargs["grad_accum"] = int(k)
        return self

    def mixed_precision(self, policy: str) -> "ListBuilder":
        """Network-level mixed-precision policy (see
        MultiLayerConfiguration.mixed_precision)."""
        if policy not in MIXED_PRECISION_POLICIES:
            raise ValueError(
                f"mixed_precision must be one of "
                f"{MIXED_PRECISION_POLICIES}, got {policy!r}")
        self._mlc_kwargs["mixed_precision"] = policy
        return self

    def input_preprocessor(self, layer: int, name: str, **kw) -> "ListBuilder":
        self._mlc_kwargs.setdefault("input_preprocessors", {})[layer] = \
            {"name": name, **kw}
        return self

    def output_preprocessor(self, layer: int, name: str, **kw) -> "ListBuilder":
        self._mlc_kwargs.setdefault("output_preprocessors", {})[layer] = \
            {"name": name, **kw}
        return self

    def build(self) -> "MultiLayerConfiguration":
        for conf in self._confs:
            conf.validate()
        return MultiLayerConfiguration(confs=self._confs, **self._mlc_kwargs)


#: network-level mixed-precision policies: "off" = fp32 throughout (the
#: historical default), "bf16" = bf16 compute / fp32 master params and
#: accumulators with dynamic loss scaling in the donated train step
MIXED_PRECISION_POLICIES = ("off", "bf16")


@dataclass
class MultiLayerConfiguration:
    """Parity: nn/conf/MultiLayerConfiguration.java:32."""

    confs: List[NeuralNetConfiguration] = field(default_factory=list)
    hidden_layer_sizes: List[int] = field(default_factory=list)
    pretrain: bool = True
    backprop: bool = False
    use_drop_connect: bool = False
    #: microbatch gradient accumulation: each train step splits its batch
    #: into ``grad_accum`` microbatches, scanned with fp32 sum-accumulated
    #: gradients and ONE update at the end — effective batch = micro x
    #: accum x n_devices at the HBM footprint of one microbatch (the
    #: port's fit raises NotImplementedError above 1: ROADMAP A7)
    grad_accum: int = 1
    #: mixed-precision policy for the backprop train step: "bf16" runs the
    #: forward/backward in bfloat16 against fp32 MASTER params (grads and
    #: updater accumulators stay fp32) with dynamic loss scaling — an
    #: overflowed step is skipped by the in-step guard and the scale
    #: halves, collective-consistently under a mesh.  "off" = fp32.  The
    #: port's fit raises NotImplementedError for "bf16" (ROADMAP A7).
    mixed_precision: str = "off"
    # layer index -> preprocessor spec {"name": ..., **kwargs}
    input_preprocessors: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    output_preprocessors: Dict[int, Dict[str, Any]] = field(default_factory=dict)

    def num_layers(self) -> int:
        return len(self.confs)

    def conf(self, i: int) -> NeuralNetConfiguration:
        return self.confs[i]

    # -- serde (fromJson/toJson parity) ------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "confs": [c.to_dict() for c in self.confs],
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "use_drop_connect": self.use_drop_connect,
            "grad_accum": self.grad_accum,
            "mixed_precision": self.mixed_precision,
            "input_preprocessors": {str(k): v for k, v in self.input_preprocessors.items()},
            "output_preprocessors": {str(k): v for k, v in self.output_preprocessors.items()},
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            confs=[NeuralNetConfiguration.from_dict(c) for c in d.get("confs", [])],
            hidden_layer_sizes=list(d.get("hidden_layer_sizes", [])),
            pretrain=bool(d.get("pretrain", True)),
            backprop=bool(d.get("backprop", False)),
            use_drop_connect=bool(d.get("use_drop_connect", False)),
            grad_accum=int(d.get("grad_accum", 1)),
            mixed_precision=str(d.get("mixed_precision", "off")),
            input_preprocessors={int(k): v for k, v in d.get("input_preprocessors", {}).items()},
            output_preprocessors={int(k): v for k, v in d.get("output_preprocessors", {}).items()},
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def __eq__(self, other) -> bool:
        return isinstance(other, MultiLayerConfiguration) and \
            self.to_dict() == other.to_dict()
