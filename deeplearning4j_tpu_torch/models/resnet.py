"""ResNet (v1.5 bottleneck) in PyTorch: training and serving.

Port of ``deeplearning4j_tpu/models/resnet.py``: the same configs, the
same parameter and batch-statistics trees (leaf names and paths, conv
filters HWIO ``[kh, kw, Cin, Cout]``, the FC ``[in, n_classes]``), the
same forward (:202-254), loss, SGD-Nesterov train step and serving
apply.  Images enter as the reference's NHWC ``[B, H, W, 3]``; inside,
activations are logical NCHW tensors in channels-last memory (the same
bytes as NHWC), which cuDNN convolves without a transpose, and each
filter is permuted to ``[Cout, Cin, kh, kw]`` channels-last at its call.
No TPU kernel lies on this path: the reference's convolutions are
``lax.conv_general_dilated``, here ``F.conv2d`` (cuDNN on the card).

Numerics, site by site, against the JAX forward:

- **Padding.**  XLA's ``"SAME"`` is asymmetric where the total is odd:
  the stem's 7x7/s2 on an even input pads (2, 3), each 3x3/s2 (0, 1),
  the 3x3/s2 max pool (0, 1) with -inf.  PyTorch's ``padding=`` is
  symmetric, so odd totals are padded explicitly with ``F.pad``
  (:func:`_same_pads`); the space-to-depth stem pads (1, 2) (:177-199).
- **Convolutions** take and give the compute dtype; cuDNN accumulates
  in fp32 (fp32 runs in full fp32: ``resolve_device`` turns TF32 off).
- **Batch norm** (:157-174): biased batch moments of the fp32 values in
  training, the running statistics at inference, the output in the
  compute dtype; the new running statistics are ``momentum * old + (1 -
  momentum) * batch`` with the biased variance, and carry no gradient
  (``has_aux`` in the reference).  ``F.batch_norm`` normalises; its own
  running-statistics output is taken with momentum 1 into fresh buffers
  (the batch mean, and the unbiased variance, scaled back to the biased
  one), so the moments cost no second pass.
- **Head** (:252-254): the global average pool is a compute-dtype mean
  summed in fp32; the FC is a compute-dtype product rounded to the
  compute dtype, then fp32, then ``+ b``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models.transformer import compute_dtype
from deeplearning4j_tpu_torch.ops import updaters
from deeplearning4j_tpu_torch.runtime import compile_cache

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    n_classes: int = 1000
    compute_dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    stem_kernel: int = 7
    stem_stride: int = 2
    stem_pool: bool = True
    # the 7x7/s2 stem as a 4x4/s1 convolution of the 2x2 space-to-depth
    # image: the same contraction (:48-56); the params are the same
    # [7, 7, 3, width] filter either way
    stem_s2d: bool = False


def resnet50(n_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), n_classes=n_classes)


def resnet18_cfg(n_classes: int = 1000) -> ResNetConfig:
    # the same bottleneck machinery, shallower (:65)
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), n_classes=n_classes)


def resnet_tiny(n_classes: int = 10) -> ResNetConfig:
    """Test-sized: CIFAR-style stem, 2 stages (:70)."""
    return ResNetConfig(stage_sizes=(1, 1), width=8, n_classes=n_classes,
                        stem_kernel=3, stem_stride=1, stem_pool=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_channels(cfg: ResNetConfig, stage: int) -> Tuple[int, int]:
    mid = cfg.width * (2 ** stage)
    return mid, 4 * mid


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device: DeviceLike = None) -> Tuple[PyTree, PyTree]:
    """``(params, batch_stats)`` with the reference's trees (:95-139):
    He-normal (fan-out) filters, BN gains 1 and biases 0, running means
    0 and variances 1, the FC ``N(0, 0.01^2)``.  Drawn on the CPU from
    ``generator`` (a CPU generator) and moved to ``device``, so a seed
    gives the same weights on every device; the draws are not JAX's
    (carry JAX's params with :func:`params_from_numpy`)."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        std = (2.0 / (kh * kw * cout)) ** 0.5
        return std * torch.randn((kh, kw, cin, cout), generator=generator)

    def bn(c):
        return {"g": torch.ones(c), "b": torch.zeros(c)}

    def stats(c):
        return {"mean": torch.zeros(c), "var": torch.ones(c)}

    params: Dict[str, Any] = {
        "stem": {"w": conv(cfg.stem_kernel, cfg.stem_kernel, 3, cfg.width),
                 "bn": bn(cfg.width)}}
    bstats: Dict[str, Any] = {"stem": stats(cfg.width)}
    cin = cfg.width
    for s, n in enumerate(cfg.stage_sizes):
        mid, cout = _block_channels(cfg, s)
        for b in range(n):
            blk = {"c1": {"w": conv(1, 1, cin, mid), "bn": bn(mid)},
                   "c2": {"w": conv(3, 3, mid, mid), "bn": bn(mid)},
                   "c3": {"w": conv(1, 1, mid, cout), "bn": bn(cout)}}
            bst = {"c1": stats(mid), "c2": stats(mid), "c3": stats(cout)}
            if cin != cout or (b == 0 and s > 0):
                blk["proj"] = {"w": conv(1, 1, cin, cout), "bn": bn(cout)}
                bst["proj"] = stats(cout)
            params[f"s{s}b{b}"] = blk
            bstats[f"s{s}b{b}"] = bst
            cin = cout
    params["fc"] = {
        "w": torch.randn((cin, cfg.n_classes), generator=generator) * 0.01,
        "b": torch.zeros(cfg.n_classes)}
    return tuple(updaters.tree_map(lambda t: t.to(dev), tree)
                 for tree in (params, bstats))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding (low, high) of one spatial dim: the output
    is ``ceil(n / s)``, the low side takes the smaller half."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _filter(w: Tensor, cdt: torch.dtype) -> Tensor:
    """HWIO ``[kh, kw, Cin, Cout]`` -> ``[Cout, Cin, kh, kw]`` in the
    compute dtype, channels-last (one copy: the cast)."""
    return w.permute(3, 2, 0, 1).to(cdt, memory_format=torch.channels_last)


def _conv_padded(x: Tensor, w: Tensor, stride: int,
                 pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> Tensor:
    """``F.conv2d`` of NCHW ``x`` by ``w`` (``[Cout, Cin, kh, kw]``) with
    ``pads`` ((top, bottom), (left, right)): symmetric pads ride the
    convolution, asymmetric ones a zero ``F.pad`` first."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return F.conv2d(x, w, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def _conv(x: Tensor, w: Tensor, stride: int, cdt: torch.dtype) -> Tensor:
    """``"SAME"`` convolution (:147): x NCHW (channels-last) and the
    HWIO filter in the compute dtype, the output in it."""
    kh, kw = w.shape[0], w.shape[1]
    pads = (_same_pads(x.shape[2], kh, stride),
            _same_pads(x.shape[3], kw, stride))
    return _conv_padded(x.to(cdt), _filter(w, cdt), stride, pads)


def _bn(x: Tensor, p: Dict[str, Tensor], st: Dict[str, Tensor],
        train: bool, momentum: float, eps: float):
    """Batch norm of NCHW ``x`` (:157-174): ``(normalized x in x's dtype,
    new stats)``.  In training the moments are the batch's (biased
    variance) and the new stats their EMA, without gradient; at
    inference the running stats normalize and come back unchanged."""
    if not train:
        y = F.batch_norm(x, st["mean"], st["var"], p["g"], p["b"],
                         training=False, eps=eps)
        return y, st
    c = x.shape[1]
    mean = torch.zeros(c, dtype=torch.float32, device=x.device)
    var = torch.zeros(c, dtype=torch.float32, device=x.device)
    # momentum 1: the buffers take the batch mean and unbiased variance
    y = F.batch_norm(x, mean, var, p["g"], p["b"], training=True,
                     momentum=1.0, eps=eps)
    n = x.numel() // c
    var = var * ((n - 1) / n)
    new = {"mean": momentum * st["mean"] + (1 - momentum) * mean,
           "var": momentum * st["var"] + (1 - momentum) * var}
    return y, new


def _stem_s2d_conv(x: Tensor, w: Tensor, cdt: torch.dtype) -> Tensor:
    """The 7x7/s2 ``"SAME"`` stem of NHWC ``x`` as a 4x4/s1 convolution
    of its 2x2 space-to-depth rearrangement (:177-199): the image to
    ``[B, H/2, W/2, 4C]`` (channel index (dy, dx, c)), the filter padded
    to 8x8 on the high side and folded to ``[4, 4, 4C, Cout]``, block
    padding (1, 2).  Returns NCHW (channels-last)."""
    b, h_, w_, c = x.shape
    cin, cout = w.shape[2], w.shape[3]
    xs = x.reshape(b, h_ // 2, 2, w_ // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h_ // 2, w_ // 2, 4 * c)
    wp = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    ws = wp.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    ws = ws.reshape(4, 4, 4 * cin, cout)
    return _conv_padded(xs.permute(0, 3, 1, 2).to(cdt), _filter(ws, cdt), 1,
                        ((1, 2), (1, 2)))


def _max_pool_same(h: Tensor) -> Tensor:
    """The 3x3/s2 ``"SAME"`` max pool (:220-222), padded with -inf."""
    (t, b), (l, r) = _same_pads(h.shape[2], 3, 2), _same_pads(h.shape[3], 3,
                                                               2)
    return F.max_pool2d(F.pad(h, (l, r, t, b), value=float("-inf")), 3, 2)


def forward(cfg: ResNetConfig, params: PyTree, stats: PyTree, x: Tensor,
            train: bool = True) -> Tuple[Tensor, PyTree]:
    """x NHWC ``[B, H, W, 3]`` -> ``(logits [B, n_classes] fp32, new batch
    stats)`` (:202-254)."""
    cdt = compute_dtype(cfg)
    mom, eps = cfg.bn_momentum, cfg.bn_eps
    new_stats: Dict[str, Any] = {}

    if cfg.stem_s2d:
        if cfg.stem_kernel != 7 or cfg.stem_stride != 2:
            raise ValueError("stem_s2d factorizes exactly the 7x7/s2 "
                             "ImageNet stem")
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"stem_s2d needs even H/W (2x2 space-to-"
                             f"depth), got {tuple(x.shape)}")
        h = _stem_s2d_conv(x, params["stem"]["w"], cdt)
    else:
        h = _conv(x.permute(0, 3, 1, 2), params["stem"]["w"],
                  cfg.stem_stride, cdt)
    h, new_stats["stem"] = _bn(h, params["stem"]["bn"], stats["stem"], train,
                               mom, eps)
    h = F.relu(h)
    if cfg.stem_pool:
        h = _max_pool_same(h)

    for s, n in enumerate(cfg.stage_sizes):
        for b in range(n):
            name = f"s{s}b{b}"
            blk, bst = params[name], stats[name]
            nst: Dict[str, Any] = {}
            stride = 2 if (b == 0 and s > 0) else 1

            r = _conv(h, blk["c1"]["w"], 1, cdt)
            r, nst["c1"] = _bn(r, blk["c1"]["bn"], bst["c1"], train, mom, eps)
            r = F.relu(r)
            # v1.5: the stride lives on the 3x3
            r = _conv(r, blk["c2"]["w"], stride, cdt)
            r, nst["c2"] = _bn(r, blk["c2"]["bn"], bst["c2"], train, mom, eps)
            r = F.relu(r)
            r = _conv(r, blk["c3"]["w"], 1, cdt)
            r, nst["c3"] = _bn(r, blk["c3"]["bn"], bst["c3"], train, mom, eps)

            if "proj" in blk:
                h = _conv(h, blk["proj"]["w"], stride, cdt)
                h, nst["proj"] = _bn(h, blk["proj"]["bn"], bst["proj"],
                                     train, mom, eps)
            h = F.relu(h + r)
            new_stats[name] = nst

    # global average pool: a compute-dtype mean summed in fp32
    h = torch.mean(h, dim=(2, 3), dtype=torch.float32).to(cdt)
    logits = (h @ params["fc"]["w"].to(cdt)).float() + params["fc"]["b"]
    return logits, new_stats


def loss_fn(cfg: ResNetConfig, params: PyTree, stats: PyTree, x: Tensor,
            labels: Tensor) -> Tuple[Tensor, PyTree]:
    """Softmax cross-entropy with integer labels: ``(loss, new stats)``."""
    logits, new_stats = forward(cfg, params, stats, x, train=True)
    ll = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(ll, -1, labels.long()[:, None]).mean()
    return loss, new_stats


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """``(params, batch_stats, opt_state, step)`` (:262); ``step``
    counts the optimizer steps taken."""
    params: PyTree
    batch_stats: PyTree
    opt_state: Any
    step: int


def make_train_step(cfg: ResNetConfig, mesh=None, optimizer=None,
                    n_steps: int = 1, device: DeviceLike = None
                    ) -> Tuple[Callable, Callable]:
    """``(init_fn(generator) -> TrainState, step_fn(state, x, labels) ->
    (state, loss))`` on one device (:269-333).  ``optimizer`` defaults to
    ``updaters.sgd(0.1, momentum=0.9, nesterov=True)``.  ``n_steps > 1``
    runs that many optimizer steps inside one captured graph and returns
    the ``[n_steps]`` losses, as JAX's scan.  ``mesh=`` (the reference's
    data-sharded step) raises: it is ROADMAP A7.

    The step runs through the compile engine (``runtime/compile_cache``,
    label ``resnet.train_step``): on the card one CUDA graph a batch
    shape, the params, batch stats and optimizer state donated (updated
    in place; ``transformer.make_train_step`` has the contract).
    ``step_fn.graph`` is the engine entry (``.fn`` the raw step)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded ResNet training is not ported to the PyTorch "
            "package yet (ROADMAP A7)")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = updaters.sgd(0.1, momentum=0.9, nesterov=True)

    def init_fn(generator: torch.Generator) -> TrainState:
        params, stats = init_params(generator, cfg, dev)
        return TrainState(params, stats, optimizer.init(params), 0)

    def one_step(params, stats, opt_state, x, labels) -> Tensor:
        live = updaters.tree_map(lambda p: p.detach().requires_grad_(True),
                                 params)
        with torch.enable_grad():
            loss, new_stats = loss_fn(cfg, live, stats, x, labels)
        grads = updaters.tree_unflatten(params, torch.autograd.grad(
            loss, updaters.tree_leaves(live)))
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, opt_state, params)
            updaters.copy_into(params, updaters.apply_updates(params,
                                                              updates))
            updaters.copy_into(opt_state, new_opt)
            updaters.copy_into(stats, new_stats)
        return loss.detach()

    def graph_step(params, stats, opt_state, x, labels):
        losses = [one_step(params, stats, opt_state, x, labels)
                  for _ in range(n_steps)]
        loss = losses[0] if n_steps == 1 else torch.stack(losses)
        return params, stats, opt_state, loss

    graph = compile_cache.cached_graph(graph_step, label="resnet.train_step",
                                       donate_argnums=(0, 1, 2))

    def step_fn(state: TrainState, x: Tensor, labels: Tensor):
        params, stats, opt_state, loss = graph(
            state.params, state.batch_stats, state.opt_state, x, labels)
        return TrainState(params, stats, opt_state,
                          state.step + n_steps), loss

    step_fn.graph = graph
    return init_fn, step_fn


def predict(cfg: ResNetConfig, state: TrainState, x: Tensor) -> Tensor:
    logits, _ = forward(cfg, state.params, state.batch_stats, x, train=False)
    return torch.argmax(logits, dim=-1)


def synthetic_batch(seed: int, cfg: ResNetConfig, batch: int,
                    image_size: int = 224, device: DeviceLike = None
                    ) -> Tuple[Tensor, Tensor]:
    """Seeded ``N(0, 1)`` NHWC images and uniform labels (:336-341),
    drawn on the CPU so a seed gives the same batch on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, image_size, image_size, 3), generator=gen)
    y = torch.randint(0, cfg.n_classes, (batch,), generator=gen,
                      dtype=torch.int32)
    return x.to(dev), y.to(dev)


def param_count(params: PyTree) -> int:
    return sum(int(p.numel()) for p in updaters.tree_leaves(params))


def make_serving_apply(cfg: ResNetConfig):
    """``(apply_fn, cache_key)`` for ``serving/engine.InferenceEngine``
    (:348-359): images ``[B, H, W, 3]`` -> logits ``[B, n_classes]``,
    batch norm in inference mode (the running stats: rows independent,
    so bucket padding changes no real row beyond the convolution
    algorithm cuDNN picks for the batch size).  The engine's ``params``
    is the pair ``(params, batch_stats)``, so a swap replaces both."""

    def apply_fn(params_and_stats, x):
        params, stats = params_and_stats
        logits, _ = forward(cfg, params, stats, x, train=False)
        return logits

    return apply_fn, ("resnet_serving", repr(cfg))


# ---------------------------------------------------------------------------
# the reference's trees, as numpy
# ---------------------------------------------------------------------------

def params_from_numpy(tree: PyTree, device: DeviceLike = None) -> PyTree:
    """A JAX params or batch-stats tree as numpy (``jax.tree.map(
    np.asarray, ...)``, or a ``runtime.checkpoint.load_numpy_tree``
    subtree) -> the port's, on ``device``.  The layouts are the same
    (HWIO filters), so this is a copy of every leaf."""
    dev = resolve_device(device)
    return updaters.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def train_state_from_numpy(tree: PyTree,
                           device: DeviceLike = None) -> TrainState:
    """A JAX ``TrainState`` read as a tree (``load_numpy_tree``) -> the
    port's.  optax's SGD chain ``(TraceState, EmptyState)`` holds
    ``opt_state/0/trace/...`` with momentum and nothing without."""
    dev = resolve_device(device)
    trace = tree.get("opt_state", {}).get("0", {}).get("trace")
    opt = updaters.TraceState(
        None if trace is None else params_from_numpy(trace, dev))
    return TrainState(params_from_numpy(tree["params"], dev),
                      params_from_numpy(tree["batch_stats"], dev), opt,
                      int(np.asarray(tree["step"])))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's :class:`TrainState` as numpy in JAX's tree order, so
    ``runtime.checkpoint.save_pytree`` writes the paths JAX's state
    flattens to and the JAX package restores it ``like=`` its own."""
    from deeplearning4j_tpu_torch.runtime.checkpoint import _to_numpy

    trace = state.opt_state.trace
    opt = ((updaters.TraceState(updaters.tree_map(_to_numpy, trace)), ())
           if trace is not None else ((), ()))
    return TrainState(updaters.tree_map(_to_numpy, state.params),
                      updaters.tree_map(_to_numpy, state.batch_stats), opt,
                      np.asarray(state.step, np.int32))
