"""Optimizers over the port's parameter trees (nested dicts of tensors).

The JAX package trains its transformer family with ``optax.adamw``
(``models/bert.py:197``, ``models/gpt.py:125``); :func:`adamw` here is
that transformation, step for step, as optax 0.2.6 computes it
(``optax.adamw`` = ``scale_by_adam`` -> ``add_decayed_weights`` ->
``scale_by_learning_rate``), so the two packages take the same steps
from the same gradients.  ``torch.optim.AdamW`` is not used: it folds
the decay into the parameter before the Adam step and keeps its own
step-count rules.  ResNet trains with ``optax.sgd`` with Nesterov
momentum (``models/resnet.py:287``): :func:`sgd`.  :func:`dl4j_updater`
is the reference's ``ops/updaters.py:dl4j_updater`` (:41-118), the
GradientAdjustment chain that ``nn/multilayer`` trains with; its
updates are subtracted (:func:`apply_descent`).

An optimizer is a :class:`GradientTransformation` of two functions, as
in optax: ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)``; :func:`apply_updates` adds the updates.  Trees
are nested ``dict``s whose leaves are tensors; gradients share their
params' structure.  State is fp32 and lives on the params' device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

Tensor = torch.Tensor
Tree = Dict[str, Any]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts, lists and (named) tuples
    of the same structure; a None leaf stays None."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val, *(r[key] for r in rest))
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, val, *(r[i] for r in rest))
                for i, val in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in key order (the order :func:`tree_map` rebuilds)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for val in tree for leaf in tree_leaves(val)]
    return [] if tree is None else [tree]


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst`` (nested dicts, tuples and named tuples of one structure),
    skipping a leaf that already is its destination: how a donated
    training state takes its step's result in place."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for key, val in dst.items():
            copy_into(val, src[key])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_into(d, s)


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """A tree of ``tree``'s structure over ``leaves`` (from
    :func:`tree_leaves`)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Any]


class AdamWState(NamedTuple):
    """``ScaleByAdamState``: the step count (a 0-d int32 tensor on the
    params' device, as optax's) and the fp32 first and second moments
    (the decay and the learning-rate scale keep none)."""
    count: Tensor
    mu: Tree
    nu: Tree


def adamw(learning_rate: float, weight_decay: float = 1e-4, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`` with
    optax's defaults (``eps_root=0``, no mask: the decay applies to every
    leaf).  Per leaf, in optax's order:

    - mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu  (fp32);
    - count += 1;  mu_hat = mu / (1 - b1^count),  nu_hat likewise, the
      corrections computed in fp32 as ``1 - decay**count`` on the
      device, so a step reads no host number and a captured step
      (``runtime/compile_cache``) replays with the live count;
    - u = mu_hat / (sqrt(nu_hat) + eps);  u = u + weight_decay * p;
      u = -learning_rate * u.
    """

    def init(params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        dev = tree_leaves(params)[0].device
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def update(grads: Tree, state: AdamWState, params: Tree):
        count = state.count + 1
        # 1 - decay**count in fp32, as optax's bias_correction
        # (a Python base: no host-to-device copy inside a captured step)
        n = count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, n)
        c2 = 1.0 - torch.pow(b2, n)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)

        def step(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            return (u + weight_decay * p) * -learning_rate

        updates = tree_map(step, mu, nu, params)
        return updates, AdamWState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


class TraceState(NamedTuple):
    """optax's ``TraceState``: the momentum trace, a tree of the params'
    structure (None when :func:`sgd` runs without momentum)."""
    trace: Optional[Tree]


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """``optax.sgd(learning_rate, momentum, nesterov)``: optax's
    ``trace`` then ``scale_by_learning_rate``.  Per leaf, with momentum
    m: the trace t' = g + m t; the update is -lr (g + m t') with
    Nesterov, else -lr t'.  Without momentum the update is -lr g and
    the state holds no trace.  The trace keeps the params' dtype, as
    optax's (``accumulator_dtype=None``)."""

    def init(params: Tree) -> TraceState:
        if momentum is None:
            return TraceState(trace=None)
        return TraceState(trace=tree_map(torch.zeros_like, params))

    def update(grads: Tree, state: TraceState, params: Tree = None):
        if momentum is None:
            return tree_map(lambda g: g * -learning_rate, grads), state
        trace = tree_map(lambda g, t: g + momentum * t, grads, state.trace)
        upd = (tree_map(lambda g, t: g + momentum * t, grads, trace)
               if nesterov else trace)
        return (tree_map(lambda u: u * -learning_rate, upd),
                TraceState(trace=trace))

    return GradientTransformation(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``optax.apply_updates``: p + u, in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


class UpdaterState(NamedTuple):
    """AdaGrad's sum of squared gradients and the momentum velocity,
    each a tree of the params' structure."""
    adagrad_accum: Tree
    momentum_buf: Tree


class Dl4jUpdater(NamedTuple):
    """``init(params) -> UpdaterState`` and ``update(state, grads, params,
    iteration, batch_size) -> (updates, state)``."""
    init: Callable[[Tree], UpdaterState]
    update: Callable[..., Any]


def _is_weight_key(key: str) -> bool:
    """A leaf whose dict key names a weight matrix: ``W`` or ``*_W``."""
    return key == "W" or key.endswith("_W")


def dl4j_updater(
    lr: float = 1e-1,
    momentum: float = 0.5,
    momentum_schedule: Optional[Dict[int, float]] = None,
    use_adagrad: bool = False,
    l2: float = 0.0,
    use_regularization: bool = False,
    constrain_unit_norm: bool = False,
    adagrad_eps: float = 1e-6,
) -> Dl4jUpdater:
    """The reference's update rule, in its order (GradientAdjustment.java
    :50-113):

    1. AdaGrad, ``lr * g / (sqrt(a) + eps)`` with ``a += g^2``, else
       ``lr * g``;
    2. heavy-ball momentum ``v = m v + g``, where ``m`` is ``momentum``
       replaced by ``momentum_schedule[k]`` from ``iteration >= k``;
    3. L2 (when ``use_regularization`` and ``l2 > 0``): ``+ lr l2 p`` on
       weight leaves only (key ``W`` or ``*_W``);
    4. unit norm: ``u / (||u|| + 1e-12)``;
    5. times ``1 / max(batch_size, 1)``.

    The updates are subtracted from the params.  ``iteration`` is an int
    or a 0-d device tensor (the captured train step passes its device
    counter); with a schedule the momentum is selected on the device.
    """
    schedule = tuple(sorted((momentum_schedule or {}).items()))

    def init(params: Tree) -> UpdaterState:
        return UpdaterState(adagrad_accum=tree_map(torch.zeros_like, params),
                            momentum_buf=tree_map(torch.zeros_like, params))

    def momentum_at(iteration):
        """The momentum at ``iteration``: a float without a schedule,
        else an fp32 tensor selected on the device (``iteration`` an int
        or a 0-d tensor), as the reference's ``jnp.where`` chain."""
        if not schedule:
            return momentum
        it = torch.as_tensor(iteration)
        # filled on the device: no host-to-device copy in a captured step
        m = torch.full((), momentum, dtype=torch.float32, device=it.device)
        for after, value in schedule:
            m = torch.where(it >= after, value, m)
        return m

    def with_l2(upd: Tree, params: Tree, coeff: float) -> Tree:
        return {key: (with_l2(u, params[key], coeff) if isinstance(u, dict)
                      else u + coeff * params[key] if _is_weight_key(key)
                      else u)
                for key, u in upd.items()}

    def update(state: UpdaterState, grads: Tree, params: Tree,
               iteration: int = 0, batch_size: int = 1):
        inv_batch = 1.0 / max(float(batch_size), 1.0)
        if use_adagrad:
            accum = tree_map(lambda a, g: a + g * g, state.adagrad_accum,
                             grads)
            scaled = tree_map(
                lambda g, a: lr * g / (torch.sqrt(a) + adagrad_eps), grads,
                accum)
        else:
            accum = state.adagrad_accum
            scaled = tree_map(lambda g: lr * g, grads)
        m = momentum_at(iteration)
        buf = tree_map(lambda v, g: m * v + g, state.momentum_buf, scaled)
        upd = buf
        if use_regularization and l2 > 0.0:
            upd = with_l2(upd, params, lr * l2)
        if constrain_unit_norm:
            upd = tree_map(lambda u: u / (torch.linalg.norm(u.reshape(-1))
                                          + 1e-12), upd)
        if inv_batch != 1.0:      # x 1.0 is exact: skip its launches
            upd = tree_map(lambda u: u * inv_batch, upd)
        return upd, UpdaterState(adagrad_accum=accum, momentum_buf=buf)

    return Dl4jUpdater(init, update)


def apply_descent(params: Tree, updates: Tree) -> Tree:
    """p - u: the reference's ``ops/updaters.apply_updates`` (:124), the
    gradient-descent application of :func:`dl4j_updater`'s updates."""
    return tree_map(lambda p, u: p - u, params, updates)
