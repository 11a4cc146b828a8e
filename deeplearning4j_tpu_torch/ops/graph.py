"""Symbolic graph builder: the SameDiff / op-graph role.

Port of ``deeplearning4j_tpu/ops/graph.py``: the reference-style
imperative building API (define placeholders, compose string-named ops,
differentiate, execute) over PyTorch:

    g = GraphBuilder(device="cpu")
    x = g.placeholder("x", (8, 4))
    w = g.variable("w", np.random.randn(4, 2))
    b = g.variable("b", np.zeros(2))
    y = g.softmax(g.add(g.matmul(x, w), b))
    loss = g.mean(g.square(g.sub(y, g.placeholder("t", (8, 2)))))

    g.fx_graph(loss)        # the traced torch.fx graph (inspection)
    g.exported_graph(loss)  # torch.export's ATen graph
    f = g.compile(loss)     # f(x=..., t=...) -> value
    grads = g.grad(loss)    # d loss / d each variable

Every op node is a closure over its inputs; nothing runs until
``compile``/``grad`` evaluate the whole graph, each a function of the
compile engine (``runtime/compile_cache.cached_graph``: one CUDA graph a
signature on the card, the counterpart of ``jax.jit``).  The reference's
two inspection methods have no exact PyTorch twin: ``jaxpr`` (:227) is
:meth:`GraphBuilder.fx_graph`, the ``make_fx`` trace's text, and ``hlo``
(:233) is :meth:`GraphBuilder.exported_graph`, ``torch.export``'s ATen
graph text.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

Tensor = torch.Tensor


def _as_tensor(value, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> Tensor:
    """``value`` as a tensor on ``device``; float64 becomes fp32 (as JAX
    without x64 takes numpy arrays) unless ``dtype`` says otherwise."""
    t = torch.as_tensor(value)
    if dtype is None and t.dtype == torch.float64:
        dtype = torch.float32
    return t.to(device=device, dtype=dtype)


def _reduce(f):
    def run(x: Tensor, axis=None, keepdims: bool = False) -> Tensor:
        dims = tuple(range(x.dim())) if axis is None else axis
        return f(x, dim=dims, keepdim=keepdims)
    return run


@dataclasses.dataclass(frozen=True)
class Node:
    """One graph vertex: op name + parents; ``fn(env)`` computes its
    value given the placeholder/variable environment."""
    graph: "GraphBuilder"
    name: str
    op: str
    parents: Tuple["Node", ...]
    fn: Callable[[Dict[str, Tensor]], Tensor]

    def __repr__(self) -> str:
        ps = ", ".join(p.name for p in self.parents)
        return f"{self.name} = {self.op}({ps})"


class GraphBuilder:
    """Imperative graph construction (SameDiff role); variables and
    inputs live on ``device`` (None means ``"cuda"``)."""

    #: elementwise/binary ops exposed as builder methods, named like the
    #: reference's string-dispatched transforms (ops/registry parity)
    _UNARY = {
        "sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "exp": torch.exp, "log": torch.log, "neg": torch.neg,
        "abs": torch.abs, "sqrt": torch.sqrt, "square": torch.square,
        "softmax": lambda x: torch.softmax(x, dim=-1),
    }
    _BINARY = {
        "add": torch.add, "sub": torch.sub, "mul": torch.mul,
        "div": torch.div, "pow": torch.pow, "maximum": torch.maximum,
        "minimum": torch.minimum,
    }
    _REDUCE = {"sum": _reduce(torch.sum), "mean": _reduce(torch.mean),
               "max": _reduce(torch.amax), "min": _reduce(torch.amin)}

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        #: name -> (shape, dtype)
        self.placeholders: Dict[str, Tuple[tuple, torch.dtype]] = {}
        self.variables: Dict[str, Tensor] = {}
        self.nodes: List[Node] = []
        self._counter = 0

    # -- leaves -------------------------------------------------------------
    def placeholder(self, name: str, shape: Sequence[int],
                    dtype: torch.dtype = torch.float32) -> Node:
        """Runtime input (SameDiff placeholder)."""
        if name in self.placeholders or name in self.variables:
            raise ValueError(f"name {name!r} already defined")
        self.placeholders[name] = (tuple(shape), dtype)
        return self._add(name, "placeholder", (),
                         lambda env, _n=name: env[_n])

    def variable(self, name: str, value) -> Node:
        """Trainable leaf (SameDiff variable); ``grad`` differentiates
        with respect to these."""
        if name in self.placeholders or name in self.variables:
            raise ValueError(f"name {name!r} already defined")
        self.variables[name] = _as_tensor(value, self.device)
        return self._add(name, "variable", (),
                         lambda env, _n=name: env[_n])

    def constant(self, value) -> Node:
        arr = _as_tensor(value, self.device)
        return self._add(self._fresh("const"), "constant", (),
                         lambda env, _a=arr: _a)

    # -- ops ----------------------------------------------------------------
    def _add(self, name: str, op: str, parents: Tuple[Node, ...],
             raw_fn: Callable[[Dict[str, Tensor]], Tensor]) -> Node:
        for p in parents:
            if p.graph is not self:
                # the evaluation cache keys on per-builder node ids, so a
                # foreign node would silently alias another node's value
                raise ValueError(
                    f"node {p.name!r} belongs to a different GraphBuilder")
        node_id = len(self.nodes)

        def fn(env: Dict[str, Tensor], _raw=raw_fn, _id=node_id) -> Tensor:
            # memoize per evaluation: a node shared by several consumers
            # runs once, not once per consumer (a deep shared DAG would
            # otherwise blow up exponentially)
            cache = env.setdefault("__node_cache__", {})
            if _id not in cache:
                cache[_id] = _raw(env)
            return cache[_id]

        node = Node(self, name, op, parents, fn)
        self.nodes.append(node)
        return node

    def _fresh(self, op: str) -> str:
        self._counter += 1
        return f"{op}_{self._counter}"

    def apply(self, op: str, *args: Node, **kw) -> Node:
        """String-named dispatch, the op-factory surface
        (Nd4j.getOpFactory() parity): ``g.apply("tanh", x)``."""
        if op in self._REDUCE:
            unknown = set(kw) - {"axis", "keepdims"}
            if unknown:
                raise TypeError(f"{op} got unexpected kwargs "
                                f"{sorted(unknown)}")
            (a,) = args
            f = self._REDUCE[op]
            axis = kw.get("axis")
            keepdims = kw.get("keepdims", False)
            return self._add(self._fresh(op), op, (a,),
                             lambda env, _a=a: f(_a.fn(env), axis=axis,
                                                 keepdims=keepdims))
        if kw:
            raise TypeError(f"{op} takes no kwargs, got {sorted(kw)}")
        if op in self._UNARY:
            (a,) = args
            f = self._UNARY[op]
            return self._add(self._fresh(op), op, (a,),
                             lambda env, _a=a: f(_a.fn(env)))
        if op in self._BINARY:
            a, b = args
            f = self._BINARY[op]
            return self._add(self._fresh(op), op, (a, b),
                             lambda env, _a=a, _b=b: f(_a.fn(env),
                                                       _b.fn(env)))
        # fall through to the activation registry, so user-registered
        # activations (ops/registry.register_activation) work here too;
        # only a lookup miss means "unknown op"
        from deeplearning4j_tpu_torch.ops.registry import get_activation
        try:
            f = get_activation(op)
        except ValueError:
            raise ValueError(f"unknown op {op!r}") from None
        (a,) = args
        return self._add(self._fresh(op), op, (a,),
                         lambda env, _a=a: f(_a.fn(env)))

    def __getattr__(self, op: str):
        # builder method sugar: g.tanh(x), g.add(a, b), g.sum(x, axis=0)
        if op in (*self._UNARY, *self._BINARY, *self._REDUCE):
            return lambda *args, **kw: self.apply(op, *args, **kw)
        raise AttributeError(op)

    def matmul(self, a: Node, b: Node) -> Node:
        return self._add(self._fresh("matmul"), "matmul", (a, b),
                         lambda env, _a=a, _b=b: torch.matmul(_a.fn(env),
                                                              _b.fn(env)))

    def reshape(self, a: Node, shape: Sequence[int]) -> Node:
        shape = tuple(shape)
        return self._add(self._fresh("reshape"), "reshape", (a,),
                         lambda env, _a=a: torch.reshape(_a.fn(env), shape))

    def transpose(self, a: Node, axes: Optional[Sequence[int]] = None
                  ) -> Node:
        def run(env, _a=a):
            x = _a.fn(env)
            perm = tuple(axes) if axes is not None \
                else tuple(range(x.dim() - 1, -1, -1))
            return x.permute(perm)
        return self._add(self._fresh("transpose"), "transpose", (a,), run)

    # -- tracing / execution ------------------------------------------------
    def _reachable_placeholders(self, out: Node) -> set:
        """Placeholder names ``out`` depends on (SameDiff only requires
        the inputs the requested output consumes)."""
        seen, stack, names = set(), [out], set()
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if n.op == "placeholder":
                names.add(n.name)
            stack.extend(n.parents)
        return names

    def _as_function(self, out: Node) -> Callable:
        """(variables_dict, **placeholders) -> value: the whole graph as
        one function."""
        required = self._reachable_placeholders(out)

        def f(variables: Dict[str, Tensor], **placeholders: Tensor
              ) -> Tensor:
            missing = required - set(placeholders)
            if missing:
                raise ValueError(f"missing placeholders: {sorted(missing)}")
            return out.fn({**variables, **placeholders})
        return f

    def _inputs(self, placeholders) -> Dict[str, Tensor]:
        return {n: _as_tensor(v, self.device,
                              self.placeholders[n][1]
                              if n in self.placeholders else None)
                for n, v in placeholders.items()}

    def _example_args(self, out: Node) -> Dict[str, Tensor]:
        req = self._reachable_placeholders(out)
        return {n: torch.zeros(shape, dtype=dtype, device=self.device)
                for n, (shape, dtype) in self.placeholders.items()
                if n in req}

    def fx_graph(self, out: Node) -> str:
        """The graph traced to ATen ops by ``make_fx``, as torch.fx text
        (the reference's ``jaxpr``)."""
        from torch.fx.experimental.proxy_tensor import make_fx

        f = self._as_function(out)
        gm = make_fx(lambda v, p: f(v, **p))(dict(self.variables),
                                             self._example_args(out))
        return str(gm.graph)

    def exported_graph(self, out: Node) -> str:
        """``torch.export``'s ATen graph of ``out`` as text (the
        reference's ``hlo``: the graph lowered for the compiler)."""
        f = self._as_function(out)

        class Graph(torch.nn.Module):
            def forward(self, variables, placeholders):
                return f(variables, **placeholders)

        ep = torch.export.export(
            Graph(), (dict(self.variables), self._example_args(out)))
        return str(ep.graph_module.graph)

    def compile(self, out: Node) -> Callable:
        """An executable over the CURRENT variable values:
        ``f(**placeholders) -> value`` (a tensor on ``device``)."""
        from deeplearning4j_tpu_torch.runtime import compile_cache

        graph_fn = self._as_function(out)

        def value(variables, **placeholders):
            with torch.no_grad():
                return graph_fn(variables, **placeholders)

        base = compile_cache.cached_graph(value, label="graph.compile")

        def run(**placeholders) -> Tensor:
            return base(self.variables, **self._inputs(placeholders))
        return run

    def grad(self, out: Node, wrt: Optional[Sequence[str]] = None
             ) -> Callable:
        """Gradient of a SCALAR output with respect to the named
        variables (default: all): ``g(**placeholders) -> {name: grad}``.
        Each call reads the current values of every variable."""
        names = list(wrt) if wrt is not None else list(self.variables)
        unknown = set(names) - set(self.variables)
        if unknown:
            raise ValueError(f"not variables: {sorted(unknown)}")
        from deeplearning4j_tpu_torch.runtime import compile_cache

        graph_fn = self._as_function(out)

        def gradients(variables, **placeholders):
            live = {n: v.detach().requires_grad_(n in names)
                    for n, v in variables.items()}
            with torch.enable_grad():
                value = graph_fn(live, **placeholders)
            grads = torch.autograd.grad(value, [live[n] for n in names])
            return dict(zip(names, grads))

        base = compile_cache.cached_graph(gradients, label="graph.grad")

        def run(**placeholders) -> Dict[str, Tensor]:
            return base(self.variables, **self._inputs(placeholders))
        return run

    def set_variable(self, name: str, value) -> None:
        if name not in self.variables:
            raise KeyError(name)
        self.variables[name] = _as_tensor(value, self.device)

    def __repr__(self) -> str:
        lines = [f"GraphBuilder({len(self.nodes)} nodes)"]
        lines += [f"  {n!r}" for n in self.nodes]
        return "\n".join(lines)
