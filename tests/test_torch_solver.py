"""The port's solver family (``optimize/{terminations,line_search,solver}.py``)
against the JAX reference on the CPU.

The same numpy inputs go through both packages:
- the termination conditions, table-driven;
- ``backtrack_line_search`` on a quadratic and a softmax regression: the
  step, ``f_new`` and the number of evaluations (JAX's counted by a
  ``jax.debug.callback`` in its value function, which runs once an
  evaluation inside the reference's ``while_loop``);
- gradient descent, line-search gradient descent, conjugate gradient and
  L-BFGS at the Solver level on an L2-regularized softmax regression of
  the Iris surrogate, with an ``EpsTermination`` that fires mid-run: the
  per-iteration scores, the trials each iteration's line search took,
  the iteration the run stopped at and the final params;
- ``MultiLayerNetwork.finetune`` on a small dense conf (tanh 4-8, a
  softmax head) for each algorithm the Solver dispatches to;
- a NaN objective (the guard keeps the iterate and counts the skip) and
  the capture contract (after each function's first call, no capture
  for the rest of a run), through the CPU stand-in for the capture of
  ``tests/test_torch_compile_cache.py``.

Tolerances: scores rtol 1e-4, params atol 1e-5 (fp32, the bars of
tests/test_torch_lenet.py);
line-search steps and values rtol 1e-6.  L-BFGS through ``finetune`` runs
6 iterations: the unregularized output-layer objective is nearly
separable, and L-BFGS's history turns the two frameworks' last-ulp
differences into visibly different paths after ~8 iterations (3e-6 at
iteration 7, 3e-2 by 30); on the regularized objective both packages
stay within 2e-7 to the stopping iteration.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers import IrisDataFetcher
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import line_search as jls
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu.optimize import terminations as jterm
from deeplearning4j_tpu.optimize.listeners import \
    CollectScoresListener as JCollect
from deeplearning4j_tpu.runtime.metrics import \
    resilience_metrics as jresilience
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.optimize import line_search as tls
from deeplearning4j_tpu_torch.optimize import solver as tsolver
from deeplearning4j_tpu_torch.optimize import terminations as tterm
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresListener as TCollect
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                      resilience_metrics)
from test_torch_compile_cache import graphs_on_cpu  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SCORE_RTOL, PARAM_ATOL, LS_RTOL = 1e-4, 1e-5, 1e-6
L2 = 0.01


@pytest.fixture(autouse=True)
def fresh_engine():
    compile_cache.clear()
    compile_metrics.reset()
    resilience_metrics.reset()
    yield


# -- terminations ------------------------------------------------------------

TERMINATION_CASES = [
    # (class name, ctor kwargs, new, old, grad norm)
    ("EpsTermination", {}, 1.0, float("inf"), 1.0),
    ("EpsTermination", {}, 1.0, 1.0, 1.0),
    ("EpsTermination", {}, 1.0, 1.0 + 1e-6, 1.0),
    ("EpsTermination", {}, 1.0, 1.001, 1.0),
    ("EpsTermination", {"eps": 1e-2}, 1.0, 1.005, 1.0),
    ("EpsTermination", {"eps": 0.0, "tolerance": 1e-3}, 1.0, 1.0005, 1.0),
    ("EpsTermination", {}, 0.0, 0.0, 1.0),
    ("ZeroDirection", {}, 1.0, 2.0, 0.0),
    ("ZeroDirection", {}, 1.0, 2.0, 1e-30),
    ("Norm2Termination", {}, 1.0, 2.0, 1e-7),
    ("Norm2Termination", {}, 1.0, 2.0, 1e-5),
    ("Norm2Termination", {"gradient_tolerance": 1e-2}, 1.0, 2.0, 5e-3),
    ("InvalidScore", {}, float("nan"), 1.0, 1.0),
    ("InvalidScore", {}, float("inf"), 1.0, 1.0),
    ("InvalidScore", {}, 1.0, float("nan"), 1.0),
]


@pytest.mark.parametrize("name,kw,new,old,gnorm", TERMINATION_CASES)
def test_terminations_match_reference(name, kw, new, old, gnorm):
    ref = getattr(jterm, name)(**kw).terminate(new, old, gnorm)
    got = getattr(tterm, name)(**kw).terminate(new, old, gnorm)
    assert got == ref and isinstance(got, bool)


# -- the line search ---------------------------------------------------------

def _jax_counted(value_fn):
    """JAX's value function with an evaluation counter."""
    calls = []

    def counted(x):
        jax.debug.callback(lambda: calls.append(1))
        return value_fn(x)
    return counted, calls


def _quadratic(pkg):
    a = np.linspace(0.5, 4.0, 6).astype(np.float32)

    def value(x):
        return 0.5 * (pkg.asarray(a) * x * x).sum() if pkg is jnp \
            else 0.5 * (torch.from_numpy(a) * x * x).sum()
    return value


def _softmax_regression(pkg):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]

    def value(w):
        if pkg is jnp:
            z = jnp.asarray(x) @ w.reshape(5, 3)
            return -jnp.mean(jnp.sum(jnp.asarray(y)
                                     * jax.nn.log_softmax(z), -1))
        z = torch.from_numpy(x) @ w.reshape(5, 3)
        return -torch.mean(torch.sum(torch.from_numpy(y)
                                     * torch.log_softmax(z, -1), -1))
    return value


LS_CASES = [
    # (objective, n, initial_step, direction: "descent"/"ascent", kwargs)
    ("quadratic", 6, 1.0, "descent", {}),
    ("quadratic", 6, 8.0, "descent", {}),
    ("quadratic", 6, 64.0, "descent", {"max_steps": 3}),
    ("quadratic", 6, 1.0, "ascent", {}),
    ("softmax", 15, 1.0, "descent", {}),
    ("softmax", 15, 40.0, "descent", {"shrink": 0.3}),
    ("softmax", 15, 1e-9, "descent", {"min_step": 1e-8}),
]


@pytest.mark.parametrize("obj,n,t0,way,kw", LS_CASES)
def test_backtrack_line_search_matches_reference(obj, n, t0, way, kw):
    make = _quadratic if obj == "quadratic" else _softmax_regression
    x0 = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    jval, tval = make(jnp), make(torch)
    g = np.array(jax.grad(jval)(jnp.asarray(x0)))
    d = -g if way == "descent" else g
    f0 = np.float32(jval(jnp.asarray(x0)))
    slope = np.float32(np.dot(g, d))
    counted, calls = _jax_counted(jval)
    jstep, jf = jax.jit(lambda x, d: jls.backtrack_line_search(
        counted, x, d, jnp.float32(f0), jnp.float32(slope),
        initial_step=t0, **kw))(jnp.asarray(x0), jnp.asarray(d))
    jstep, jf = float(jstep), float(jf)
    tstep, tf, trials = tls.backtrack_line_search(
        tval, torch.from_numpy(x0), torch.from_numpy(d),
        torch.tensor(f0), torch.tensor(slope), initial_step=t0, **kw)
    assert trials == len(calls)
    np.testing.assert_allclose(float(tstep), jstep, rtol=LS_RTOL)
    np.testing.assert_allclose(float(tf), jf, rtol=LS_RTOL)
    if way == "ascent":
        assert float(tstep) == 0.0 and float(tf) == float(f0)


# -- the solvers on a regularized softmax regression --------------------------

def _iris():
    f = IrisDataFetcher()
    x = (f.features - f.features.mean(0)) / f.features.std(0)
    return x.astype(np.float32), f.labels


def _objectives(scale: float = 1.0):
    """The regularized softmax regression, times ``scale`` (a large
    scale makes L-BFGS's first unit step overshoot, so its search
    backtracks)."""
    x, y = _iris()

    def jloss(p):
        z = jnp.asarray(x) @ p["W"] + p["b"]
        return scale * (-jnp.mean(jnp.sum(
            jnp.asarray(y) * jax.nn.log_softmax(z), -1))
            + L2 * jnp.sum(p["W"] ** 2))

    def tloss(p):
        z = torch.from_numpy(x) @ p["W"] + p["b"]
        return scale * (-torch.mean(torch.sum(
            torch.from_numpy(y) * torch.log_softmax(z, -1), -1))
            + L2 * torch.sum(p["W"] ** 2))

    counted, calls = _jax_counted(jloss)
    jobj = jsolver.Objective(
        value_and_grad=lambda p, k: jax.value_and_grad(jloss)(p),
        value=lambda p, k: counted(p))
    vag = tsolver.value_and_grad(tloss)
    tobj = tsolver.Objective(value_and_grad=lambda p, d: vag(p),
                             value=lambda p, d: tloss(p))
    return jobj, tobj, calls


def _params0():
    rng = np.random.default_rng(0)
    return {"W": (rng.standard_normal((4, 3)) * 0.1).astype(np.float32),
            "b": np.zeros(3, np.float32)}


SOLVER_CASES = {
    # name: (optimizer class name, conf kwargs, EpsTermination eps,
    #        objective scale)
    "gd": ("GradientDescentOptimizer",
           {"lr": 0.5, "momentum": 0.5, "num_iterations": 120}, 1e-4, 1.0),
    "gd_adagrad_schedule": ("GradientDescentOptimizer",
                            {"lr": 0.5, "momentum": 0.5, "use_adagrad": True,
                             "momentum_after": {5: 0.9},
                             "num_iterations": 120}, 1e-4, 1.0),
    "linesearch": ("LineSearchGradientDescent",
                   {"lr": 8.0, "num_iterations": 80}, 1e-5, 1.0),
    "cg": ("ConjugateGradientOptimizer",
           {"lr": 20.0, "num_iterations": 80}, 1e-5, 1.0),
    "lbfgs": ("LBFGSOptimizer", {"num_iterations": 80}, 1e-5, 30.0),
}


class _Trials:
    """A listener that books the value evaluations of each iteration
    (JAX's, from its counter)."""

    def __init__(self, calls):
        self.calls, self.seen, self.trials = calls, 0, []

    def iteration_done(self, model, iteration, score):
        self.trials.append(len(self.calls) - self.seen)
        self.seen = len(self.calls)


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solver_matches_reference(case):
    cls, kw, eps, scale = SOLVER_CASES[case]
    kw = dict({"use_adagrad": False}, **kw)
    jobj, tobj, calls = _objectives(scale)
    jopt = getattr(jsolver, cls)(jconf.NeuralNetConfiguration(**kw), jobj,
                                 terminations=[jterm.EpsTermination(eps)],
                                 listeners=[_Trials(calls)])
    topt = getattr(tsolver, cls)(tconf.NeuralNetConfiguration(**kw), tobj,
                                 terminations=[tterm.EpsTermination(eps)])
    p0 = _params0()
    jp = jopt.optimize({k: jnp.asarray(v) for k, v in p0.items()},
                       jax.random.key(0))
    tp = topt.optimize({k: torch.from_numpy(v) for k, v in p0.items()})
    js, ts = jopt.score_history, topt.score_history
    # the termination fired mid-run, at the same iteration
    assert len(ts) == len(js) < kw["num_iterations"]
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    if cls != "GradientDescentOptimizer":
        assert topt.trials_history == jopt.listeners[0].trials
        assert max(topt.trials_history) > 1       # the search backtracked


def test_solver_dispatch_matches_reference():
    for algo in tconf.OptimizationAlgorithm:
        jcls = jsolver.Solver._DISPATCH[jconf.OptimizationAlgorithm(
            algo.value)]
        assert tsolver.Solver._DISPATCH[algo].__name__ == jcls.__name__


# -- finetune through the Solver on a dense conf ------------------------------

def _dense_conf(pkg, algo, iters):
    C = pkg.NeuralNetConfiguration
    return (C.builder().n_in(4).lr(0.1).num_iterations(iters)
            .use_adagrad(False).activation("tanh").compute_dtype("float32")
            .optimization_algo(pkg.OptimizationAlgorithm(algo))
            .list(2).hidden_layer_sizes(8)
            .override(1, kind=pkg.LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(False).build())


@pytest.mark.parametrize("algo,iters", [
    ("gradient_descent", 40), ("iteration_gradient_descent", 10),
    ("conjugate_gradient", 40), ("lbfgs", 6)])
def test_finetune_matches_reference(algo, iters):
    x, y = _iris()
    jnet = JNet(_dense_conf(jconf, algo, iters)).init(seed=3)
    tnet = TNet(_dense_conf(tconf, algo, iters), device="cpu",
                params=params_from_numpy(
                    jax.tree.map(np.asarray, jnet.params), "cpu"))
    jl, tl = JCollect(), TCollect()
    jnet.set_listeners([jl])
    tnet.set_listeners([tl])
    jnet.finetune(JDataSet(jnp.asarray(x), jnp.asarray(y)))
    tnet.finetune(TDataSet(torch.from_numpy(x), torch.from_numpy(y)))
    js, ts = [s for _, s in jl.scores], [s for _, s in tl.scores]
    assert len(ts) == len(js) == iters
    assert ts[-1] < ts[0]
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    for tp, jp in zip(tnet.params, jnet.params):
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=PARAM_ATOL)


# -- the guard ---------------------------------------------------------------

@pytest.mark.parametrize("algo", ["gradient_descent", "conjugate_gradient",
                                  "lbfgs"])
def test_nan_objective_keeps_the_iterate_and_counts_the_skip(algo):
    x, y = _iris()
    x = x.copy()
    x[3, 1] = np.nan
    jnet = JNet(_dense_conf(jconf, algo, 5)).init(seed=3)
    tnet = TNet(_dense_conf(tconf, algo, 5), device="cpu",
                params=params_from_numpy(
                    jax.tree.map(np.asarray, jnet.params), "cpu"))
    before = tnet.params[-1]["W"].clone()
    jresilience.reset()
    jnet.finetune(JDataSet(jnp.asarray(x), jnp.asarray(y)))
    tnet.finetune(TDataSet(torch.from_numpy(x), torch.from_numpy(y)))
    # InvalidScore stops the run after the first (skipped) iteration
    assert resilience_metrics.snapshot()["steps_skipped"] == \
        jresilience.snapshot()["steps_skipped"] == 1
    assert torch.equal(tnet.params[-1]["W"], before)
    np.testing.assert_array_equal(tnet.params[-1]["W"].numpy(),
                                  np.asarray(jnet.params[-1]["W"]))


# -- captures ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["gd", "linesearch", "cg", "lbfgs"])
def test_no_capture_after_warm_up(case, graphs_on_cpu):  # noqa: F811
    """Every iteration after the first replays the captured functions
    (the iteration and the step size are device tensors), and the
    replays give the eager run's scores and params exactly."""
    cls, kw, _, scale = SOLVER_CASES[case]
    kw = dict({"use_adagrad": False}, **dict(kw, num_iterations=12))
    runs = []
    for captured in (True, False):
        compile_metrics.reset()
        _, tobj, _ = _objectives(scale)
        opt = getattr(tsolver, cls)(tconf.NeuralNetConfiguration(**kw),
                                    tobj, terminations=[])
        if not captured:
            compile_cache._graphs_on = lambda dev: False
        p = opt.optimize({k: torch.from_numpy(v)
                          for k, v in _params0().items()})
        runs.append((opt.score_history, p, dict(compile_metrics.traces)))
    (cs, cp, traces), (es, ep, _) = runs
    label = {"gd": "solver.gd_step", "linesearch": "solver.linesearch_step",
             "cg": "solver.cg_step", "lbfgs": "solver.lbfgs_step"}[case]
    # one capture a function: the step, or start, trial and finish
    assert traces == {label: 1 if case == "gd" else 3}
    assert len(cs) == 12 and cs == es
    for k in cp:
        assert torch.equal(cp[k], ep[k])


# -- no JAX ------------------------------------------------------------------

def test_solver_modules_import_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.optimize\n"
            "import deeplearning4j_tpu_torch.optimize.solver\n"
            "import deeplearning4j_tpu_torch.optimize.line_search\n"
            "import deeplearning4j_tpu_torch.optimize.terminations\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
