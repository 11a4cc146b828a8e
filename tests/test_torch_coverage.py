"""Every module, public name and example of the JAX package has a
counterpart in the port.

Walks ``deeplearning4j_tpu/**/*.py`` and asserts that each file has a
port file at the same relative path under ``deeplearning4j_tpu_torch/``.
The only exceptions are named here: ``compat.py`` (a ``shard_map``
import shim between JAX versions, with nothing to port), and the three
Pallas kernel files, whose Hopper twins live under other names.

Then, module by module, every public top-level name of the reference
(a function, class or assignment; for a package's ``__init__.py`` also
what it re-exports from the package) and every public method of a
public class must exist in the port's module, or stand in
:data:`NAME_EXCEPTIONS` with the reason it is not carried.  Each
``examples/*.py`` has its module under ``deeplearning4j_tpu_torch/
examples/``.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "deeplearning4j_tpu"
PORT = REPO / "deeplearning4j_tpu_torch"

#: reference file -> the port file that takes its place (None: not ported)
EXCEPTIONS = {
    "compat.py": None,
    "ops/pallas_attention.py": "ops/flash_attention.py",
    "ops/pallas_word2vec.py": "ops/fused_word2vec.py",
    "ops/pallas_glove.py": "ops/fused_glove.py",
}


def reference_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_every_reference_module_has_a_port_file():
    missing = [m for m in reference_modules()
               if m not in EXCEPTIONS and not (PORT / m).is_file()]
    assert not missing, f"reference modules with no port file: {missing}"


@pytest.mark.parametrize("ref,twin", sorted(
    (k, v) for k, v in EXCEPTIONS.items() if v is not None))
def test_pallas_files_have_their_twins(ref, twin):
    assert (REF / ref).is_file()
    assert not (PORT / ref).exists()
    assert (PORT / twin).is_file()


def test_exceptions_are_current():
    """An exception names a reference file that exists, and ``compat.py``
    stays the one module the port does not carry."""
    modules = set(reference_modules())
    assert set(EXCEPTIONS) <= modules
    assert [k for k, v in EXCEPTIONS.items() if v is None] == ["compat.py"]
    assert not (PORT / "compat.py").exists()


def test_bundled_data_is_copied():
    for f in (REF / "nlp" / "data").iterdir():
        if f.is_file():
            assert (PORT / "nlp" / "data" / f.name).read_bytes() == \
                f.read_bytes()


# -- public names ------------------------------------------------------------

#: names the port does not carry under the reference's name, each with
#: its reason: ``(module, name)``, or ``(None, name)`` for every module
NAME_EXCEPTIONS = {
    (None, "Array"): "jax.Array alias; the port's modules use torch.Tensor",
    (None, "PyTree"): "JAX pytree alias; the port's trees are nested dicts",
    ("datasets/dataset.py", "DataSet.tree_flatten"):
        "JAX pytree registration; a port DataSet is not a pytree",
    ("datasets/dataset.py", "DataSet.tree_unflatten"):
        "JAX pytree registration; a port DataSet is not a pytree",
    ("eval/evaluation.py", "EVAL_MAX_BUCKET"):
        "caps the bucket of the jitted counting; the port's "
        "MultiLayerNetwork.evaluate counts on the host with no cap",
    ("models/bert.py", "batch_spec"):
        "a PartitionSpec for GSPMD; ranks cut their own rows "
        "(bert._local_rows)",
    ("models/transformer.py", "act_spec"):
        "a PartitionSpec for GSPMD; a rank holds its own activations",
    ("nlp/word2vec.py", "log"):
        "the reference module's logger; the port's module logs nothing",
    ("nn/multilayer.py", "log"):
        "the reference module's logger; the port's module logs nothing",
    ("ops/graph.py", "GraphBuilder.jaxpr"):
        "a jaxpr is JAX's; the port's is GraphBuilder.fx_graph",
    ("ops/graph.py", "GraphBuilder.hlo"):
        "HLO is XLA's; the port's is GraphBuilder.exported_graph",
    ("ops/kernel_select.py", "kernel_name"):
        "names a Pallas block/interpret verdict; the port records "
        "resolve_kernel's name as kernel_used",
    ("ops/pallas_attention.py", "DEFAULT_BLOCK_Q"):
        "Pallas block size; B1-B3 have fixed tiles",
    ("ops/pallas_attention.py", "DEFAULT_BLOCK_K"):
        "Pallas block size; B1-B3 have fixed tiles",
    ("ops/pallas_attention.py", "FLASH_MIN_SEQ"):
        "the TPU's crossover; attention_auto takes the card's measured one",
    ("ops/pallas_word2vec.py", "VMEM_BUDGET_BYTES"):
        "TPU VMEM budget; B4 gathers rows from HBM",
    ("ops/pallas_word2vec.py", "choose_block"):
        "sizes the VMEM-resident block; B4 takes tables of any size",
    ("ops/pallas_word2vec.py", "probe_compile"):
        "a Mosaic compile probe; B4 is built by nvcc",
    ("ops/pallas_glove.py", "VMEM_BUDGET_BYTES"):
        "TPU VMEM budget; B5 gathers rows from HBM",
    ("ops/pallas_glove.py", "choose_block"):
        "sizes the VMEM-resident block; B5 takes tables of any size",
    ("ops/pallas_glove.py", "probe_compile"):
        "a Mosaic compile probe; B5 is built by nvcc",
    ("ops/random.py", "KeyStream"):
        "splits JAX keys; the port draws from torch.Generator",
    ("parallel/mesh.py", "data_sharding"):
        "a NamedSharding; ranks take their rows with mesh.shard_rows",
    ("parallel/mesh.py", "replicated"):
        "a NamedSharding; a replicated leaf is a whole tensor on each rank",
    ("parallel/multihost.py", "DistributedKV"):
        "the jax.distributed key-value store; the port's is StoreKV over "
        "the process group's store",
    ("parallel/pipeline.py", "stage_param_sharding"):
        "a NamedSharding tree; transformer.shard_tree lays out the stages",
    ("parallel/sharded_fit.py", "named_shardings"):
        "NamedShardings for GSPMD; transformer.shard_tree lays out a tree",
    ("parallel/sharded_fit.py", "stacked_sharding"):
        "a NamedSharding for a scanned batch; ranks take their rows",
    ("runtime/__init__.py", "PERSISTENT_CACHE_DIR"):
        "XLA's persistent compilation cache",
    ("runtime/__init__.py", "PERSISTENT_CACHE_ENV"):
        "XLA's persistent compilation cache",
    ("runtime/__init__.py", "PERSISTENT_CACHE_MIN_S_ENV"):
        "XLA's persistent compilation cache",
    ("runtime/__init__.py", "resolve_cache_dir"):
        "XLA's persistent compilation cache",
    ("runtime/__init__.py", "setup_persistent_compilation_cache"):
        "XLA's persistent compilation cache",
    ("runtime/autotune.py", "DEFAULT_BLOCK_CANDIDATES"):
        "Pallas block candidates; B1-B3 have fixed tiles",
    ("runtime/compile_cache.py", "cached_jit"):
        "jax.jit through the engine; the port's is cached_graph (CUDA "
        "graphs)",
    ("runtime/metrics.py", "TPU_PEAK_FLOPS"):
        "TPU peak rates; no TPU number describes the card",
}


def _public_names(rel):
    """The reference module's public top-level names and its public
    classes' public methods (``Class.method``)."""
    tree = ast.parse((REF / rel).read_text())
    names = set()

    def top(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, ast.ClassDef):
                names.add(node.name)
                if not node.name.startswith("_"):
                    names.update(
                        f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_"))
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)):
                names.add(node.target.id)
            elif (rel.endswith("__init__.py")
                  and isinstance(node, ast.ImportFrom)
                  and (node.module or "").startswith("deeplearning4j_tpu")):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                top(node.body)

    top(tree.body)
    return sorted(n for n in names
                  if not n.split(".")[-1].startswith("_") and n != "*")


def _port_module(rel):
    twin = EXCEPTIONS.get(rel, rel)
    mod = twin[:-len(".py")].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[:-len(".__init__")]
    name = "deeplearning4j_tpu_torch" + ("." + mod if mod != "__init__"
                                         else "")
    return importlib.import_module(name)


def _excepted(rel, name):
    """An excepted name, or a method of an excepted class."""
    head = name.split(".")[0]
    return any(key in NAME_EXCEPTIONS
               for key in ((rel, name), (rel, head), (None, head)))


_MISSING = object()


def _lookup(mod, name):
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part, _MISSING)
        if obj is _MISSING:
            break
    return obj


@pytest.mark.parametrize("rel", [m for m in reference_modules()
                                 if EXCEPTIONS.get(m, m) is not None])
def test_every_public_name_has_its_port(rel):
    mod = _port_module(rel)
    missing = [name for name in _public_names(rel)
               if not _excepted(rel, name)
               and _lookup(mod, name) is _MISSING]
    assert not missing, (f"{rel}: reference names with no port "
                         f"counterpart and no entry in NAME_EXCEPTIONS: "
                         f"{missing}")


def test_name_exceptions_are_current():
    """Each exception names a reference name that exists and that the
    port really lacks, with a reason."""
    modules = set(reference_modules())
    for (rel, name), reason in NAME_EXCEPTIONS.items():
        assert reason.strip()
        if rel is None:
            continue
        assert rel in modules, rel
        assert name in _public_names(rel), (rel, name)
        assert _lookup(_port_module(rel), name) is _MISSING, \
            f"{rel}: {name} is ported; drop its exception"


EXAMPLES = sorted(p.stem for p in (REPO / "examples").glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_every_example_has_its_port(name):
    path = PORT / "examples" / f"{name}.py"
    assert path.is_file(), f"examples/{name}.py has no port"
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")
    assert callable(mod.main)
