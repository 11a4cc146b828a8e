"""Every module of the JAX package has a counterpart in the port.

Walks ``deeplearning4j_tpu/**/*.py`` and asserts that each file has a
port file at the same relative path under ``deeplearning4j_tpu_torch/``.
The only exceptions are named here: ``compat.py`` (a ``shard_map``
import shim between JAX versions, with nothing to port), and the three
Pallas kernel files, whose Hopper twins live under other names.
"""

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
