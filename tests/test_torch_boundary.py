"""The PyTorch port stands alone: it imports nothing of the JAX package
(``nellie_tpu``), nothing of JAX and neither pandas nor pyarrow, neither in
its source nor at run time.

Only the tests import both.  The source check parses every ``.py`` of
``nellie_tpu_torch/`` and ``chip_smoke.py``; the run-time check imports
every module of the port and ``chip_smoke`` in a fresh interpreter and
lists what landed in ``sys.modules`` (the napari plugin's modules with the
Qt/napari stand-ins of ``tests/qt_stubs.py`` where Qt is absent).
"""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nellie_tpu_torch")
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, files in os.walk(PORT) for f in files if f.endswith(".py")]
    + ["chip_smoke.py"])


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("nellie_tpu", "jax", "pandas", "pyarrow")


def _imports(tree):
    """(line, module name) of every absolute import, ``importlib.import_module``
    and ``__import__`` with a constant name in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def test_forbidden_names():
    assert _forbidden("nellie_tpu") and _forbidden("nellie_tpu.io.tiff")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("pandas") and _forbidden("pyarrow.csv")
    assert not _forbidden("nellie_tpu_torch") and not _forbidden("nellie_tpu_torch.io")
    assert not _forbidden("jaxlib_free") and not _forbidden("torch")


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_jax_or_the_jax_package(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = [f"{rel}:{line} imports {name}" for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, "\n".join(bad)


_IMPORT_ALL = r"""
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests")
import qt_stubs
qt_stubs.install()
import nellie_tpu_torch
names = ["nellie_tpu_torch"]
for info in pkgutil.walk_packages(nellie_tpu_torch.__path__, "nellie_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_importing_the_whole_port_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, ROOT], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {os.path.splitext(p)[0].replace(os.sep, ".").removesuffix(".__init__")
                for p in SOURCES if p.startswith("nellie_tpu_torch")}
    assert expected <= set(out["imported"])
    assert [m for m in out["modules"] if _forbidden(m)] == []
