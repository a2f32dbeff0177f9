"""The import rules: nothing under perfbench/ imports JAX or the JAX
package, compared by whole top-level name, and the reference imports
nothing of dsen2_tpu_torch."""

import ast
import os
import sys

from perfbench import harness

HERE = os.path.join(harness.ROOT, "perfbench")


def imported_tops(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def py_files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_perfbench():
    for path in py_files(HERE):
        assert not imported_tops(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in py_files(os.path.join(HERE, "reference")):
        tops = imported_tops(path)
        assert "dsen2_tpu_torch" not in tops and not tops & set(harness.FORBIDDEN), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dsen2_tpu_torch_fake", object())
    assert "dsen2_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dsen2_tpu.core", object())
    assert "dsen2_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in harness.forbidden_modules()
