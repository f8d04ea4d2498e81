"""No run may load JAX or the JAX package: the whole-name check, and the
harness and the reference imported in a fresh process."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))


def test_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuseg_torch_probe", object())
    assert "tpuseg" not in harness.forbidden_modules() or "tpuseg" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.xla_probe", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_harness_and_reference_load_no_jax():
    code = ("import sys\n"
            "import benchmark.run, benchmark.calibrate, benchmark.counts, benchmark.trace\n"
            "import benchmark.reference.models, benchmark.reference.steps, "
            "benchmark.reference.lowp\n"
            "from benchmark import harness\n"
            "for kind in ('drivers', 'metrics'):\n"
            "    import glob, os\n"
            "    for p in sorted(glob.glob(os.path.join(harness.PACKAGE, kind, '*.py'))):\n"
            "        harness.load_module(p)\n"
            "print(','.join(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.PACKAGE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("tpuseg_torch",) + harness.FORBIDDEN, (path, name)
