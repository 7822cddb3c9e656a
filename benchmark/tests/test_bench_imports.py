"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port either.  Top-level names are
compared whole: the port's ``3deecelltracker_tpu_torch`` and
``t3dct_torch`` begin with the JAX package's names and are allowed in the
harness."""

import ast

from benchmark.harness.driver import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "3deecelltracker_tpu", "t3dct"}
PORT = {"3deecelltracker_tpu_torch", "t3dct_torch"}


def _imports(path):
    """Top-level names of every import in a file, ``import_module`` of a
    string included."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module":
            out.add(node.args[0].value.split(".")[0])
    return out


def test_no_jax_anywhere():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH_DIR / "reference").rglob("*.py")):
        names = _imports(f)
        assert not names & (FORBIDDEN | PORT), f
        assert "benchmark" not in names or f.name == "__init__.py", f


def test_whole_name_rule():
    assert "3deecelltracker_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "t3dct_torch.engine".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN
