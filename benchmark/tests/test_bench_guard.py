"""What ``benchmark/run.py`` reaches imports neither JAX nor the JAX
package, and the reference imports nothing of the port.

Walks the imports of ``run.py``, of every module of ``benchmark`` and of
``kbe_torch`` that it reaches, and of every metric file (the harness loads
them by path), comparing each imported module's top-level name whole."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "kbe_tpu"}


def _imports(path: Path):
    """Every absolute module name that ``path`` imports (any depth)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _file_of(module: str):
    """The repository's file of ``module``, if it is one of ours."""
    base = ROOT.joinpath(*module.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _reached():
    start = [BENCH / "run.py"] + sorted((BENCH / "metrics").glob("*.py"))
    seen, todo, names = set(), list(start), {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        names[path] = set(_imports(path))
        for name in names[path]:
            parts = name.split(".")
            for k in range(1, len(parts) + 1):
                f = _file_of(".".join(parts[:k]))
                if f is not None and f not in seen:
                    todo.append(f)
    return names


def test_nothing_run_reaches_imports_jax_or_the_jax_package():
    reached = _reached()
    assert BENCH / "harness.py" in reached
    assert any("kbe_torch" in str(p) for p in reached)
    bad = {str(p.relative_to(ROOT)): sorted(n for n in names
                                             if n.split(".")[0] in FORBIDDEN)
           for p, names in reached.items()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "kbe_torch" not in tops, path
        assert not tops & FORBIDDEN, path


def test_top_level_names_are_compared_whole():
    # kbe_torch begins with the JAX package's name, and is no match for it
    assert "kbe_torch".split(".")[0] not in FORBIDDEN
    assert "kbe_tpu.ops".split(".")[0] in FORBIDDEN
