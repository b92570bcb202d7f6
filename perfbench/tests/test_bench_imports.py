"""No module of the benchmark loads the JAX stack or the JAX package:
an AST scan compares each import's top-level name whole (``repro_torch``
is not ``repro``), and a subprocess with them blocked imports every
module."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench import harness

BENCH = Path(harness.BENCH)
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_names_the_jax_package():
    assert MODULES
    for p in MODULES:
        bad = set(top_names(p)) & set(harness.FORBIDDEN)
        assert not bad, f"{p} imports {bad}"


def test_whole_name_comparison():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.x"]) == []
    assert harness.forbidden_modules(["repro.x", "jaxlib"]) == ["jaxlib",
                                                                 "repro"]


BLOCKED = r"""
import importlib, importlib.abc, runpy, sys
from pathlib import Path
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
from perfbench import harness
harness.set_environment()
for p in sorted((root / "perfbench").rglob("*.py")):
    if "tests" in p.parts:
        continue
    rel = p.relative_to(root).with_suffix("")
    if p.parent.name == "metrics":
        harness.reader(p.stem)
    else:
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
from repro_torch.serving import engine  # noqa: the system under test
bad = harness.forbidden_modules()
assert not bad, bad
print("imported", len(sys.modules))
"""


def test_every_module_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED, str(harness.ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout
