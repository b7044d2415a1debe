"""dynamo_tpu_torch stands alone: no JAX, nothing of dynamo_tpu, and on
its serving path none of the packages the card machine lacks.

Every module of the port (and chip_smoke.py) is imported in a fresh
python process with those packages blocked by a sys.meta_path finder; the
test process itself has already imported jax, so the check needs its own
interpreter. A source scan backs it up for imports inside functions.
"""

import ast
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import dynamo_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dynamo_tpu_torch"
#: jax and the JAX package, and packages the CPU test environment installs
#: that the GPU serving machine lacks: the port may import none of them
BLOCKED = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "xxhash", "msgpack",
           "transformers", "triton", "safetensors", "tokenizers", "jinja2", "gguf")


def _port_modules() -> list[str]:
    return ["dynamo_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, "dynamo_tpu_torch.")
    ]


def test_every_module_imports_with_jax_and_server_packages_blocked():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        BLOCKED = {BLOCKED!r}
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        for mod in {_port_modules()!r} + ["chip_smoke"]:
            importlib.import_module(mod)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("ok", len({_port_modules()!r}))
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_of_the_port_imports_jax_or_dynamo_tpu():
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "dynamo_tpu"}, path
        text = path.read_text()
        assert "import jax" not in text, path
        assert "dynamo_tpu." not in text.replace("dynamo_tpu_torch.", ""), path


def test_chip_smoke_imports_nothing_of_jax_or_dynamo_tpu():
    roots = _imported_roots(REPO / "chip_smoke.py")
    assert "dynamo_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "dynamo_tpu"}


def test_no_function_imports_a_blocked_package_lazily():
    """Imports inside functions escape the import check above: none of
    them may reach a blocked package either."""
    lazy = {}
    for path in sorted(PKG.rglob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                        else [node.module or ""]
                    for n in names:
                        if n.split(".")[0] in BLOCKED:
                            lazy.setdefault(path.relative_to(REPO).as_posix(), set()).add(n)
    assert lazy == {}
