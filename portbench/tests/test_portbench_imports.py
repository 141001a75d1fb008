"""The import rule: the reference imports torch alone; no file of the
benchmark imports the JAX stack; a whole run loads none of it."""

import ast
import subprocess
import sys

import pytest
from conftest import BENCH, HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vispeech_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((BENCH / "references").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_torch(path):
    assert set(_imports(path)) <= {"__future__", "contextlib", "math", "typing", "torch"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_benchmark_file_imports_the_jax_stack(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_a_whole_run_loads_none_of_the_jax_stack():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}, {str(HERE)!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "import run\n"
        "from conftest import BULK, loaded_cell\n"
        "cfg = json.load(open(" + repr(str(HERE / "tiny.json")) + "))\n"
        "res = run.run_cell(loaded_cell(cfg, BULK), 5, 0.3, False, 'cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert res['correct'] and not bad and not res['extra']['forbidden'], bad\n"
        "assert 'vispeech_tpu_torch' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_the_forbidden_check_compares_whole_names():
    import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    assert "vispeech_tpu_torch".split(".")[0] not in run.FORBIDDEN
