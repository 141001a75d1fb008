"""The PyTorch port stands alone: it loads no jax, flax or vispeech_tpu
module, and its sources name none."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vispeech_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vispeech_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_nothing_of_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(vispeech_tpu|jax|jaxlib|flax)(\.|\s|$)",
                         re.MULTILINE)
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in PORT_FILES for m in pattern.finditer(p.read_text())]
    assert not offenders, offenders
    assert len(PORT_FILES) > 20
    for name in ("mesh.py", "sharding.py", "tensor.py"):
        assert PORT / "parallel" / name in PORT_FILES, name
    assert "vispeech_tpu_torch.parallel.sharding" in _port_modules()
    assert "vispeech_tpu_torch.parallel.tensor" in _port_modules()
