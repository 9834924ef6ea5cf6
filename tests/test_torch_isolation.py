"""The port stands alone: no module of surge_tpu_torch (nor chip_smoke.py)
imports JAX or the surge_tpu package, the package imports with JAX blocked, and
nothing falls back to the CPU when the card is missing."""

import ast
import ctypes
import gc
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "surge_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.fixture(scope="module", autouse=True)
def leave_the_worker_as_found():
    """Every port test module (each imports this fixture) leaves its pytest
    worker fit for the JAX package's tests that share it: torch on one
    intra-op thread, as other workers run beside it, and at the module's
    end the reference programs it compiled dropped, its memory returned and
    the process's peak resident set reset. A child process reports its
    parent's peak resident set as its own (``getrusage`` after ``vfork``
    and ``exec``), so a worker left at the peak the port's tests reached
    inflates every child's reading there; ``tests/test_restore_bounded.py``
    compares two children's peaks."""
    import jax

    torch.set_num_threads(1)
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL(None).malloc_trim(0)
    except (OSError, AttributeError):
        pass
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "surge_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_reference(path):
    bad = sorted(n for n in _imports(path) if _forbidden(n))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'surge_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_engine_without_a_card_raises(monkeypatch):
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay.engine import ReplayEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplayEngine(counter.make_replay_spec())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplayEngine(counter.make_replay_spec(), device="cuda")
    assert ReplayEngine(counter.make_replay_spec(), device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
