"""Package hygiene of the port: ``src/repro_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor the JAX package ``repro``; the entry points run
on the GPU unless asked for the CPU, and raise on a box with no CUDA
instead of dropping silently to the CPU; the CLI serves on the CPU when
asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_avoids_the_ci_guarded_names():
    """The CI grep guards over src/ forbid a second draft loop named
    dstep/draft_chain/tree_draft/dstep_tree and a stray ``Mesh(``."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for name in ("def dstep", "def draft_chain", "def tree_draft",
                     "def dstep_tree", "Mesh("):
            assert name not in text, f"{path}: {name}"


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible, so the default device exists")


def test_server_and_model_raise_without_a_device():
    _need_no_cuda()
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    from repro_torch.serving import PagedSpecServer
    m = build_model(registry.smoke_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(0)
    params = m.init(0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedSpecServer(m, m, params, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_paged_cache(2, 8, 4, 4)


def test_cli_raises_without_a_device():
    _need_no_cuda()
    from repro_torch.launch import serve_paged
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_paged.main(["--arch", "llama3.2-1b", "--smoke", "--requests", "1"])


def test_cli_serves_on_the_cpu_when_asked():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_paged", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--requests", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "paged-served 4 ragged requests" in proc.stdout
