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


def test_frontend_is_seeded_and_clock_injected():
    """CI's front-end determinism rule (``.github/workflows/ci.yml``, over
    ``src/repro/serving/frontend``) held on the port's copy: seeded numpy
    Generators only, and time only through the injectable obs clock."""
    import re
    rule = re.compile(r"import time|from time import|"
                      r"np\.random\.(seed|random)\(|default_rng\(\)")
    files = sorted((ROOT / "src" / "repro_torch" / "serving" / "frontend")
                   .rglob("*.py"))
    assert len(files) == 3
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not rule.search(line), f"{path.name}:{n}: {line}"


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


@pytest.mark.parametrize("cli", ["serve_paged", "serve_async", "continuous"])
def test_cli_raises_without_a_device(cli):
    _need_no_cuda()
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--arch", "llama3.2-1b", "--smoke", "--requests", "1"])


def test_frontend_and_continuous_server_raise_without_a_device():
    _need_no_cuda()
    from repro_torch.api import DeploymentSpec, Planner, Session
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    m = build_model(registry.smoke_config("llama3.2-1b"))
    params = m.init(0, "cpu")
    for kw in (dict(prompt_lens=(6,), max_new=6),
               dict(prompt_lens=(5, 9), max_new=(4, 6))):
        plan = Planner(DeploymentSpec(batch_size=2, streaming=True,
                                      cost_coefficient=0.2, **kw)).plan()
        with pytest.raises(RuntimeError, match="CUDA"):
            Session(m, m, params, params, plan)


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
