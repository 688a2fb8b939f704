"""The port's no-cache serving CLI (``repro_torch.launch.serve``): it serves
AR and speculatively on the CPU when asked to, its gamma decision is the
port's planner's, which is the JAX planner's (Eq. (1) over 0..8 with the
planner's prior c), gamma* = 0 serves AR, speculative and AR serving give
the same tokens, with or without the cache."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import DeploymentSpec as JaxSpec  # noqa: E402
from repro.api import Planner as JaxPlanner  # noqa: E402
from repro_torch.api import DeploymentSpec, Planner  # noqa: E402
from repro_torch.launch import cli_args, serve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu"]


@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.6, 0.8, 0.95])
@pytest.mark.parametrize("c", [None, 0.05, 0.25, 0.5, 0.9])
def test_gamma_decision_is_the_planners(alpha, c):
    """The grid holds both sides of the decision: gamma* = 0 (alpha 0.1,
    c 0.5) and gamma* > 0 (alpha 0.8, the prior c). The CLI's plan takes
    the port's planner's gamma, and that plan is JAX's, string for
    string."""
    got = Planner(DeploymentSpec(alpha=alpha, cost_coefficient=c)).plan()
    want = JaxPlanner(JaxSpec(alpha=alpha, cost_coefficient=c)).plan()
    assert got.gamma.gamma == want.gamma.gamma
    assert got.to_json() == want.to_json()
    assert serve.serve_plan(1, 8, 32, alpha=alpha,
                            cost_coefficient=c).gamma.gamma == want.gamma.gamma


def test_cli_serves_speculatively_on_the_cpu():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SMOKE,
         "--speculative", "--requests", "4", "--batch", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "speculative served 4 requests, 96 tokens" in proc.stdout
    assert "gamma=3" in proc.stdout and "cache=False" in proc.stdout


def test_cli_ar_and_speculative_serve_the_same_tokens(capsys):
    argv = [*SMOKE, "--requests", "3", "--max-new", "9", "--prompt-len", "5"]
    ar, s_ar = serve.main(argv)
    spec, s_spec = serve.main(argv + ["--speculative", "--batch", "2",
                                      "--gamma", "4"])
    out = capsys.readouterr().out
    assert "AR served 3 x 9 tokens" in out
    assert "speculative served 3 requests, 27 tokens" in out
    assert s_ar["gamma"] == 0 and s_ar["waves"] == 1
    assert s_spec["gamma"] == 4 and s_spec["waves"] == 2
    assert ar.shape == spec.shape == (3, 14)
    # one prompt draw per request, so the two modes see different prompts:
    # serve the speculative prompts again with AR rounds
    mt, md, pt, pd, _ = cli_args.build_pair("llama3.2-1b", True, "cpu")
    again, s = serve.serve(mt, md, pt, pd, spec[:, :5], 9, gamma=0, batch=2)
    np.testing.assert_array_equal(again, spec)
    assert s["rounds"] == 2 * 9 and s["alpha_hat"] is None


def test_gamma_zero_serves_ar(capsys):
    serve.main([*SMOKE, "--speculative", "--requests", "2", "--max-new", "4",
                "--alpha", "0.1", "--cost-coefficient", "0.5"])
    out = capsys.readouterr().out
    assert "gamma=0" in out and "alpha_hat=nan" in out


def test_use_cache_raises():
    """``--use-cache`` serves on the cached engine (it raised until the ring
    cache was ported): the same tokens as the no-cache serve, spec and AR."""
    argv = [*SMOKE, "--requests", "3", "--max-new", "9", "--prompt-len", "5"]
    spec, s = serve.main(argv + ["--speculative", "--batch", "2", "--gamma",
                                 "4", "--use-cache"])
    nocache, _ = serve.main(argv + ["--speculative", "--batch", "2",
                                    "--gamma", "4"])
    ar, _ = serve.main(argv + ["--use-cache"])
    np.testing.assert_array_equal(spec, nocache)
    np.testing.assert_array_equal(ar, nocache)
    assert s["waves"] == 2 and s["rounds"] > 0


def test_cli_raises_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible, so the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--requests", "1"])
