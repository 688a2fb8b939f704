"""Each kernel launch runs on its tensors' own device.

The wrappers launch through ctypes, which launches on whatever CUDA
device is current, so every launch goes through ``kernels.build.call``:
the tensors' device is made current for the call and its current stream
is the launch's last argument. Without a card the checks are made with
stand-ins for ``torch.cuda.device``/``current_stream`` and the loaded
library: the context is entered with the device the wrapper gives, the
paged launch gives its query's device, and no kernel module launches
any other way (read from their source)."""
import ast
import pathlib
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

KERNELS = pathlib.Path(build.__file__).parent
LAUNCHING = ("paged_attention.py", "spec_verify.py", "flash_attention.py",
             "int8_matmul.py", "ssd_scan.py")


@pytest.fixture
def current(monkeypatch):
    """Stand-ins for the CUDA device context and stream, recording what a
    launch enters."""
    seen = []

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=("stream", dev)))
    return seen


def test_call_launches_inside_its_devices_context(current):
    dev = torch.device("cuda", 1)

    def entry(*args):
        current.append(("launch", args))
        return 0
    assert build.call(entry, dev, 3, 4) == 0
    assert current == [("enter", dev), ("launch", (3, 4, ("stream", dev))),
                       ("exit", dev)]


def test_the_paged_launch_gives_its_querys_device(current, monkeypatch):
    """``paged_attention.launch`` (the paged and tree entries) hands
    ``build.call`` the query's device."""
    launched = []
    lib = SimpleNamespace(paged_attention_fwd=lambda *a: launched.append(a) or 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    q = torch.zeros((1, 1, 2, 64))
    pool = torch.zeros((4, 16, 1, 64))
    table = torch.zeros((1, 2), dtype=torch.int32)
    pa.launch("paged_attention_fwd", q, pool, pool, table, 3, None, None)
    assert current[0] == ("enter", q.device) and current[-1] == ("exit", q.device)
    assert len(launched) == 1 and launched[0][-1] == ("stream", q.device)


@pytest.mark.parametrize("name", LAUNCHING)
def test_every_launch_goes_through_call(name):
    """No C entry point is called directly (``lib.f(...)`` or
    ``getattr(lib, ...)(...)``) and no module reads a stream itself: each
    entry point is handed to ``build.call``."""
    tree = ast.parse((KERNELS / name).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    direct = [n for n in calls
              if (isinstance(n.func, ast.Attribute)
                  and isinstance(n.func.value, ast.Name)
                  and n.func.value.id == "lib")
              or (isinstance(n.func, ast.Call)
                  and getattr(n.func.func, "id", "") == "getattr")]
    assert direct == []
    through = [n for n in calls if isinstance(n.func, ast.Attribute)
               and n.func.attr == "call"
               and getattr(n.func.value, "id", "") == "build"]
    assert through
    assert "current_stream" not in (KERNELS / name).read_text()
