"""Build and load the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``); one ``nvcc`` runs for each
source, all started together. A library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. Nothing here
runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

from repro_torch.obs import clock

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points of each library: name -> (restype, argtypes)
SIGNATURES = {
    "paged_attention": {
        "paged_attention_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _F, _I, _P]),
        "tree_attention_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _I, _P]),
    },
    "flash_attention": {
        "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _F, _I, _I, _P]),
    },
    "int8_matmul": {
        "int8_matmul_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P]),
    },
    "ssd_scan": {
        "ssd_scan_fwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                              _L, _L, _L, _L, _P]),
    },
    "spec_verify": {
        "row_argmax_chunks": (_I, [_I]),
        "row_argmax": (_I, [_P, _P, _P, _P, _I, _I, _P]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, dict] = {}      # name -> {"seconds", "ptxas", "path"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str, nvcc: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel library that is missing, in parallel; returns
    name -> library path. Raises with the compiler's output on failure."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _target(name, nvcc) for name in SIGNATURES}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, clock.perf())
    errors = []
    for name, (proc, tmp, t0) in jobs.items():
        output, _ = proc.communicate()
        build_log[name] = {"seconds": clock.perf() - t0,
                           "ptxas": output, "path": str(paths[name])}
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{output}")
            continue
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every library on first use)."""
    if name not in _loaded:
        paths = build_all()
        for lib_name, path in paths.items():
            if lib_name in _loaded:
                continue
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in SIGNATURES[lib_name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _loaded[lib_name] = lib
    return _loaded[name]


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
