"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``kernels/csrc/`` compiles, on first use, into a shared
library with a plain C interface under ``<repo>/build/kernels/``.  The file
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time:
the CPU tests import every module, and this machine need have no ``nvcc``.

    >>> from repro_torch.kernels import build
    >>> lib = build.load("packed_flash_attention")      # doctest: +SKIP
    >>> libs = build.load_all(["mamba_scan", "rwkv6_scan"])  # doctest: +SKIP
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C signatures of each library's functions: name -> argtypes (restype int).
SIGNATURES = {
    "packed_flash_attention": {
        "pfa_fwd": [P] * 7 + [I] * 9 + [P],
        "pfa_bwd_dq": [P] * 9 + [I] * 9 + [P],
        "pfa_bwd_dkv": [P] * 10 + [I] * 9 + [P],
    },
    "mamba_scan": {
        "mamba_fwd": [P] * 9 + [I] * 5 + [P],
        "mamba_bwd": [P] * 15 + [I] * 5 + [P],
    },
    "rwkv6_scan": {
        "wkv6_fwd": [P] * 8 + [I] * 6 + [P],
        "wkv6_bwd": [P] * 13 + [I] * 6 + [P],
    },
}


class BuildLog:
    """What the builds of this process did: seconds, and the ``-Xptxas -v``
    lines and compiler warnings (e.g. a wgmma pipeline it serialized)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.ptxas: dict[str, list[str]] = {}


LOG = BuildLog()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _digest(src: Path, tail: list[str]) -> str:
    """Hash of ``src``, every shared header of ``csrc/`` and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(tail).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> tuple[Path, list[str]]:
    cmd_tail = ARCH_FLAGS + FLAGS
    return BUILD_DIR / f"lib{name}-{_digest(CSRC / f'{name}.cu', cmd_tail)}.so", cmd_tail


def _nvcc(src: Path, out: Path, tail: list[str]) -> list[str]:
    """Compile ``src`` into ``out``; its ptxas lines and warnings (raises on
    a failed build)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *tail, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    os.replace(tmp, out)
    return [ln for ln in proc.stdout.splitlines()
            if "registers" in ln or "smem" in ln or "spill" in ln
            or "Compiling entry" in ln or "arning" in ln]


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name in _LOADED:
        return _LOADED[name]
    out, tail = _target(name)
    if not out.exists():
        t0 = time.perf_counter()
        LOG.ptxas[name] = _nvcc(CSRC / f"{name}.cu", out, tail)
        LOG.seconds[name] = time.perf_counter() - t0
    _LOADED[name] = _bind(ctypes.CDLL(str(out)), name)
    return _LOADED[name]


def load_from(src, name: str, extra_flags=()) -> tuple[ctypes.CDLL, list[str]]:
    """Build another source of library ``name`` (e.g. a parent commit's
    ``csrc/<name>.cu``) with this module's flags and ``extra_flags``, and
    load it with ``name``'s signatures: (library, its ptxas lines).  An
    edited copy outside ``csrc/`` includes ``csrc/``'s shared headers.  The
    wrappers go on calling ``load(name)`` until ``use`` swaps it in."""
    tail = ARCH_FLAGS + FLAGS + ["-I", str(CSRC)] + list(extra_flags)
    out = BUILD_DIR / f"lib{name}-from-{_digest(Path(src), tail)}.so"
    lines = _nvcc(Path(src), out, tail)
    return _bind(ctypes.CDLL(str(out)), name), lines


def use(name: str, lib: ctypes.CDLL) -> None:
    """Make ``lib`` the library the wrappers of ``name`` launch (an A/B of two
    builds: ``load(name)`` and one from ``load_from``)."""
    _LOADED[name] = lib


def load_all(names) -> dict[str, ctypes.CDLL]:
    """``load`` each library, the builds running side by side (one ``nvcc``
    process per source); a failed build raises."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))


def route(t, what: str) -> str:
    """Every kernel wrapper's rule: ``"kernel"`` for a CUDA tensor,
    ``"plain"`` (the kernel's plain PyTorch version) for a CPU tensor; any
    other device raises."""
    if t.device.type == "cuda":
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def call(fn, *args) -> None:
    """Call a library function and raise on the ``cudaError_t`` it returns
    (a launch the card refuses never runs, and no later sync reports it)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {err}")
