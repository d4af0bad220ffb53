"""Device and import rules of the port.

Entry points default to the card and raise without one — nothing quietly
runs on the CPU.  The port imports neither jax nor the reference package.
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import quickstart
from repro_torch.common.types import resolve_device
from repro_torch.configs import internvl2_2b, jamba_v0_1_52b, rwkv6_7b
from repro_torch.convert import params_from_jax
from repro_torch.kernels import packed_flash_attention as pfa
from repro_torch.models import mllm, model
from repro_torch.train import step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


@pytest.mark.parametrize("entry", ["mllm.init", "model.init", "as_tensors",
                                   "resolve_device", "model.init[rwkv6-7b]",
                                   "model.init[jamba]", "params_from_jax",
                                   "quickstart"])
def test_default_device_without_card_raises(entry):
    _no_card()
    tiny = internvl2_2b.CFG
    jamba = dataclasses.replace(jamba_v0_1_52b.CFG, ffn_pattern=("dense",))
    call = {
        "mllm.init": lambda: mllm.init(tiny),
        "model.init": lambda: model.init(internvl2_2b.ENCODER),
        "as_tensors": lambda: step.as_tensors({"x": [[1.0]]}),
        "resolve_device": lambda: resolve_device("cuda"),
        "model.init[rwkv6-7b]": lambda: model.init(rwkv6_7b.CFG),
        "model.init[jamba]": lambda: model.init(jamba),
        "params_from_jax": lambda: params_from_jax({"blocks": {}}, rwkv6_7b.CFG),
        "quickstart": lambda: quickstart.main([]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_kernel_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pfa.flash_fwd(q, q[:, :, 0], q[:, :, 0],
                      torch.zeros(1, 4, dtype=torch.int32, device="meta"),
                      torch.zeros(1, 4, dtype=torch.int32, device="meta"),
                      True, 0, 4, 4)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_chip_smoke_imports_neither_jax_nor_reference():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            mod = words[1].rstrip(",")
            assert mod != "jax" and not mod.startswith("jax.")
            assert mod != "repro" and not mod.startswith("repro.")


def test_chip_smoke_fails_without_card():
    _no_card()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("module", ["repro_torch.kernels.blocking"])
def test_port_doctests(module):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(module))
    assert res.attempted > 0 and res.failed == 0


def test_kernel_build_name_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a shared ``csrc/*.cuh`` header renames (so rebuilds) every
    library that includes it; an unchanged tree keeps its names."""
    from repro_torch.kernels import build
    for name in ("mamba_scan", "rwkv6_scan"):
        (tmp_path / f"{name}.cu").write_text(f'#include "scan_common.cuh"\n// {name}\n')
    header = tmp_path / "scan_common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._target(n)[0] for n in ("mamba_scan", "rwkv6_scan")}
    assert before == {n: build._target(n)[0] for n in before}
    header.write_text("// v2\n")
    after = {n: build._target(n)[0] for n in before}
    assert all(before[n] != after[n] for n in before)
