"""The plain references against the port at tiny sizes on the CPU: the
packer against the scheduled loader's batches, the decoder's two steps
against the port's train step (fp32: tight; bf16: within the cell's limits)."""
import numpy as np
import pytest
import torch

import tiny
from portbench import core

DRV = core.load_module("drivers", "dflop_train")


def _run(cell, seed):
    prog = DRV.Program(cell, seed, "cpu")
    readings = prog.check_steps()
    draws, loaded = prog.stream.drawn, prog.loaded
    prog.close()
    bad, batches, first = DRV.data_check(cell, seed, draws, loaded)
    return readings, batches, loaded, bad, first


@pytest.mark.parametrize("workload", ["internlm2-1.8b.mixed", "internlm2-1.8b.single_image"])
def test_packer_reproduces_the_loader(workload):
    cell = tiny.cell(workload, dtype="float32", budget=512)
    _, batches, loaded, bad, first = _run(cell, 2 ** 31 + 11)
    assert bad == 0, first
    for want, got in zip(batches, loaded):
        for k, v in want.items():
            np.testing.assert_array_equal(got["batch"][k], v)


def test_packer_catches_a_dropped_item_and_an_altered_token():
    cell = tiny.cell(budget=512)
    prog = DRV.Program(cell, 5, "cpu")
    prog.step()
    draws, loaded = prog.stream.drawn, prog.loaded
    prog.close()
    dropped = [{**loaded[0], "groups": [g[:-1] if i == 0 else g
                                        for i, g in enumerate(loaded[0]["groups"])]}]
    assert DRV.data_check(cell, 5, draws, dropped)[0] == 1
    batch = {k: v.copy() for k, v in loaded[0]["batch"].items()}
    batch["tokens"][0, 0, 3] += 1
    assert DRV.data_check(cell, 5, draws, [{**loaded[0], "batch": batch}])[0] == 1


def test_reference_follows_the_port_in_fp32():
    cell = tiny.cell(dtype="float32")
    readings, batches, _, bad, _ = _run(cell, 3)
    assert bad == 0
    ref = DRV.reference_readings(cell, 3, batches[:DRV.CHECK_STEPS], "cpu")
    nums = DRV.compare(readings, ref)
    assert nums["loss"] < 1e-5 and nums["grad1"] < 1e-4, nums
    assert max(nums[k] for k in ("update", "decay", "descent")) < 1e-4, nums


def test_reference_is_plain_pytorch():
    """The reference module imports torch and numpy alone."""
    import ast
    for name in ("decoder", "packer"):
        tree = ast.parse((core.HERE / "references" / f"{name}.py").read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert mods <= {"torch", "numpy", "contextlib", "__future__"}, mods


def test_weights_are_the_seeds_and_made_again_by_group():
    from portbench import weights
    from portbench.dims import dims
    m = dims(tiny.cell()["config"])
    a, b = weights.make(m, 7, "cpu"), weights.make(m, 7, "cpu")
    c = weights.make(m, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    g = weights.make_group(m, 7, "cpu", "layer1")
    assert all(torch.equal(g[k], a[k]) for k in g)
    assert float(a["layers.0.ln1"].min()) == 1.0
