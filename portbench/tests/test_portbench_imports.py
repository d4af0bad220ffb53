"""Nothing the benchmark runs loads JAX, Flax or the JAX package: the check
compares each module's whole top-level name, and a tiny run in a fresh
process leaves none of them in ``sys.modules``."""
import json
import subprocess
import sys

import tiny
from portbench import core


def test_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.models.model", "reprox", "jaxtyping", "portbench.run",
            "repro", "repro.core.engine", "jax.numpy", "jaxlib", "flax.linen"]
    assert core.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                                            "repro.core.engine"]


SCRIPT = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import tiny
from portbench import core
drv = core.load_module("drivers", "dflop_train")
rec = drv.run(tiny.cell(), 2 ** 31 + 3, 0.5, True, device="cpu")
for m in core.benchmark()["per_layer"]:
    core.load_module("metrics", m["name"]).read(rec)
print(json.dumps(sorted(sys.modules)))
"""


def test_a_tiny_run_loads_neither_jax_nor_repro():
    code = SCRIPT.format(root=str(tiny.ROOT), src=str(tiny.ROOT / "src"),
                         tests=str(tiny.ROOT / "portbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tiny.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.train.step" in mods
    assert core.forbidden_modules(mods) == []
