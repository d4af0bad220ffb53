"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's small-mesh dry run (tests/test_multidevice.py
``test_dryrun_smoke_small_mesh``, extended to print what it computes).

Reduced gemma-2b, ``ShapeSpec("mini", 256, 16, "train")``, on a (2, 4)
("data", "model") mesh: the reference compiles its step at 8 forced host
devices once for the file in a subprocess (its device count is fixed at
jax's first init) and prints ``memory_analysis()`` and ``analyze()``; the
port runs its step on CPU fake tensors as rank 0 of a fake process group of
8, started for this module and destroyed after it.

  * argument bytes equal the reference's, but for one leaf: the AdamW step
    counter, an int32 array in the reference and a Python int in the port
    (4 bytes);
  * FLOPs a rank × 8 ≥ 6·N·D, and within a factor of 1.5 of the
    reference's (the port counts what its eager step runs: the recompute of
    each checkpointed layer, K1–K3 at a dense mask, the fp32 CE over the
    vocab slice, which XLA's fusion and its own counts differ on);
  * collective bytes by kind printed beside the reference's (the two
    partitioners choose different collectives, ROADMAP Queue 3);
  * a positive peak.

Then the train, prefill and decode builders at the same mesh for reduced
Mixtral-8x7B (the expert-parallel MoE), Jamba (the channel-sharded Mamba
scan, K4/K5) and InternVL2-2B (the communicator, the heterogeneous
encoder), at 2 microbatches a step where the production count is 8 or 16
(each microbatch runs the same ops; the count only multiplies the time),
and HuBERT's decode recorded as skipped.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from repro_torch.common.types import ShapeSpec
from repro_torch.configs import get_config
from repro_torch.core.profiling.flops import model_flops_6nd
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = ShapeSpec("mini", 256, 16, "train")
FLOP_FACTOR = 1.5

REFERENCE = textwrap.dedent("""
    import dataclasses, json
    from repro.configs import get_config
    from repro.common.types import ShapeSpec
    from repro.launch import dryrun as D
    from repro.launch.hlo_stats import analyze
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((2, 4), ("data", "model"))
    spec = get_config("gemma-2b")
    spec = dataclasses.replace(spec, desc=spec.reduced_desc())
    jitted, args, extra = D.build_train(spec, ShapeSpec("mini", 256, 16, "train"), mesh)
    with mesh:
        co = jitted.lower(*args).compile()
    ma = co.memory_analysis()
    st = analyze(co.as_text())
    print("RESULT " + json.dumps({
        "argument_bytes": ma.argument_size_in_bytes,
        "output_bytes": ma.output_size_in_bytes,
        "temp_bytes": ma.temp_size_in_bytes,
        "alias_bytes": ma.alias_size_in_bytes,
        "hlo": st.as_dict()}))
""")


@pytest.fixture(scope="module")
def reference():
    """Started first, read when a test needs it (it runs beside the port)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = []

    def result():
        if not out:
            text, _ = proc.communicate(timeout=300)
            lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            assert proc.returncode == 0 and lines, text[-3000:]
            out.append(json.loads(lines[-1][len("RESULT "):]))
        return out[0]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def mesh(reference):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_mesh((2, 4), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _reduced(arch):
    spec = get_config(arch)
    return dataclasses.replace(spec, desc=spec.reduced_desc())


def test_gemma_train_against_reference(mesh, reference):
    spec = _reduced("gemma-2b")
    rec = D.run_one("gemma-2b", "mini", False, spec=spec, shape=MINI, mesh=mesh,
                    device="cpu", verbose=False)
    assert rec["ok"], rec.get("traceback")
    ref = reference()
    mem, hlo = rec["memory"], rec["hlo"]
    # the one differing leaf: opt_state["step"], int32 () in the reference,
    # a Python int in the port
    assert mem["argument_bytes"] + 4 == ref["argument_bytes"]
    assert rec["n_mb"] == 8 and hlo["while_trips"] == {"microbatches": 8, "llm_layers": 2}
    six_nd = model_flops_6nd(spec.desc, MINI.tokens)
    assert hlo["flops"] * 8 >= six_nd
    ratio = hlo["flops"] / ref["hlo"]["flops"]
    assert 1 / FLOP_FACTOR <= ratio <= FLOP_FACTOR, ratio
    assert mem["peak_per_chip"] > 0
    ref_peak = (ref["argument_bytes"] + ref["output_bytes"] + ref["temp_bytes"]
                - ref["alias_bytes"])
    print(f"\nflops a rank: port {hlo['flops']:.4g}, reference {ref['hlo']['flops']:.4g} "
          f"(ratio {ratio:.3f}); 6ND / 8 = {six_nd / 8:.4g}")
    print(f"peak a rank: port {mem['peak_per_chip']}, reference {ref_peak}")
    for kind in sorted(set(hlo["collective_bytes"]) | set(ref["hlo"]["collective_bytes"])):
        print(f"{kind:>18}: port {hlo['collective_bytes'].get(kind, 0):.4g} B, "
              f"reference {ref['hlo']['collective_bytes'].get(kind, 0):.4g} B")


@pytest.mark.parametrize("arch,seq", [("mixtral-8x7b", 256), ("jamba-v0.1-52b", 256),
                                      ("internvl2-2b", 1024)])
def test_builders_run(arch, seq, mesh, monkeypatch):
    monkeypatch.setattr(D, "N_MB", {k: 2 for k in D.N_MB})
    spec = _reduced(arch)
    for kind, batch in (("train", 16), ("prefill", 8), ("decode", 8)):
        rec = D.run_one(arch, kind, False, spec=spec, shape=ShapeSpec(kind, seq, batch, kind),
                        mesh=mesh, device="cpu", verbose=False)
        assert rec["ok"] and not rec["skipped"], rec.get("traceback")
        assert rec["memory"]["peak_per_chip"] >= rec["memory"]["argument_bytes"] > 0
        assert rec["hlo"]["flops"] > 0 and rec["hlo"]["total_collective_bytes"] > 0
        assert rec["fits_80gb"]


def test_encoder_only_decode_is_skipped(mesh):
    rec = D.run_one("hubert-xlarge", "decode_32k", False, mesh=mesh, device="cpu",
                    verbose=False)
    assert rec["ok"] and rec["skipped"] and rec["reason"].startswith("skip")
