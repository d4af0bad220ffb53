"""The port's sharding rules against the reference's, with no process group.

``param_specs`` and ``opt_state_specs`` of all 13 registered configurations
at full size, on stand-in 16x16 and 2x16x16 meshes (objects with a
``.shape`` dict, which both packages accept), with ZeRO and FSDP off, ZeRO
on, and FSDP on: shapes only (``jax.eval_shape`` for the reference, the
port's ``init`` under ``FakeTensorMode``).  A port leaf ``layers/{i}/X``
holds the reference's ``blocks/pos{i % period}/X`` with the stacked
``n_blocks`` dim dropped, so its spec must equal the reference's without its
first entry.  Where the reference puts ZeRO axes on that stacked dim the
port cannot follow (``LAYER_DIM_ZERO`` names such leaves; there are none on
these meshes and assignments).  Also ``sanitize_spec``, ``to_placements``,
the activation specs, ``make_production_mesh`` under the fake process group
(a subprocess) and the mesh's refusal to run without a card.
"""
import functools
import os
import re
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.common import types as jtypes
from repro.configs import get_config as jget_config
from repro.models import mllm as jmllm
from repro.models import model as jmodel
from repro.sharding import partition as jpart
from repro_torch.common.pytree import tree_paths
from repro_torch.common.types import MLLMConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mllm, model
from repro_torch.sharding import partition as part
from repro_torch.sharding.partition import P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = ("off", "zero", "fsdp")
# (arch, mesh, mode, "param" | "opt", reference path) where the reference's
# ZeRO axes land on the stacked layer dim: none at these meshes
LAYER_DIM_ZERO: set = set()


class StandIn:
    """A production mesh's names and sizes, with no process group."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _norm(spec) -> tuple:
    return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e))
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jd, d = jget_config(arch).desc, get_config(arch).desc
    key = jax.random.PRNGKey(0)
    with FakeTensorMode():
        if isinstance(d, MLLMConfig):
            ps = mllm.init(d, device="cpu")
        else:
            ps = model.init(d, device="cpu")
    if isinstance(jd, jtypes.MLLMConfig):
        js = jax.eval_shape(lambda: jmllm.init(key, jd))
    else:
        js = jax.eval_shape(lambda: jmodel.init(key, jd))
    return js, ps


def _assignments(mod, mesh_shape, mode):
    bax = tuple(a for a in ("pod", "data") if a in mesh_shape)
    kw = {} if mode == "off" else dict(zero=bax, fsdp=mode == "fsdp")
    return mod.ModuleAssignment(
        llm=mod.AxisAssignment(batch=bax, tensor=("model",), **kw),
        encoder=mod.AxisAssignment(batch=bax + ("model",), tensor=(), **kw))


def _ref_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): _norm(s)
            for path, s in flat}


def _cfg_at(desc, prefix):
    if isinstance(desc, MLLMConfig):
        return desc.encoder if prefix.startswith("encoder") else desc.llm
    return desc


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(arch, mesh_name):
    js, ps = _shapes(arch)
    desc = get_config(arch).desc
    mesh = StandIn(MESHES[mesh_name])
    n_sharded = n_layer_dim = 0
    for mode in MODES:
        jpa = jpart.param_specs(js, _assignments(jpart, mesh.shape, mode), mesh)
        jos = jpart.opt_state_specs(js, jpa, _assignments(jpart, mesh.shape, mode), mesh)
        ppa = part.param_specs(ps, _assignments(part, mesh.shape, mode), mesh)
        pos = part.opt_state_specs(ps, ppa, _assignments(part, mesh.shape, mode), mesh)
        assert len(tree_paths(ppa)) == len(tree_paths(ps))
        for kind, jt, pt in (("param", jpa, ppa), ("opt", jos, pos)):
            want_by_path = _ref_flat(jt)
            for path, spec in tree_paths(pt):
                got = _norm(spec)
                m = re.match(r"(.*?)layers/(\d+)/(.*)", path)
                if m:
                    pre, i, rest = m.groups()
                    period = _cfg_at(desc, pre).block_period
                    jpath = f"{pre}blocks/pos{int(i) % period}/{rest}"
                    ref = want_by_path[jpath]
                    lead, want = (ref[0] if ref else None), ref[1:]
                    if lead is not None:
                        n_layer_dim += 1
                        assert (arch, mesh_name, mode, kind, jpath) in LAYER_DIM_ZERO, \
                            (jpath, ref, got)
                        continue
                else:
                    want = want_by_path[path]
                assert got == want, (mode, kind, path, want, got)
                n_sharded += any(e is not None for e in got)
    assert n_sharded > 0
    assert n_layer_dim == sum(1 for q in LAYER_DIM_ZERO if q[:2] == (arch, mesh_name))


def _outcome(fn):
    try:
        return fn()
    except IndexError:
        return IndexError


def test_sanitize_spec_and_activation_specs_match_reference():
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
                  {"data": 4, "model": 1}):
        mesh = StandIn(shape)
        axes = [None, "data", "model", ("data", "model"), ("model", "data")]
        if "pod" in shape:
            axes += [("pod", "data"), ("pod", "data", "model")]
        for dims in ((16, 48), (64, 8), (2, 512), (32, 1), (48,)):
            for a in axes:
                for b in axes:
                    # a tuple entry past the leaf's dims raises in both
                    # packages (IndexError); compare outcomes
                    got, want = (_outcome(lambda: _norm(fn(spec(a, b), dims, mesh)))
                                 for fn, spec in ((part.sanitize_spec, P),
                                                  (jpart.sanitize_spec, JP)))
                    assert got == want, (shape, dims, a, b)
        for a in (jpart.AxisAssignment(), jpart.AxisAssignment(batch=("pod", "data")),
                  jpart.AxisAssignment(batch=(), tensor=())):
            pa = part.AxisAssignment(**{f: getattr(a, f) for f in a.__dataclass_fields__})
            if "pod" in a.batch and "pod" not in shape:
                continue
            assert (pa.dp(mesh), pa.tp(mesh)) == (a.dp(mesh), a.tp(mesh))
            assert _norm(part.tokens_spec(pa, 2)) == _norm(jpart.tokens_spec(a, 2))
            assert _norm(part.activation_spec(pa)) == _norm(jpart.activation_spec(a))
    from repro.launch import mesh as jmesh
    for shape in MESHES.values():
        assert mesh_lib.batch_axes(StandIn(shape)) == jmesh.batch_axes(StandIn(shape))
        assert mesh_lib.model_axes(StandIn(shape)) == jmesh.model_axes(StandIn(shape))
    assert mesh_lib.host_groups(range(8), 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.host_groups(range(6), 4)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandIn({"data": 2, "model": 4})
    assert part.to_placements(P(("data", "model"), None), mesh) == [Shard(0), Shard(0)]
    assert part.to_placements(P(None, "model"), mesh) == [Replicate(), Shard(1)]
    assert part.to_placements(P("model", "data"), mesh) == [Shard(1), Shard(0)]
    assert part.to_placements(P(), mesh) == [Replicate(), Replicate()]
    assert part.named(mesh, P("data")) == [Shard(0), Replicate()]
    with pytest.raises(ValueError, match="out of"):
        part.to_placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="two dims"):
        part.to_placements(P("data", "data"), mesh)


def test_make_production_mesh_under_fake_process_group():
    script = textwrap.dedent("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import mesh as mesh_lib
        for multi_pod, world in ((False, 256), (True, 512)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            m = mesh_lib.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            print(mesh_lib.mesh_shape(m), mesh_lib.batch_axes(m),
                  mesh_lib.model_axes(m))
            dist.destroy_process_group()
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines() == [
        "{'data': 16, 'model': 16} ('data',) ('model',)",
        "{'pod': 2, 'data': 16, 'model': 16} ('pod', 'data') ('model',)"]


def test_mesh_without_card_or_process_group_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_host_mesh((1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_lib.make_mesh((1,), ("stage",), device_type="cpu")
