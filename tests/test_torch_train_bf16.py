"""``make_train_step`` on bf16 parameters (the dry run's configs) against
the reference's: 3 steps of a tiny dense decoder (the reference's own
weights through ``params_from_jax``), 2 microbatches a step, bf16 params
and activations.  Both packages accumulate each microbatch's bf16 gradient
in an fp32 buffer, divide by the count and hand AdamW fp32 gradients;
AdamW casts each update back to bf16.

Tolerance: the two packages round their bf16 activations at different
points (XLA fuses what eager runs op by op), so losses are held to 2e-2
relative and every parameter to 2 bf16 ulps of its magnitude (rtol 2^-7)
plus 1e-3 absolute; the updates themselves to 5e-3 absolute.  AdamW runs
at lr 0.1 and eps 1 (in both packages): an update then follows the
gradient's size, not only its sign, so a bf16 rounding that flips the sign
of a near-zero gradient moves a weight by little, and a step moves the
weights by more than their bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.common import types as jtypes
from repro.models import model as jmodel
from repro.models.model import FwdCtx as JFwdCtx
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.models.model import FwdCtx
from repro_torch.train import optim, step

torch.set_num_threads(1)

LR, EPS, N_MB, ROWS, S, V = 1e-1, 1.0, 2, 2, 32, 256
LOSS_RTOL, P_RTOL, P_ATOL, UPDATE_ATOL = 2e-2, 2.0 ** -7, 1e-3, 5e-3


def _cfg(t):
    return t.ModelConfig(name="bf16-tiny", family="dense", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                         vocab_size=V, dtype="bfloat16", param_dtype="bfloat16")


JCFG, CFG = _cfg(jtypes), _cfg(types)


def _batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        tok = rng.integers(0, V, (N_MB, ROWS, S + 1)).astype(np.int32)
        seg = np.ones((N_MB, ROWS, S), np.int32)
        seg[..., S // 2:] = 2                                  # two packed items a row
        pos = np.concatenate([np.arange(S // 2)] * 2).astype(np.int32)
        out.append({"tokens": tok[..., :-1], "labels": tok[..., 1:], "segment_ids": seg,
                    "positions": np.broadcast_to(pos, (N_MB, ROWS, S)).copy()})
    return out


def test_three_bf16_train_steps_track_reference():
    jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    params = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    jtrain = jax.jit(jstep.make_train_step(
        JCFG, joptim.AdamWConfig(lr=LR, eps=EPS),
        ctx=JFwdCtx(mode="train", attn_impl="naive")))
    train = step.make_train_step(CFG, optim.AdamWConfig(lr=LR, eps=EPS),
                                 ctx=FwdCtx(attn_impl="kernel"))
    jopt, opt = joptim.adamw_init(jp), optim.adamw_init(params)
    p0 = [p.detach().float().clone() for p in tree_leaves(params)]
    for b in _batches(3):
        jp, jopt, jm = jtrain(jp, jopt, jax.tree.map(jnp.asarray, b), LR)
        tb = {k: torch.as_tensor(v) for k, v in b.items()}
        params, opt, m = train(params, opt, tb, LR)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    assert opt["step"] == 3
    assert all(p.dtype == torch.bfloat16 and p.grad is None for p in tree_leaves(params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(opt["m"]))
    want = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    for a, b, q0 in zip(tree_leaves(params), tree_leaves(want), p0):
        a, b = a.detach().float(), b.detach().float()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=P_RTOL, atol=P_ATOL)
        ref = b - q0
        # the reference's matrices moved (a norm scale's update may round away)
        assert ref.abs().max() > 0 or a.ndim < 2
        np.testing.assert_allclose((a - q0).numpy(), ref.numpy(), rtol=0,
                                   atol=UPDATE_ATOL)
