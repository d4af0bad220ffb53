"""The sizes and initial weights of a hybrid Mamba/attention decoder with a
tied head (``configs/<name>.json`` in the keys of a published Jamba
``config.json``), as ``drivers/dflop_train_hybrid.py`` hands them to the
program and to ``references/jamba.py``.

Layer i is attention where ``i % attn_layer_period == attn_layer_offset``,
else Mamba-1 (HF ``modeling_jamba``'s order); every FFN is a dense SwiGLU
(``num_experts`` 1).  The weights lie in groups (the embedding, which is also
the LM head, each layer, the final norm), each one buffer filled by one
``randn`` of a generator seeded from (seed, group) and then set leaf by leaf
as the port's ``model.init`` draws them: the embedding N(0, 0.02),
projections N(0, fan_in^-1/2), the conv N(0, d_conv^-1/2), norm scales and
D 1, the conv bias 0, the dt bias -4.6, A_log log(1 .. d_state).

Leaf names (the reference's layout): ``embed`` (V, d), ``final_norm`` (d,);
per layer ``layers.{i}.{ln1, ln2, w_gate, w_up, w_down}`` and either
``wq`` (d, H, hd), ``wk``/``wv`` (d, KH, hd), ``wo`` (H, hd, d), or
``in_proj`` (d, 2 di), ``conv_w`` (di, K), ``conv_b`` (di,), ``x_proj``
(di, R + 2N), ``dt_norm`` (R,), ``b_norm``/``c_norm`` (N,), ``dt_proj``
(R, di), ``dt_bias`` (di,), ``A_log`` (di, N), ``D`` (di,), ``out_proj``
(di, d).

``Dims`` carries what ``formulas`` reads of a decoder: ``layers`` there is
the number of attention layers (the kept pairs are counted in those alone)
and ``matmul_params`` counts every layer's projections and the tied head
once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# how a leaf starts: ("normal", std), ("const", value) or ("alog",)
ONES = ("const", 1.0)
ZEROS = ("const", 0.0)
DT_BIAS = ("const", -4.6)          # softplus^-1(0.01), the port's init
ALOG = ("alog",)


@dataclass(frozen=True)
class Dims:
    layers: int                    # attention layers (what formulas count pairs in)
    n_layers: int                  # every layer
    attn_layers: tuple
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    d_inner: int
    d_state: int
    d_conv: int
    dt_rank: int
    eps: float
    rope_theta: float              # not used: Jamba's attention has no positions
    compute_dtype: str
    param_dtype: str

    def is_attention(self, i: int) -> bool:
        return i in self.attn_layers

    @property
    def matmul_params(self) -> int:
        """Parameters of the matrix products a token passes through: each
        attention layer's q, k, v and o, each Mamba layer's in, x, dt and out
        projections, every layer's SwiGLU, and the tied head once (the
        embedding lookup and the depthwise conv are no products)."""
        d, di, R, N = self.d, self.d_inner, self.dt_rank, self.d_state
        attn = d * self.head_dim * (2 * self.heads + 2 * self.kv_heads)
        mamba = d * 2 * di + di * (R + 2 * N) + R * di + di * d
        n_attn = len(self.attn_layers)
        return (n_attn * attn + (self.n_layers - n_attn) * mamba
                + self.n_layers * 3 * d * self.d_ff + d * self.vocab)


def dims(cfg: dict) -> Dims:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("hidden_act", "silu") != "silu" or not cfg.get("tie_word_embeddings"):
        raise ValueError(f"{cfg['name']}: the hybrid driver runs SwiGLU with a tied head")
    if cfg.get("num_experts", 1) != 1 or cfg.get("mamba_proj_bias") or \
            not cfg.get("mamba_conv_bias", True):
        raise ValueError(f"{cfg['name']}: the hybrid driver runs dense FFNs, a conv bias "
                         "and no projection bias")
    n = cfg["num_hidden_layers"]
    attn = tuple(i for i in range(n)
                 if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"])
    return Dims(layers=len(attn), n_layers=n, attn_layers=attn, d=d, heads=h,
                kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim") or d // h,
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                d_inner=cfg["mamba_expand"] * d, d_state=cfg["mamba_d_state"],
                d_conv=cfg["mamba_d_conv"],
                # the port's rule (HF's "auto"): 160 at Jamba2-3B's 2560
                dt_rank=math.ceil(d / 16), eps=cfg["rms_norm_eps"],
                rope_theta=cfg.get("rope_theta", 0.0), compute_dtype=cfg["torch_dtype"],
                param_dtype=cfg["param_dtype"])


def port_config(cfg: dict, m: Dims, *, segment_reset: bool = True):
    """The port's ``ModelConfig`` of the configuration: the layer pattern of
    one period, Mamba restarting at each segment start (``segment_reset``)
    and Jamba's inner norms."""
    from repro_torch.common.types import ModelConfig
    period = cfg["attn_layer_period"]
    pattern = tuple("attention" if i % period == cfg["attn_layer_offset"] else "mamba"
                    for i in range(period))
    return ModelConfig(name=cfg["name"], family="hybrid", n_layers=m.n_layers, d_model=m.d,
                       n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.head_dim,
                       d_ff=m.d_ff, vocab_size=m.vocab, layer_pattern=pattern,
                       activation="swiglu", use_rope=False, ssm_d_state=m.d_state,
                       ssm_d_conv=m.d_conv, ssm_expand=m.d_inner // m.d,
                       ssm_segment_reset=segment_reset, ssm_inner_norms=True,
                       tie_embeddings=True, norm_eps=m.eps, dtype=m.compute_dtype,
                       param_dtype=m.param_dtype)


def groups(m: Dims) -> list[tuple[str, list[tuple[str, tuple, tuple]]]]:
    """(group, [(leaf, shape, how it starts)]) in the order they are made."""
    d, ff, di, R, N, K = m.d, m.d_ff, m.d_inner, m.dt_rank, m.d_state, m.d_conv
    out = [("embed", [("embed", (m.vocab, d), ("normal", 0.02))])]
    for i in range(m.n_layers):
        p = f"layers.{i}."
        if m.is_attention(i):
            h, kh, hd = m.heads, m.kv_heads, m.head_dim
            mixer = [(p + "wq", (d, h, hd), ("normal", d ** -0.5)),
                     (p + "wk", (d, kh, hd), ("normal", d ** -0.5)),
                     (p + "wv", (d, kh, hd), ("normal", d ** -0.5)),
                     (p + "wo", (h, hd, d), ("normal", (h * hd) ** -0.5))]
        else:
            mixer = [(p + "in_proj", (d, 2 * di), ("normal", d ** -0.5)),
                     (p + "conv_w", (di, K), ("normal", K ** -0.5)),
                     (p + "conv_b", (di,), ZEROS),
                     (p + "x_proj", (di, R + 2 * N), ("normal", di ** -0.5)),
                     (p + "dt_norm", (R,), ONES), (p + "b_norm", (N,), ONES),
                     (p + "c_norm", (N,), ONES),
                     (p + "dt_proj", (R, di), ("normal", R ** -0.5)),
                     (p + "dt_bias", (di,), DT_BIAS), (p + "A_log", (di, N), ALOG),
                     (p + "D", (di,), ONES), (p + "out_proj", (di, d), ("normal", di ** -0.5))]
        out.append((f"layer{i}", [(p + "ln1", (d,), ONES), (p + "ln2", (d,), ONES), *mixer,
                                  (p + "w_gate", (d, ff), ("normal", d ** -0.5)),
                                  (p + "w_up", (d, ff), ("normal", d ** -0.5)),
                                  (p + "w_down", (ff, d), ("normal", ff ** -0.5))]))
    out.append(("final_norm", [("final_norm", (d,), ONES)]))
    return out


def _seed(seed: int, g: int) -> int:
    return (abs(int(seed)) * 1_000_003 + 7919 * g + 1) % 2 ** 63


def _fill(leaves, seed: int, g: int, device, dtype) -> dict:
    n = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, g))
    buf = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, how in leaves:
        k = math.prod(shape)
        view = buf[off:off + k]
        if how[0] == "normal":
            view.mul_(how[1])
        elif how[0] == "const":
            view.fill_(how[1])
        else:                                            # A_log: log(1 .. N) a channel
            view.view(shape).copy_(torch.log(torch.arange(
                1, shape[1] + 1, dtype=torch.float32, device=device)).expand(shape))
        out[name] = view.view(shape)
        off += k
    if dtype != torch.float32:
        return {k: v.to(dtype) for k, v in out.items()}
    return out


def make(m: Dims, seed: int, device, dtype=torch.float32) -> dict:
    """Every leaf, by name."""
    w = {}
    for g, (_, leaves) in enumerate(groups(m)):
        w.update(_fill(leaves, seed, g, device, dtype))
    return w


def make_group(m: Dims, seed: int, device, group: str) -> dict:
    """The leaves of one group as ``make`` draws them (fp32)."""
    for g, (name, leaves) in enumerate(groups(m)):
        if name == group:
            return _fill(leaves, seed, g, device, torch.float32)
    raise KeyError(group)


# The port's parameter tree (``repro_torch.models.model.init``'s layout with
# ``ssm_inner_norms``): its '/'-joined paths against the leaf names above.
_MAMBA = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
          "out_proj")
_NORMS = ("dt_norm", "b_norm", "c_norm")
MIXER_LEAVES = _MAMBA + _NORMS     # a Mamba mixer's leaves
_LAYER_PATH = {"ln1/scale": "ln1", "ln2/scale": "ln2",
               **{f"attn/{k}": k for k in ("wq", "wk", "wv", "wo")},
               **{f"mamba/{k}": k for k in _MAMBA},
               **{f"mamba/{k}/scale": k for k in _NORMS},
               **{f"ffn/{k}": k for k in ("w_gate", "w_up", "w_down")}}


def leaf_name(path: str) -> str:
    """The leaf name of a port tree path (``layers/3/mamba/b_norm/scale`` ->
    ``layers.3.b_norm``)."""
    top = {"embed/w": "embed", "final_norm/scale": "final_norm"}
    if path in top:
        return top[path]
    _, i, rest = path.split("/", 2)
    return f"layers.{i}.{_LAYER_PATH[rest]}"


def port_tree(m: Dims, w: dict) -> dict:
    """The port's tree over the same storage, each leaf requiring grad."""
    def leaf(name):
        return w[name].detach().requires_grad_(True)

    layers = []
    for i in range(m.n_layers):
        p = f"layers.{i}."
        lp = {"ln1": {"scale": leaf(p + "ln1")}, "ln2": {"scale": leaf(p + "ln2")},
              "ffn": {k: leaf(p + k) for k in ("w_gate", "w_up", "w_down")}}
        if m.is_attention(i):
            lp["attn"] = {k: leaf(p + k) for k in ("wq", "wk", "wv", "wo")}
        else:
            lp["mamba"] = {**{k: leaf(p + k) for k in _MAMBA},
                           **{k: {"scale": leaf(p + k)} for k in _NORMS}}
        layers.append(lp)
    return {"embed": {"w": leaf("embed")}, "layers": layers,
            "final_norm": {"scale": leaf("final_norm")}}
