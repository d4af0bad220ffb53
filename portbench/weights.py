"""Initial weights of a decoder, made on the device from the run's seed and
handed alike to the program and to the reference.

The weights lie in groups (the embedding, each layer, the final norm and the
LM head), each one contiguous buffer filled by one ``randn`` call of a
generator seeded from (seed, group), then scaled leaf by leaf: the
embedding N(0, 0.02), each projection N(0, fan_in^-1/2), norm scales 1, as
the port's ``model.init`` draws them.  A group can be made again on its own
(``make_group``), so the change of the parameters can be measured without a
second copy of the whole model.

Leaf names (the reference's layout): ``embed`` (V, d), ``unembed`` (d, V),
``final_norm`` (d,), and per layer ``layers.{i}.{ln1, wq, wk, wv, wo, ln2,
w_gate, w_up, w_down}`` with wq (d, H, hd), wk/wv (d, KH, hd), wo (H, hd, d),
w_gate/w_up (d, ff), w_down (ff, d).
"""
from __future__ import annotations

import math

import torch

from portbench.dims import Dims

ONES = None     # a leaf that starts at 1 (a norm scale)


def groups(m: Dims) -> list[tuple[str, list[tuple[str, tuple, float | None]]]]:
    """(group, [(leaf, shape, std or ONES)]) in the order they are made."""
    d, h, kh, hd, ff = m.d, m.heads, m.kv_heads, m.head_dim, m.d_ff
    out = [("embed", [("embed", (m.vocab, d), 0.02)])]
    for i in range(m.layers):
        p = f"layers.{i}."
        out.append((f"layer{i}", [
            (p + "ln1", (d,), ONES), (p + "ln2", (d,), ONES),
            (p + "wq", (d, h, hd), d ** -0.5), (p + "wk", (d, kh, hd), d ** -0.5),
            (p + "wv", (d, kh, hd), d ** -0.5), (p + "wo", (h, hd, d), (h * hd) ** -0.5),
            (p + "w_gate", (d, ff), d ** -0.5), (p + "w_up", (d, ff), d ** -0.5),
            (p + "w_down", (ff, d), ff ** -0.5)]))
    out.append(("final_norm", [("final_norm", (d,), ONES)]))
    out.append(("unembed", [("unembed", (d, m.vocab), d ** -0.5)]))
    return out


def _seed(seed: int, g: int) -> int:
    return (abs(int(seed)) * 1_000_003 + 7919 * g + 1) % 2 ** 63


def _fill(leaves, seed: int, g: int, device, dtype) -> dict:
    n = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, g))
    buf = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in leaves:
        k = math.prod(shape)
        view = buf[off:off + k]
        if std is ONES:
            view.fill_(1.0)
        else:
            view.mul_(std)
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


# The port's parameter tree (``repro_torch.models.model.init``'s layout):
# its '/'-joined paths against the leaf names above.
_LAYER_PATH = {"ln1/scale": "ln1", "ln2/scale": "ln2", "attn/wq": "wq", "attn/wk": "wk",
               "attn/wv": "wv", "attn/wo": "wo", "ffn/w_gate": "w_gate",
               "ffn/w_up": "w_up", "ffn/w_down": "w_down"}


def leaf_name(path: str) -> str:
    """The leaf name of a port tree path (``layers/3/attn/wq`` ->
    ``layers.3.wq``)."""
    top = {"embed/w": "embed", "unembed/w": "unembed", "final_norm/scale": "final_norm"}
    if path in top:
        return top[path]
    _, i, rest = path.split("/", 2)
    return f"layers.{i}.{_LAYER_PATH[rest]}"


def port_tree(m: Dims, w: dict) -> dict:
    """The port's tree over the same storage, each leaf requiring grad."""
    def leaf(name):
        return w[name].detach().requires_grad_(True)

    layers = []
    for i in range(m.layers):
        p = f"layers.{i}."
        layers.append({"ln1": {"scale": leaf(p + "ln1")}, "ln2": {"scale": leaf(p + "ln2")},
                       "attn": {k: leaf(p + k) for k in ("wq", "wk", "wv", "wo")},
                       "ffn": {k: leaf(p + k) for k in ("w_gate", "w_up", "w_down")}})
    return {"embed": {"w": leaf("embed")}, "layers": layers,
            "final_norm": {"scale": leaf("final_norm")}, "unembed": {"w": leaf("unembed")}}
