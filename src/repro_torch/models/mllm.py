"""MLLM composition: modality encoder -> connector -> LLM (paper §2.1).

Batch convention (modality frontend stubbed), one microbatch:
    media_embeds : (B, T_media, embed_dim)  precomputed patch/frame embeds
    media_mask   : (B, T_media)             1 = real media token
    text_tokens  : (B, T_text) int32
    text_mask    : (B, T_text)              1 = real text token
    labels       : (B, T_text) int32        next-token targets (-1 = ignore)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import trainable
from repro_torch.common.types import MLLMConfig, resolve_device, torch_dtype
from repro_torch.models import model as model_lib
from repro_torch.models.layers import embed as embed_lib
from repro_torch.models.model import FwdCtx
from repro_torch.sharding.local import is_dtensor, rows_local


def init(mcfg: MLLMConfig, seed: int = 0, device="cuda"):
    """Random parameters ``{"encoder", "connector", "llm"}`` on ``device``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    de, dl = mcfg.encoder.d_model, mcfg.llm.d_model
    dtype = torch_dtype(mcfg.llm.param_dtype)

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype)

    if mcfg.connector_hidden:
        connector = {"w1": normal((de, mcfg.connector_hidden), de ** -0.5),
                     "w2": normal((mcfg.connector_hidden, dl),
                                  mcfg.connector_hidden ** -0.5)}
    else:
        connector = {"w1": normal((de, dl), de ** -0.5)}
    return trainable({
        "encoder": model_lib.init(mcfg.encoder, gen=gen),
        "connector": connector,
        "llm": model_lib.init(mcfg.llm, gen=gen),
    })


def apply_connector(params, h, mcfg: MLLMConfig):
    w1 = params["w1"].to(h.dtype)
    if "w2" in params:
        h = F.gelu(h @ w1, approximate="tanh")     # jax.nn.gelu's default
        return h @ params["w2"].to(h.dtype)
    return h @ w1


def encode_media(params, mcfg: MLLMConfig, media_embeds, media_mask=None,
                 ctx: FwdCtx | None = None, communicator=None):
    """Encoder + connector. Returns LLM-space media tokens (B, T_out, dl).

    ``communicator`` (``core.communicator.make_communicator``) moves the
    encoder's output from the encoder's data-parallel layout to the LLM's
    before the connector (paper Fig. 6)."""
    ctx = ctx or FwdCtx(mode="train")
    seg = None
    if media_mask is not None:
        # mask -> segment ids: padding gets segment 0, real tokens segment 1
        seg = media_mask.to(torch.int32)
    h, _, _ = model_lib.forward(params["encoder"], mcfg.encoder,
                                embeds=media_embeds, segment_ids=seg, ctx=ctx)
    if communicator is not None:
        # Inter-model Communicator: reshard encoder output from the encoder's
        # data-parallel layout to the LLM's (paper Fig. 6).
        h = communicator(h)
    if is_dtensor(h):
        # on each rank's rows, the (small) connector whole: DTensor's own
        # rules would shard the rows over the axes its ZeRO shards use
        names = sorted(params["connector"])
        h = rows_local(lambda x, *w: apply_connector(dict(zip(names, w)), x, mcfg),
                       (h,), [params["connector"][n] for n in names], 3)
    else:
        h = apply_connector(params["connector"], h, mcfg)
    if mcfg.tokens_per_item_out:
        t_in = h.shape[1]
        factor = max(1, t_in // mcfg.tokens_per_item_out)
        if factor > 1:
            b, _, d = h.shape
            h = h[:, : (t_in // factor) * factor]
            h = h.reshape(b, t_in // factor, factor, d).mean(dim=2)
    return h


def forward_train(params, mcfg: MLLMConfig, batch, ctx: FwdCtx | None = None,
                  communicator=None, enc_ctx: FwdCtx | None = None):
    """Full multimodal forward: returns (logits over text span, aux); with
    ``ctx.return_hidden``, the text span's hidden states.  With a
    ``communicator``, ``media_embeds`` and ``media_mask`` are this rank's
    rows under the encoder's layout and the text leaves its rows under the
    LLM's."""
    ctx = ctx or FwdCtx(mode="train")
    media = encode_media(params, mcfg, batch["media_embeds"],
                         batch.get("media_mask"), ctx=enc_ctx or ctx,
                         communicator=communicator)
    if ctx.hidden_constrain is not None:
        # rows over the LLM's batch axes (DTensor would otherwise keep the
        # connector's FSDP-sharded output dim and move the activations)
        media = ctx.hidden_constrain(media)
    llm_cfg = mcfg.llm
    compute_dtype = torch_dtype(llm_cfg.dtype)
    text_emb = embed_lib.encode(params["llm"]["embed"], batch["text_tokens"],
                                compute_dtype)
    x = torch.cat([media.to(compute_dtype), text_emb], dim=1)
    B, T_m = media.shape[0], media.shape[1]
    T_t = text_emb.shape[1]
    positions = model_lib.default_positions(x)
    seg = None
    if "media_mask" in batch and "text_mask" in batch:
        # media is segment 1; text is 1 where text_mask is set, else 0, so
        # padding attends padding, as in the reference
        m_seg = torch.ones((B, T_m), dtype=torch.int32, device=x.device)
        t_seg = (batch["text_mask"] > 0).to(torch.int32)
        seg = torch.cat([m_seg, t_seg], dim=1)
    logits, _, aux = model_lib.forward(params["llm"], llm_cfg, embeds=x,
                                       positions=positions, segment_ids=seg,
                                       ctx=ctx)
    return logits[:, T_m:], aux
