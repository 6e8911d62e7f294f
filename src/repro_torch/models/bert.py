"""BERT, the paper's model (port of ``repro/models/bert.py``): the post-LN
encoder with the MLM and NSP heads, and the pretraining loss.

  * token + learned-position + segment (type) embeddings, embed-LayerNorm
  * post-LayerNorm residual blocks: x = LN(x + attn(x)); x = LN(x + mlp(x))
  * GELU in the FFN, bias and activation fused (the paper's §4.3 example)
  * MLM head: dense d -> d, bias + GELU, LN, the tied token embedding as
    decoder, an output bias; NSP head: tanh pooler on [CLS], a 2-way linear

Parameters are a plain dict laid out as the reference's, except that
``"blocks"`` is a list of per-layer dicts where the reference stacks each
leaf over the layers (``bridge.params_from_jax`` converts)::

    {"embed": {"tok" (V, d), "pos" (P, d), "type" (2, d)},
     "embed_norm": {"scale", "bias"},
     "blocks": [{"attn": {"wq" (d,H,Dh), "wk", "wv", "wo" (H,Dh,d)},
                 "attn_norm": {...}, "mlp": {"wi", "bi", "wo", "bo"},
                 "mlp_norm": {...}}, ...],
     "mlm_transform": {"w" (d, d), "b"}, "mlm_norm": {...},
     "mlm_bias" (V,), "pooler": {"w", "b"}, "nsp": {"w" (d, 2), "b"}}

``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` does in
the reference's scan.  The encoder takes no padding mask, as the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init_bert(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
              device="cuda") -> dict:
    """Seeded random weights with the reference's distributions (truncated
    normal, std 0.02, output projections scaled by 1/sqrt(2 n_layers);
    norms at 1 and 0, biases at 0).  The values differ from the
    reference's: ``torch.Generator`` is not ``jax.random``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, **kw)
    normal = lambda *shape: L.trunc_normal(shape, gen, **kw)
    params = {"embed": L.init_embedding(cfg, gen, **kw)}
    params["embed"]["type"] = normal(2, d)
    params["embed_norm"] = L.init_norm(cfg, **kw)
    params["blocks"] = [{"attn": L.init_attention(cfg, gen, **kw),
                         "attn_norm": L.init_norm(cfg, **kw),
                         "mlp": L.init_mlp(cfg, gen, **kw),
                         "mlp_norm": L.init_norm(cfg, **kw)}
                        for _ in range(cfg.n_layers)]
    params["mlm_transform"] = {"w": normal(d, d), "b": zeros(d)}
    params["mlm_norm"] = L.init_norm(cfg, **kw)
    params["mlm_bias"] = zeros(cfg.vocab_size)
    params["pooler"] = {"w": normal(d, d), "b": zeros(d)}
    params["nsp"] = {"w": normal(d, 2), "b": zeros(2)}
    return params


def _block(p, x, cfg: ModelConfig, policy: Policy, impl):
    y, _ = L.apply_attention(p["attn"], x, cfg, policy,
                             mixer_kind="attn_bidir", impl=impl)
    x = L.apply_norm(p["attn_norm"], x + y, cfg, policy, impl=impl)
    y = L.apply_mlp(p["mlp"], x, cfg, policy, impl=impl)
    return L.apply_norm(p["mlp_norm"], x + y, cfg, policy, impl=impl)


def apply_bert(params, tokens, type_ids, cfg: ModelConfig, policy: Policy,
               *, remat: bool = False, impl: Optional[str] = None):
    """tokens, type_ids: (B, S).  Returns (sequence output (B, S, d),
    pooled (B, d))."""
    cd = policy.compute_dtype
    x = L.embed_tokens(params["embed"], tokens, cfg, policy)
    # the segment embedding as a select of its two rows, whose backward is
    # two sums over the positions in a fixed order: F.embedding's CUDA
    # backward gives other bits from call to call for this table (49 of 50
    # calls at phase 1's micro-batch; 0 of 50 for the token table), which
    # made two runs' losses part from the third step
    # (launch/determinism_check.py --probe-embedding)
    seg = params["embed"]["type"]
    x = x + torch.where(type_ids[..., None] == 1, seg[1], seg[0]).to(x.dtype)
    x = L.apply_norm(params["embed_norm"], x, cfg, policy, impl=impl)
    for p in params["blocks"]:
        if remat:
            x = checkpoint(_block, p, x, cfg, policy, impl,
                           use_reentrant=False)
        else:
            x = _block(p, x, cfg, policy, impl)
    pooled = torch.tanh(x[:, 0].to(cd) @ params["pooler"]["w"].to(cd)
                        + params["pooler"]["b"].to(cd))
    return x, pooled


def bert_logits(params, seq_out, cfg: ModelConfig, policy: Policy,
                mlm_positions: Optional[torch.Tensor] = None, *,
                impl: Optional[str] = None):
    """MLM logits, at ``mlm_positions`` (B, P) only when given (the paper's
    Predictions/S: no (B, S, V) logits tensor)."""
    cd = policy.compute_dtype
    h = seq_out
    if mlm_positions is not None:
        idx = mlm_positions.long()[..., None].expand(-1, -1, h.shape[-1])
        h = torch.gather(seq_out, 1, idx)
    h = kops.bias_gelu(h.to(cd) @ params["mlm_transform"]["w"].to(cd),
                       params["mlm_transform"]["b"].to(cd), impl=impl)
    h = L.apply_norm(params["mlm_norm"], h, cfg, policy, impl=impl)
    return (h.to(cd) @ params["embed"]["tok"].to(cd).T
            + params["mlm_bias"].to(cd))


def bert_pretrain_loss(params, batch, cfg: ModelConfig, policy: Policy, *,
                       remat: bool = False, impl: Optional[str] = None):
    """The paper's pretraining objective: masked-LM cross-entropy over the
    predicted positions (labels < 0 ignored) + NSP cross-entropy.

    batch: tokens (B, S), type_ids (B, S), mlm_positions (B, P),
    mlm_labels (B, P) (-100 = unmasked / pad), nsp_labels (B,), integer
    tensors.  Returns (loss, {"mlm_loss", "nsp_loss", "mlm_acc"}), 0-d
    float32 tensors."""
    seq_out, pooled = apply_bert(params, batch["tokens"], batch["type_ids"],
                                 cfg, policy, remat=remat, impl=impl)
    mlm_logits = bert_logits(params, seq_out, cfg, policy,
                             mlm_positions=batch["mlm_positions"], impl=impl)
    labels = batch["mlm_labels"].long()
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(mlm_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    n_valid = torch.clamp(valid.sum(), min=1)
    mlm_loss = torch.sum(nll * valid) / n_valid

    cd = policy.compute_dtype
    nsp_logits = pooled @ params["nsp"]["w"].to(cd) + params["nsp"]["b"].to(cd)
    nsp_logp = F.log_softmax(nsp_logits.float(), dim=-1)
    nsp_loss = -torch.mean(torch.gather(
        nsp_logp, -1, batch["nsp_labels"].long()[:, None])[:, 0])

    loss = mlm_loss + nsp_loss
    mlm_acc = torch.sum((mlm_logits.argmax(-1) == lab) * valid) / n_valid
    return loss, {"mlm_loss": mlm_loss.detach(),
                  "nsp_loss": nsp_loss.detach(),
                  "mlm_acc": mlm_acc.float()}
