"""Model API facade for training (port of ``repro/models/api.py``): the
loss functions, parameter init, the train batch schema and synthetic
batches, for BERT (the encoder) and the dense decoder LMs.

The reference's ``ShapeDtypeStruct`` schema becomes ``BatchField`` (shape
and numpy dtype); synthetic batches are drawn with numpy from a seed and
moved to the device by ``to_device``.  Decoder training covers every
layer the port runs (``transformer.check_supported``): dense attention
(full, sliding-window local and global; grouped-query heads, QKV biases,
post-block norms, softcaps, tied and scaled embeddings, GeGLU), RWKV-6,
mamba (the hybrid jamba; its selective scan's backward is
``mamba._SelectiveScan``) and Mixture-of-Experts MLPs, whose loss adds the
router's aux loss as the reference's does (``lm_train_loss``; each
block's last pattern position, ``transformer.apply_lm``; ``moe_impl``
picks the expert path), and the encoder-decoder whisper-small, whose
batches carry ``frames`` (B, enc_seq, d_model) float32, the stub front
end's frame embeddings, which ``lm_train_loss`` hands to the encoder,
and the vision-language qwen2-vl-7b, whose batches carry ``vision`` (B,
n_vision_tokens, d_model) float32, the stub vision tower's patch
embeddings, which overwrite the first n_vision_tokens positions of the
inputs (M-RoPE at ``arange`` on its three axes, as the reference's).
The serving and sharding structs belong to later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import bert as BERT
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class BatchField:
    shape: Tuple[int, ...]
    dtype: type = np.int32


def mlm_positions_count(seq_len: int) -> int:
    """Paper Table 6: 20 predictions at S=128, 80 at S=512 (~15%)."""
    return max(1, int(round(seq_len * 0.15)) + (0 if seq_len % 8 else 0))


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a model the port does not train
    yet, naming the slice it waits for: an encoder-only model is BERT; a
    decoder, an encoder-decoder or a vision-language model must be one
    ``transformer.check_supported`` runs."""
    if cfg.is_encoder_only:
        return
    T.check_supported(cfg)


class _MeanNLL(torch.autograd.Function):
    """The mean NLL of ``labels`` under fp32 ``logits`` (..., V): the
    forward is ``log_softmax``, the gather and the mean; the backward
    writes (softmax(logits) - one-hot(labels)) x g / N into one new
    tensor.  Autograd through those three ops would hold the
    log-probabilities and, in the backward, the gather's dense gradient,
    an exponent and the result at once: four logits-sized tensors, 8.4 GB
    each for gemma2's 256000-wide vocabulary at S 8192.  Here the saved
    logits and the gradient are two."""

    @staticmethod
    def forward(ctx, logits, labels):
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels)
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        grad = torch.softmax(logits, dim=-1)
        grad.scatter_add_(-1, labels[..., None], torch.full(
            labels[..., None].shape, -1.0, dtype=grad.dtype,
            device=grad.device))
        return grad.mul_(g / labels.numel()), None


def lm_train_loss(params, batch, cfg: ModelConfig, policy: Policy, *,
                  moe_impl: str = "a2a", remat: bool = False,
                  aux_coef=None, impl=None):
    """Next-token cross-entropy of a decoder (the reference's
    ``lm_train_loss``): inputs ``tokens[:, :-1]``, labels ``tokens[:, 1:]``,
    ``log_softmax`` of the logits in fp32, the mean NLL (``_MeanNLL``);
    an MoE model adds ``aux_coef`` (default ``cfg.router_aux_coef``) times
    the router's aux loss, that of each block's last pattern position
    summed over the blocks (``transformer.apply_lm``); an encoder-decoder
    runs its encoder over ``batch["frames"]``; a vision model's
    ``batch["vision"]`` overwrites the first n_vision_tokens input
    embeddings (the labels stay the next tokens at every position, the
    overwritten ones included, as the reference's).  Returns (loss,
    {"lm_loss", "router_aux"}), 0-d float32 tensors; ``router_aux`` is 0
    for a model without MoE layers."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:].long()
    frames = batch["frames"] if cfg.is_encoder_decoder else None
    vision = batch["vision"] if cfg.n_vision_tokens else None
    logits, aux = T.apply_lm(params, inputs, cfg, policy, enc_frames=frames,
                             vision_embeds=vision, remat=remat,
                             moe_impl=moe_impl, return_aux=True, impl=impl)
    nll = _MeanNLL.apply(logits.float(), labels)
    loss = nll
    if cfg.has_moe:
        coef = cfg.router_aux_coef if aux_coef is None else aux_coef
        loss = nll + coef * aux
    return loss, {"lm_loss": nll.detach(), "router_aux": aux.detach()}


def make_loss_fn(cfg: ModelConfig, policy: Policy, *, moe_impl: str = "a2a",
                 remat: bool = False, impl=None):
    """``loss_fn(params, batch) -> (loss, metrics)``: BERT's pretraining
    loss for an encoder-only model, else ``lm_train_loss`` with an MoE
    model's layers on ``moe_impl``."""
    check_trainable(cfg)
    if cfg.is_encoder_only:
        def loss_fn(params, batch):
            return BERT.bert_pretrain_loss(params, batch, cfg, policy,
                                           remat=remat, impl=impl)
    else:
        def loss_fn(params, batch):
            return lm_train_loss(params, batch, cfg, policy,
                                 moe_impl=moe_impl, remat=remat, impl=impl)
    return loss_fn


def init_params(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    check_trainable(cfg)
    if cfg.is_encoder_only:
        return BERT.init_bert(cfg, seed=seed, dtype=dtype, device=device)
    return T.init_model(cfg, seed=seed, dtype=dtype, device=device)


def train_batch_struct(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, BatchField]:
    """BERT: tokens, type ids, MLM positions and labels, NSP labels.  A
    decoder: tokens (B, S + 1), the inputs and the shifted labels; an
    encoder-decoder also its frames (B, enc_seq, d_model) float32, a
    vision model its vision embeddings (B, n_vision_tokens, d_model)
    float32."""
    check_trainable(cfg)
    b, s = shape.global_batch, shape.seq_len
    if not cfg.is_encoder_only:
        out = {"tokens": BatchField((b, s + 1))}
        if cfg.is_encoder_decoder:
            out["frames"] = BatchField((b, cfg.enc_seq, cfg.d_model),
                                       np.float32)
        if cfg.n_vision_tokens:
            out["vision"] = BatchField((b, cfg.n_vision_tokens, cfg.d_model),
                                       np.float32)
        return out
    p = mlm_positions_count(s)
    return {"tokens": BatchField((b, s)), "type_ids": BatchField((b, s)),
            "mlm_positions": BatchField((b, p)),
            "mlm_labels": BatchField((b, p)), "nsp_labels": BatchField((b,))}


def make_synth_batch(seed: int, cfg: ModelConfig, shape: InputShape
                     ) -> Dict[str, np.ndarray]:
    """A random batch with the schema's statistics, as the reference's:
    positions 0 .. P-1, type ids 0, random tokens, labels and NSP labels
    (a decoder's: random tokens; an encoder-decoder's frames and a vision
    model's embeddings 0.1 times a standard normal).  Drawn with numpy (the values differ from
    ``jax.random``'s)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, f in sorted(train_batch_struct(cfg, shape).items()):
        if f.dtype == np.float32:
            out[name] = 0.1 * rng.standard_normal(f.shape)
        elif name == "nsp_labels":
            out[name] = rng.integers(0, 2, f.shape)
        elif name == "mlm_positions":
            out[name] = np.broadcast_to(np.arange(f.shape[-1]), f.shape)
        elif name == "type_ids":
            out[name] = np.zeros(f.shape)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, f.shape)
        out[name] = np.ascontiguousarray(out[name], dtype=f.dtype)
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: integer fields as int64
    (indices for gathers), floating ones (an encoder-decoder's frames, a
    vision model's embeddings) as float32."""
    def one(v):
        v = np.asarray(v)
        dtype = torch.float32 if np.issubdtype(v.dtype, np.floating) \
            else torch.int64
        return torch.from_numpy(v).to(device=device, dtype=dtype)
    return {k: one(v) for k, v in batch.items()}
