"""Causal transformer for next-item prediction (the sequence engine).

Port of incubator_predictionio_tpu/ops/transformer.py: a SASRec-style
self-attentive session model. The weights keep the JAX field names and the
stacked per-layer layout (leading axis = layer), so ``convert`` carries them
across field by field; the layer scan is a Python loop over that axis, and
the fit loop (the JAX package's nested ``lax.scan``) a loop of optimizer
steps over the same pre-batched [steps, B, L] tensor.

Attention is pluggable (``attn_fn``); the default routes by length as the
JAX package does: dense up to 1,024, the blockwise scan below
``FLASH_MIN_SEQ`` (8,192, a TPU measurement kept until the H100's
crossover is decided), the flash kernel (``ops/attention_kernels.py``)
from there up.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from incubator_predictionio_tpu_torch.ops.attention import (
    blockwise_attention,
    dot_product_attention,
)
from incubator_predictionio_tpu_torch.ops.attention_kernels import (
    flash_attention,
)
from incubator_predictionio_tpu_torch.runtime import default_device

logger = logging.getLogger(__name__)

#: attention callable: (q, k, v, causal=, kv_valid=) -> out, all [B, S, H, Dh]
AttnFn = Callable[..., torch.Tensor]

PAD = 0  # padding token; real items are 1..n_items


@dataclasses.dataclass
class TransformerWeights:
    item_emb: torch.Tensor    # [V, D]  (tied output projection)
    pos_emb: torch.Tensor     # [L, D]
    # stacked per-layer weights, leading axis = layer
    ln1_scale: torch.Tensor   # [N, D]
    ln2_scale: torch.Tensor   # [N, D]
    wq: torch.Tensor          # [N, D, D]
    wk: torch.Tensor          # [N, D, D]
    wv: torch.Tensor          # [N, D, D]
    wo: torch.Tensor          # [N, D, D]
    w_up: torch.Tensor        # [N, D, 4D]
    w_down: torch.Tensor      # [N, 4D, D]
    lnf_scale: torch.Tensor   # [D]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "TransformerWeights":
        return TransformerWeights(**{f.name: fn(getattr(self, f.name))
                                     for f in dataclasses.fields(self)})


def transformer_init(gen: torch.Generator, n_items: int, max_len: int,
                     d_model: int = 64, n_layers: int = 2, device=None
                     ) -> TransformerWeights:
    """Weights drawn as the JAX package draws them (normal × scale; unit
    norm scales), from ``gen`` on the CPU, then moved to ``device`` (CUDA
    by default). The numbers differ from JAX's for the same seed."""
    dev = default_device(device)
    v, d, h = n_items + 1, d_model, 4 * d_model   # + PAD

    def init(shape, scale):
        return torch.randn(shape, generator=gen) * scale

    w = TransformerWeights(
        item_emb=init((v, d), d ** -0.5),
        pos_emb=init((max_len, d), 0.02),
        ln1_scale=torch.ones((n_layers, d)),
        ln2_scale=torch.ones((n_layers, d)),
        wq=init((n_layers, d, d), d ** -0.5),
        wk=init((n_layers, d, d), d ** -0.5),
        wv=init((n_layers, d, d), d ** -0.5),
        wo=init((n_layers, d, d), d ** -0.5),
        w_up=init((n_layers, d, h), d ** -0.5),
        w_down=init((n_layers, h, d), h ** -0.5),
        lnf_scale=torch.ones((d,)),
    )
    return w.map(lambda t: t.to(dev))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def _flash_min_seq() -> int:
    """``PIO_FLASH_MIN_SEQ`` or 8,192: the JAX package's crossover, measured
    on a TPU v5e. The H100's is measured by ``chip_smoke.py`` (report
    phase) and not acted on yet."""
    raw = os.environ.get("PIO_FLASH_MIN_SEQ", "")
    try:
        return int(raw) if raw.strip() else 8192
    except ValueError:
        logger.warning("ignoring malformed PIO_FLASH_MIN_SEQ=%r; using 8192",
                       raw)
        return 8192


#: sequence length from which (inclusive) the flash kernel serves
FLASH_MIN_SEQ = _flash_min_seq()


def _default_attn(q, k, v, causal=True, kv_valid=None):
    if FLASH_MIN_SEQ <= q.shape[1]:
        return flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    if q.shape[1] > 1024:
        return blockwise_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    return dot_product_attention(q, k, v, causal=causal, kv_valid=kv_valid)


def transformer_apply(w: TransformerWeights, tokens: torch.Tensor,
                      n_heads: int, attn_fn: Optional[AttnFn] = None
                      ) -> torch.Tensor:
    """Hidden states [B, L, D] after the final norm; ``tokens`` [B, L]
    int, PAD-padded."""
    attn = attn_fn or _default_attn
    b, l = tokens.shape
    d = w.item_emb.shape[1]
    dh = d // n_heads
    x = w.item_emb[tokens] + w.pos_emb[:l]
    # padding keys are masked out of every attention softmax
    kv_valid = tokens != PAD
    for i in range(w.wq.shape[0]):
        h = _rms_norm(x, w.ln1_scale[i])
        q = (h @ w.wq[i]).reshape(b, l, n_heads, dh)
        k = (h @ w.wk[i]).reshape(b, l, n_heads, dh)
        v = (h @ w.wv[i]).reshape(b, l, n_heads, dh)
        o = attn(q, k, v, causal=True, kv_valid=kv_valid).reshape(b, l, d)
        x = x + o @ w.wo[i]
        h = _rms_norm(x, w.ln2_scale[i])
        # jax.nn.gelu is the tanh approximation by default
        x = x + F.gelu(h @ w.w_up[i], approximate="tanh") @ w.w_down[i]
    return _rms_norm(x, w.lnf_scale)


def next_item_logits(w: TransformerWeights, tokens: torch.Tensor,
                     n_heads: int, attn_fn: Optional[AttnFn] = None
                     ) -> torch.Tensor:
    """[B, L, V] logits with the output projection tied to item_emb."""
    return transformer_apply(w, tokens, n_heads, attn_fn) @ w.item_emb.T


def _masked_ce(w: TransformerWeights, batch: torch.Tensor, n_heads: int,
               attn_fn: Optional[AttnFn]) -> torch.Tensor:
    """Mean next-item cross-entropy over positions whose input and target
    are both real items."""
    logits = next_item_logits(w, batch[:, :-1], n_heads, attn_fn)
    targets = batch[:, 1:]
    mask = (targets != PAD) & (batch[:, :-1] != PAD)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1).long(), reduction="none")
    maskf = mask.reshape(-1).float()
    return (ce * maskf).sum() / maskf.sum().clamp(min=1.0)


def _fit_loop(w: TransformerWeights, batches: torch.Tensor, n_heads: int,
              learning_rate: float, epochs: int,
              attn_fn: Optional[AttnFn] = None
              ) -> Tuple[TransformerWeights, np.ndarray]:
    """``epochs`` passes of AdamW steps over ``batches`` [steps, B, L]; the
    weights are updated in place. Returns the weights and the loss of every
    step, [epochs, steps]. ``optax.adamw(lr)``'s defaults: β 0.9/0.999,
    ε 1e-8, decoupled weight decay 1e-4 on every parameter (torch's AdamW
    defaults to 1e-2)."""
    params = [getattr(w, f.name).requires_grad_(True)
              for f in dataclasses.fields(w)]
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    losses = torch.zeros((epochs, batches.shape[0]), dtype=torch.float32,
                         device=batches.device)
    for e in range(epochs):
        for s in range(batches.shape[0]):
            opt.zero_grad(set_to_none=True)
            loss = _masked_ce(w, batches[s], n_heads, attn_fn)
            loss.backward()
            opt.step()
            losses[e, s] = loss.detach()
    for t in params:
        t.requires_grad_(False)
    return w, losses.cpu().numpy()


def sasrec_fit(sequences: np.ndarray, n_items: int, d_model: int = 64,
               n_heads: int = 2, n_layers: int = 2, epochs: int = 20,
               batch_size: int = 128, learning_rate: float = 1e-3,
               seed: int = 0, attn_fn: Optional[AttnFn] = None,
               device=None, stats: Optional[Dict[str, object]] = None
               ) -> Tuple[TransformerWeights, np.ndarray]:
    """Train on next-item prediction; returns (weights, per-epoch mean loss).

    ``sequences`` [N, L] int, PAD-padded, items 1..n_items. The rows are
    padded with PAD-only rows to whole batches and shuffled by
    ``np.random.default_rng(seed)``, as the JAX package does; the initial
    weights are ``transformer_init`` from ``seed`` (a torch generator, so
    not JAX's numbers). ``stats`` receives ``step_losses`` [epochs,
    steps]."""
    dev = default_device(device)
    seqs = np.asarray(sequences, np.int32)
    n, max_len = seqs.shape
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
    w = transformer_init(torch.Generator().manual_seed(seed), n_items,
                         max_len, d_model, n_layers, device=dev)
    bs = min(batch_size, n)
    steps = -(-n // bs)
    pad_rows = steps * bs - n
    if pad_rows:
        seqs = np.concatenate([seqs, np.zeros((pad_rows, max_len), np.int32)])
    rng = np.random.default_rng(seed)
    seqs = seqs[rng.permutation(len(seqs))]
    batches = torch.from_numpy(seqs.reshape(steps, bs, max_len)).to(dev)
    w, step_losses = _fit_loop(w, batches, n_heads, learning_rate, epochs,
                               attn_fn)
    if stats is not None:
        stats["step_losses"] = step_losses
    return w, step_losses.mean(axis=1)


def sasrec_topk(w: TransformerWeights, tokens: torch.Tensor, n_heads: int,
                k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k next items from the last position's hidden state: (scores
    [B, k], item ids [B, k]). PAD and every history token score -inf; ties
    go to the lowest id, as ``lax.top_k`` breaks them."""
    with torch.no_grad():
        last = transformer_apply(w, tokens, n_heads)[:, -1]
        scores = last @ w.item_emb.T                      # [B, V]
        # PAD is among the history columns of a padded window; set it too
        scores = scores.scatter(1, tokens.long(), float("-inf"))
        scores[:, PAD] = float("-inf")
        top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
        return top_s[:, :k], top_i[:, :k]
