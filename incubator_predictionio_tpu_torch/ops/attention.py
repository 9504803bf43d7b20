"""Attention for the sequence engine, in plain PyTorch on BSHD tensors.

Port of incubator_predictionio_tpu/ops/attention.py:

- :func:`dot_product_attention` — dense softmax(QKᵀ)V, the short-sequence
  route (``q_offset``/``kv_offset`` keep the masking rule of a shard);
- :func:`blockwise_attention` — online softmax over KV blocks: O(S·block)
  memory, the route between 1,024 and ``transformer.FLASH_MIN_SEQ``, the
  plain version of the flash kernel (``ops/attention_kernels.py``) and its
  backward.

All functions take [batch, seq, heads, head_dim] tensors. Scores and the
softmax state are f32 whatever the input dtype (the JAX package's
``preferred_element_type=jnp.float32``).
"""

from __future__ import annotations

from typing import Optional

import torch

#: score at a masked position: large and negative instead of -inf, so a
#: fully masked row exps to exactly 0 without NaNs from (-inf) - (-inf)
MASK_VALUE = -1e30


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def _combine_masks(causal: bool, q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   kv_valid: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """Broadcastable [B|1, 1, Q, K] boolean mask, or None if unmasked.
    ``kv_valid`` is a per-key padding mask, [K] or [B, K]."""
    mask = None
    if causal:
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
    if kv_valid is not None:
        vm = kv_valid if kv_valid.dim() == 2 else kv_valid[None]
        vm = vm.bool()[:, None, None, :]
        mask = vm if mask is None else (mask & vm)
    return mask


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None,
                          q_offset: int = 0, kv_offset: int = 0,
                          kv_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Dense softmax(QKᵀ)V on [B, S, H, D] inputs. Fully masked rows give
    0, not a uniform softmax."""
    s = _scale(q, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
    mask = _combine_masks(causal, q_pos, kv_pos, kv_valid)
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_VALUE)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = (p / torch.where(l == 0.0, torch.ones_like(l), l)).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _online_block(q, k_blk, v_blk, m, l, o, scale, causal, q_pos, kv_pos,
                  kv_valid=None):
    """One online-softmax step against one KV block; carries (m, l, o) =
    running row max, normaliser and unnormalised output, in f32 (the flash
    kernel's update rule, ``csrc/flash_attention.cu``)."""
    s_blk = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    mask = _combine_masks(causal, q_pos, kv_pos, kv_valid)
    if mask is not None:
        s_blk = s_blk.masked_fill(~mask, MASK_VALUE)
    # m_new is finite (masked scores are MASK_VALUE); the first block's
    # m = -inf makes its correction exp(-inf - m_new) = 0
    m_new = torch.maximum(m, s_blk.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s_blk - m_new[..., None])
    if mask is not None:
        # a fully masked block adds no mass (exp(MASK - MASK) would be 1)
        p = p.masked_fill(~mask, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
    return m_new, l_new, o_new


def _finalize(m, l, o, dtype):
    """Fully masked rows (l == 0) give 0, not NaN."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe[..., None]).permute(0, 2, 1, 3).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_size: int = 512,
                        scale: Optional[float] = None,
                        kv_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Online-softmax attention over KV blocks ([B, S, H, D] in and out).
    A ragged tail is padded and folded into the per-key validity mask."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    blk = min(block_size, s_kv)
    n_blocks = -(-s_kv // blk)
    pad = n_blocks * blk - s_kv
    valid = None
    if pad or kv_valid is not None:
        if kv_valid is None:
            valid = torch.ones((1, s_kv), dtype=torch.bool, device=q.device)
        else:
            valid = (kv_valid if kv_valid.dim() == 2
                     else kv_valid[None]).bool()
        valid = torch.nn.functional.pad(valid, (0, pad))   # pads with False
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    sc = _scale(q, scale)
    q_pos = torch.arange(s_q, device=q.device)
    m = torch.full((b, h, s_q), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s_q), device=q.device)
    o = torch.zeros((b, h, s_q, d), device=q.device)
    for i in range(n_blocks):
        sl = slice(i * blk, (i + 1) * blk)
        kv_pos = torch.arange(i * blk, (i + 1) * blk, device=q.device)
        m, l, o = _online_block(
            q, k[:, sl], v[:, sl], m, l, o, sc, causal, q_pos, kv_pos,
            kv_valid=None if valid is None else valid[:, sl])
    return _finalize(m, l, o, q.dtype)
