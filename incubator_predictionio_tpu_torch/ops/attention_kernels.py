"""Hand-written flash-attention kernel of the sequence engine, with its plain
version and its gradient.

:func:`flash_attention` replaces ``flash_attention``
(incubator_predictionio_tpu/ops/pallas_kernels.py:582 → ``_flash_with_vjp``
:483 → ``_flash_bhsd`` :425, body ``_flash_kernel`` :350): forward
attention on BSHD tensors with online softmax, a per-key validity mask, an
optional causal mask, and 0 for a query with no live key. The kernel is
``csrc/flash_attention.cu`` (tensor-core products, 3xTF32 for f32; key
tiles in the causal future or with no valid key are skipped), whose note
says what bounds it on the card and what its design does about that. It
takes any head width and any batch × heads, as the TPU kernel, which pads
only S: heads of 129–256 take the same design with Q read from shared
memory per step (``flash_wide_kernel``), heads wider than 256 a simpler
D-tiled kernel of the same source.

The JAX custom VJP becomes a ``torch.autograd.Function``: the forward is
the kernel (CUDA tensors) or :func:`flash_attention_plain` (CPU tensors);
the backward recomputes through the plain :func:`blockwise_attention`
under autograd and returns its gradients, with none for the validity mask
(pallas_kernels.py:516-525). There is no backward kernel, as there is no
backward Pallas kernel.

The TPU's per-length block table (``PIO_FLASH_BLOCKS``, pallas_kernels.py:
532-541) is not carried: the kernel's tiles are fixed by its design, and
``q_block`` / ``kv_block`` only set the block of the plain version and of
the backward (``kv_block``; ``q_block`` is accepted for the JAX signature).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops.attention import blockwise_attention

#: the TPU kernel this module's kernel replaces
REPLACES = "incubator_predictionio_tpu/ops/pallas_kernels.py:350"
#: block of the plain version and of the backward recompute
DEFAULT_KV_BLOCK = 512

FLASH_LAUNCHES = runtime.LaunchCounter("flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SAME_DEVICE = contextlib.nullcontext()


def _valid_f32(kv_valid: Optional[torch.Tensor], b: int, s_kv: int,
               device) -> torch.Tensor:
    """The [B, Skv] f32 validity the kernel reads (JAX's ``valid``)."""
    if kv_valid is None:
        return torch.ones((b, s_kv), dtype=torch.float32, device=device)
    if kv_valid.dim() == 1:
        return kv_valid.float()[None, :].expand(b, s_kv).contiguous()
    return kv_valid.float().contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None,
                          kv_valid: Optional[torch.Tensor] = None,
                          q_block: Optional[int] = None,
                          kv_block: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`flash_attention`: the blockwise online
    softmax (the kernel's own update rule) over ``kv_block`` keys at a
    time, differentiable by autograd. Not the dense product: at 32k keys
    and 8 heads its [1, 8, S, S] f32 logits would take 34 GB."""
    del q_block  # one query block: the update rule is per query row
    return blockwise_attention(q, k, v, causal=causal,
                               block_size=kv_block or DEFAULT_KV_BLOCK,
                               scale=scale, kv_valid=kv_valid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    q_block: Optional[int] = None,
                    kv_block: Optional[int] = None) -> torch.Tensor:
    """Fused attention on [B, S, H, D] tensors (f32 or bf16; out in q's
    dtype), with ``kv_valid`` ([S] or [B, S], bool or float > 0) masking
    keys. CUDA tensors launch the kernel or raise; CPU tensors take
    :func:`flash_attention_plain`. Differentiable in q, k and v."""
    b, _s_q, _h, d = q.shape
    s_kv = k.shape[1]
    sc = float(scale) if scale is not None else d ** -0.5
    valid = _valid_f32(kv_valid, b, s_kv, q.device)
    kb = int(kv_block or DEFAULT_KV_BLOCK)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, valid, bool(causal), sc, kb)
    # no gradient to record (serving): the forward without the Function
    return _forward(q, k, v, valid, bool(causal), sc, kb)


def _forward(q, k, v, valid, causal: bool, scale: float, kv_block: int):
    """The kernel, or the plain version when every tensor is on the CPU."""
    if all(t.device.type == "cpu" for t in (q, k, v, valid)):
        return blockwise_attention(q, k, v, causal=causal,
                                   block_size=kv_block, scale=scale,
                                   kv_valid=valid > 0.0)
    return _launch(q, k, v, valid, causal, scale)


class _Flash(torch.autograd.Function):
    """Forward: :func:`_forward`; backward: the gradients of the plain
    blockwise version, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal, scale, kv_block):
        ctx.save_for_backward(q, k, v, valid)
        ctx.causal, ctx.scale, ctx.kv_block = causal, scale, kv_block
        return _forward(q, k, v, valid, causal, scale, kv_block)

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid = ctx.saved_tensors
        with torch.enable_grad():
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = blockwise_attention(qr, kr, vr, causal=ctx.causal,
                                      block_size=ctx.kv_block,
                                      scale=ctx.scale, kv_valid=valid > 0.0)
            dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), g)
        return dq, dk, dv, None, None, None, None


def _launch(q, k, v, valid, causal: bool, scale: float) -> torch.Tensor:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev \
            or valid.device != dev:
        raise ValueError("flash_attention: q, k, v and kv_valid must lie on "
                         f"one CUDA device (got {q.device}, {k.device}, "
                         f"{v.device}, {valid.device})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k and v all float32 or all "
                        f"bfloat16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not BSHD q, k, v")
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if valid.shape != (b, s_kv) or valid.dtype != torch.float32:
        raise ValueError(f"kv_valid must be [{b}, {s_kv}] f32")
    if q.stride(-1) != 1:
        q = q.contiguous()
    if k.stride(-1) != 1:
        k = k.contiguous()
    if v.stride(-1) != 1:
        v = v.contiguous()
    valid = valid.contiguous()
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=dev)
    if s_q == 0:
        return out
    lib = runtime.build_kernels()
    # the launch goes to the current device: switch only when q is elsewhere
    on_dev = (_SAME_DEVICE if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev))
    with on_dev:
        # the kernel's tile bitmasks, and f32 partials when a query tile's
        # key tiles are cut into chunks (see its Tiles and Split)
        nbytes = _workspace_bytes(lib, b, h, s_q, s_kv, d, dev.index)
        work = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                if nbytes else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), b, h, s_q, s_kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), scale, _DTYPES[q.dtype],
            None if work is None else work.data_ptr(), stream)
    runtime.check_launch(rc, "flash_attention")
    FLASH_LAUNCHES.add()
    return out


@functools.lru_cache(maxsize=256)
def _workspace_bytes(lib, b: int, h: int, s_q: int, s_kv: int, d: int,
                     device_index) -> int:
    """The kernel's scratch for these sizes on this device (its plan
    depends on the device's SM count), asked once per shape."""
    del device_index  # a key only: the call runs on the current device
    return lib.pio_flash_workspace_bytes(b, h, s_q, s_kv, d)


def live_pairs(s_q: int, valid: torch.Tensor, causal: bool) -> int:
    """Live (query, key) pairs summed over the batch: key j of row b is
    seen by every query if not causal, by the ``s_q - j`` queries at or
    after it if causal (positions from 0 for both)."""
    v = (valid > 0).to(torch.float64)
    if not causal:
        return int(round(float(v.sum()) * s_q))
    seen = (s_q - torch.arange(v.shape[1], dtype=torch.float64,
                               device=v.device)).clamp(min=0)
    return int(round(float((v * seen).sum())))


def flash_bound(b: int, h: int, s_q: int, s_kv: int, d: int, dtype,
                pairs: int) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one forward call. Bytes: q, k, v and the f32 validity read once,
    the output written once. Operations: 4·D per live (query, key) pair
    and head (QKᵀ and PV, a multiply and an add each), ``pairs`` summed
    over the batch (:func:`live_pairs`), at the bf16 tensor-core peak for
    bf16 inputs and, for f32, at a third of the TF32 peak: an f32-accurate
    product on the tensor cores takes three TF32 products (3xTF32)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * s_q * h * d + 2 * b * s_kv * h * d) \
        + 4 * b * s_kv
    peak = (runtime.BF16_FLOPS if dtype == torch.bfloat16
            else runtime.F32_3XTF32_FLOPS)
    t_bytes = nbytes / runtime.HBM_BYTES_PER_S
    t_ops = 4.0 * d * float(pairs) * h / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
