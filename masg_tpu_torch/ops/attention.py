"""Scaled dot-product multi-head attention (port of masg_tpu/ops/attention.py).

- `mha_attention`: the plain path, an additive `finfo.min` key mask with f32
  (or f64) accumulation, as masg_tpu's XLA path.
- `flash_attention`: masked attention through the flash kernels, differentiable.
  Its forward is kernel K1 (`csrc/flash_fwd.cu`, replacing the Pallas
  `_flash_kernel`); its backward, a `torch.autograd.Function` that mirrors
  masg_tpu's `_make_flash_core` custom VJP, runs kernels K2 (`flash_attention_dq`)
  and K3 (`flash_attention_dkv`, both `csrc/flash_bwd.cu`, replacing
  `_flash_dq_kernel` and `_flash_dkv_kernel`) on K1's saved row log-sum-exp.
  In bf16 all three run every product on the tensor cores (`mma.sync`; K2
  and K3 round p and ds to bf16 only as product operands, sums stay f32);
  in f32 they are SIMT kernels on the CUDA cores, which keep masg_tpu's bars.
  On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
  it runs its `*_plain` version, the same function in plain PyTorch.

The flash semantics differ from `mha_attention` only at rows that see no
valid key (length 0): flash gives 0 and LSE -inf, where the additive mask
gives the mean of v. The backward holds masg_tpu's contract: the cotangent is
zero at query rows >= length (the model masks them after every FFT block), so
their contributions to dK/dV are dropped and dQ there is don't-care.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from . import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_DH = (16, 32, 64, 128)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention core on (B, H, T, Dh); pad_mask (B, T) True at padded keys.

    Accumulates in f32 (f64 stays f64) whatever autocast is on, as masg_tpu's
    einsums with `preferred_element_type`."""
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask[:, None, None, :], torch.finfo(acc).min)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs.to(v.dtype).to(acc), v.to(acc))
    return out.to(v.dtype)


def _key_valid(lengths: torch.Tensor, t: int, device) -> torch.Tensor:
    """(B, T) True at positions < lengths[b]."""
    return torch.arange(t, device=device)[None, :] < lengths.to(device)[:, None]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: (o (B, H, T, Dh), lse (B, H, T)).

    Keys at or past lengths[b] are masked with -inf; a row with no valid key
    gives o = 0 and lse = -inf. Computes in f32 (f64 stays f64); lse is f32
    (f64 for f64 inputs).
    """
    acc = _acc_dtype(q.dtype)
    t = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.to(acc) * scale, k.to(acc).transpose(-1, -2))
    s = s.masked_fill(~_key_valid(lengths, t, q.device)[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)  # exp(-inf) = 0 at masked keys
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.to(acc)) / torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l > 0, m_safe + torch.log(l), torch.full_like(l, float("-inf")))
    return o.to(q.dtype), lse[..., 0]


def _recompute_p(q, k, lse, lengths, acc, query_rows_only: bool):
    """p = exp(scale q k^T - lse) with 0 at keys >= len, at dead rows (lse =
    -inf) and, with `query_rows_only`, at query rows >= len."""
    t = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = scale * torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    lse = lse.to(acc)
    live = torch.isfinite(lse)
    valid = _key_valid(lengths, t, q.device)
    on = valid[:, None, None, :] & live[..., None]
    if query_rows_only:
        on = on & valid[:, None, :, None]
    p = torch.exp(s - torch.where(live, lse, torch.zeros_like(lse))[..., None])
    return torch.where(on, p, torch.zeros_like(p)), scale


def flash_attention_dq_plain(q, k, v, do, lse, delta, lengths) -> torch.Tensor:
    """K2's function in plain PyTorch: dQ = scale * [p * (do v^T - delta)] k.

    q, k, v, do (B, H, T, Dh); lse, delta (B, H, T). Computes in f32 (f64
    stays f64); returns q's dtype.
    """
    acc = _acc_dtype(q.dtype)
    p, scale = _recompute_p(q, k, lse, lengths, acc, query_rows_only=False)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = p * (dp - delta.to(acc)[..., None])
    return (scale * torch.matmul(ds, k.to(acc))).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, lengths
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: dV = p^T do and
    dK = scale * [p * (do v^T - delta)]^T q over query rows < len.

    Returns (dk, dv) in k's and v's dtype; zero at keys >= len.
    """
    acc = _acc_dtype(q.dtype)
    p, scale = _recompute_p(q, k, lse, lengths, acc, query_rows_only=True)
    do_a = do.to(acc)
    dp = torch.matmul(do_a, v.to(acc).transpose(-1, -2))
    ds = p * (dp - delta.to(acc)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do_a)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(what: str, tensors, lengths: torch.Tensor) -> None:
    """Raise unless the (B, H, T, Dh) tensors suit the CUDA kernels."""
    q = tensors[0]
    if any(x.dtype != q.dtype for x in tensors) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16 tensors of one dtype, got "
                        f"{[x.dtype for x in tensors]}")
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{what}: tensors must share a (B, H, T, Dh) shape, got "
                         f"{[tuple(x.shape) for x in tensors]}")
    if q.shape[-1] not in _KERNEL_DH:
        raise ValueError(f"{what} kernel takes Dh in {_KERNEL_DH}, got {q.shape[-1]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{what}: tensors must lie on one device")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths must be ({q.shape[0]},), got {tuple(lengths.shape)}")


def _check_stats(what: str, q: torch.Tensor, *stats: torch.Tensor) -> None:
    """Raise unless each row statistic is a contiguous (B, H, T) f32 tensor."""
    for x in stats:
        if (x.dtype != torch.float32 or x.shape != q.shape[:3] or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"{what}: lse and delta must be contiguous (B, H, T) float32 "
                             f"on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _lens_i32(lengths: torch.Tensor, device) -> torch.Tensor:
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _flash_fwd(q, k, v, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, `flash_attention_plain` on CPU tensors."""
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, lengths)
    _check_kernel_args("flash_attention", (q, k, v), lengths)
    b, h, t, dh = q.shape
    lens = _lens_i32(lengths, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.masg_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  lens.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                  b * h, h, t, dh, _KERNEL_DTYPES[q.dtype], stream)
    _build.check(code, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, lengths) -> torch.Tensor:
    """dQ of flash attention: kernel K2 on CUDA tensors (f32 or bf16,
    contiguous, Dh in 16/32/64/128; lse and delta (B, H, T) f32), the plain
    version on CPU tensors."""
    if q.device.type != "cuda":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, lengths)
    _check_kernel_args("flash_attention_dq", (q, k, v, do), lengths)
    _check_stats("flash_attention_dq", q, lse, delta)
    b, h, t, dh = q.shape
    lens = _lens_i32(lengths, q.device)
    dq = torch.empty_like(q)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.masg_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                     lens.data_ptr(), dq.data_ptr(), b * h, h, t, dh,
                                     _KERNEL_DTYPES[q.dtype], stream)
    _build.check(code, "flash_bwd_dq")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, lengths
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention: kernel K3 on CUDA tensors (as
    `flash_attention_dq` takes them), the plain version on CPU tensors."""
    if q.device.type != "cuda":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, lengths)
    _check_kernel_args("flash_attention_dkv", (q, k, v, do), lengths)
    _check_stats("flash_attention_dkv", q, lse, delta)
    b, h, t, dh = q.shape
    lens = _lens_i32(lengths, q.device)
    # every element is written by the kernel (zeros at keys >= len)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.masg_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                      lens.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                      b * h, h, t, dh, _KERNEL_DTYPES[q.dtype], stream)
    _build.check(code, "flash_bwd_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (masg_tpu's `_make_flash_core`).

    Autocast is off inside both directions: q, k, v keep the dtype they
    arrive in (bf16 out of an autocast Linear), and the gradients come back
    in those dtypes.
    """

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        with torch.autocast(q.device.type, enabled=False):
            o, lse = _flash_fwd(q, k, v, lengths)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            acc = _acc_dtype(q.dtype)
            # delta from do and o in f32 (f64 stays f64), then do in q's dtype,
            # the order of masg_tpu's core_bwd
            delta = (do.to(acc) * o.to(acc)).sum(-1)
            do = do.to(q.dtype).contiguous()
            dq = flash_attention_dq(q, k, v, do, lse, delta, lengths)
            dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, lengths)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Masked attention on (B, H, T, Dh) with (B,) key lengths, differentiable
    in q, k and v.

    CUDA tensors launch kernel K1, and K2/K3 in the backward (f32 or bf16,
    contiguous, Dh in 16/32/64/128); CPU tensors run the plain versions.
    Returns o, or (o, lse) with lse (B, H, T) f32 (no gradient) when
    `return_lse`.
    """
    o, lse = _FlashAttention.apply(q, k, v, lengths)
    return (o, lse) if return_lse else o


flash_attention.launches = 0  # K1 launches since the last reset
flash_attention_dq.launches = 0  # K2 launches since the last reset
flash_attention_dkv.launches = 0  # K3 launches since the last reset
