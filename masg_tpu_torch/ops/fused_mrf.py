"""Fused HiFi-GAN MRF stage (port of masg_tpu/ops/fused_mrf.py).

`fused_mrf_stage` is the wrapper of kernel K4, `csrc/fused_mrf.cu`, which
replaces the Pallas kernel `_mrf_kernel`: one launch runs a whole
narrow-channel stage (3 resblocks x 3 dilation units x 2 convs, the
residuals, the leaky-relus and the mean). On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs `fused_mrf_stage_plain`, the same
function as per-conv `F.conv1d` calls with each conv's own zero padding.

`block_params[j]` is resblock j's dict in masg_tpu's layout:
`convs{1,2}_{i}_kernel` (k, C_in, C_out) and `convs{1,2}_{i}_bias` (C,).
x and the result are channel-last (B, T, C). Inference only. The kernel
takes them packed (`pack_stage_weights`: rounded to the working dtype, in
the tensor cores' fragment order; for f32 also split into a TF32 part and
its remainder for the kernel's 3xTF32 products); a caller that runs a stage
many times packs once and passes `packed` (`HiFiGANGenerator.packed_mrf`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

LRELU_SLOPE = 0.1
KERNEL_CHANNELS = (32, 64)  # channel counts the kernel is built for
KERNEL_HALO = 64  # halo rows of a kernel tile (csrc/fused_mrf.cu HALO)
KERNEL_MAX_PAD = 32  # largest (k - 1) / 2 * d a conv may need (PADR)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chain_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """Receptive radius of one resblock's conv chain: each dilation unit is
    conv(k, d) then conv(k, 1)."""
    c = (kernel_size - 1) // 2
    return sum(c * d + c for d in dilations)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _conv(x_cf, w_kio, b, k, d):
    """torch Conv1d (SAME, dilation d) on (B, C, T) with a (k, in, out) weight."""
    return F.conv1d(x_cf, w_kio.permute(2, 1, 0).to(x_cf.dtype), b.to(x_cf.dtype),
                    padding=get_padding(k, d), dilation=d)


def fused_mrf_stage_plain(x: torch.Tensor, block_params: Sequence[dict],
                          kernel_sizes: Sequence[int],
                          dilation_sizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """K4's function in plain PyTorch: (B, T, C) -> mean of the resblocks."""
    x_cf = x.transpose(1, 2)
    xs = None
    for bp, k, dils in zip(block_params, kernel_sizes, dilation_sizes):
        h = x_cf
        for i, d in enumerate(dils):
            t = _conv(F.leaky_relu(h, LRELU_SLOPE), bp[f"convs1_{i}_kernel"],
                      bp[f"convs1_{i}_bias"], k, d)
            t = _conv(F.leaky_relu(t, LRELU_SLOPE), bp[f"convs2_{i}_kernel"],
                      bp[f"convs2_{i}_bias"], k, 1)
            h = t + h
        xs = h if xs is None else xs + h
    return (xs / len(kernel_sizes)).transpose(1, 2)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as the kernel's `cvt.rna.tf32.f32` rounds it."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


class PackedStage(NamedTuple):
    """One stage's conv weights in K4's layout (`pack_stage_weights`)."""

    weight: torch.Tensor  # per conv, in mma fragment order: f32 hi / remainder, or bf16
    bias: torch.Tensor  # f32 (n_conv, C), values rounded to the working dtype
    kernel_sizes: Tuple[int, ...]
    n_dil: int


def _fragment_index(c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C_in, C_out) index of each element of one tap's bf16 mma fragments,
    (C/16 k-steps, C/16 n-tile pairs, 32 lanes, 8), csrc/fused_mrf.cu's order:
    element e of lane l holds k row 16 kk + 2 (l % 4) + e % 2 + 8 ((e % 4) // 2)
    and column 8 (2 np + e // 4) + l // 4."""
    kk, np_, lane, e = torch.meshgrid(torch.arange(c // 16), torch.arange(c // 16),
                                      torch.arange(32), torch.arange(8), indexing="ij")
    ci = 16 * kk + 2 * (lane % 4) + e % 2 + 8 * ((e % 4) // 2)
    co = 8 * (2 * np_ + e // 4) + lane // 4
    return ci, co


def _fragment_index_f32(c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C_in, C_out) index of the two B-fragment elements of each lane of one
    tap's tf32 mma fragments, (C/8 k-steps, C/8 n-tiles, 32 lanes, 2):
    element e of lane l holds k row 8 kk + l % 4 + 4 e and column 8 n + l // 4."""
    kk, n, lane, e = torch.meshgrid(torch.arange(c // 8), torch.arange(c // 8),
                                    torch.arange(32), torch.arange(2), indexing="ij")
    return 8 * kk + lane % 4 + 4 * e, 8 * n + lane // 4


def _index(c: int, dtype: torch.dtype, device):
    fn = _fragment_index if dtype == torch.bfloat16 else _fragment_index_f32
    return [i.to(device) for i in fn(c)]


def _pack_tap_weights(w: torch.Tensor, index) -> torch.Tensor:
    """One conv's (k, C, C) weight in K4's fragment order, flat. f32: per
    lane (hi, hi, w - hi, w - hi) of its two elements, hi = `tf32_round(w)`."""
    frag = w[:, index[0], index[1]]
    if w.dtype == torch.float32:
        hi = tf32_round(frag)
        frag = torch.cat([hi, frag - hi], dim=-1)  # w - hi is exact in f32
    return frag.reshape(-1)


def _unpack_tap_weights(flat: torch.Tensor, k: int, c: int, index) -> torch.Tensor:
    w = torch.empty(k, c, c, dtype=flat.dtype, device=flat.device)
    frag = flat.reshape((k,) + tuple(index[0].shape[:-1]) + (-1,))
    if flat.dtype == torch.float32:
        frag = frag[..., :2] + frag[..., 2:]  # hi + (w - hi) == w exactly
    w[:, index[0], index[1]] = frag
    return w


def pack_stage_weights(block_params: Sequence[dict], kernel_sizes: Sequence[int],
                       n_dil: int, dtype: torch.dtype, device) -> PackedStage:
    """The stage's weights as K4 takes them for `dtype` on `device`: the
    kernels rounded to `dtype` in the mma fragment order (`_fragment_index`
    for bf16; `_fragment_index_f32` for f32, each pair of elements followed by
    its remainder below TF32), the biases rounded to `dtype` and held in
    f32."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_mrf kernel takes f32 or bf16, got {dtype}")
    c = block_params[0]["convs1_0_kernel"].shape[-1]
    if c % (16 if dtype == torch.bfloat16 else 8):
        raise ValueError(f"the {dtype} fused_mrf kernel takes C divisible by "
                         f"{16 if dtype == torch.bfloat16 else 8}, got {c}")
    index = _index(c, dtype, device)
    weights, biases = [], []
    with torch.no_grad():
        # the kernel's order: per resblock, per unit, conv1 then conv2
        for bp, k in zip(block_params, kernel_sizes):
            for i in range(n_dil):
                for cn in ("convs1", "convs2"):
                    w = bp[f"{cn}_{i}_kernel"]
                    if tuple(w.shape) != (k, c, c):
                        raise ValueError(f"{cn}_{i}_kernel must be ({k}, {c}, {c}), "
                                         f"got {tuple(w.shape)}")
                    weights.append(_pack_tap_weights(w.to(device=device, dtype=dtype), index))
                    biases.append(bp[f"{cn}_{i}_bias"].to(device=device, dtype=dtype).float())
        return PackedStage(torch.cat(weights).contiguous(), torch.stack(biases).contiguous(),
                           tuple(kernel_sizes), n_dil)


def _tap_numel(c: int, dtype: torch.dtype) -> int:
    """Packed elements of one conv tap: f32 keeps two floats a weight."""
    return (2 if dtype == torch.float32 else 1) * c * c


def unpack_stage_weights(packed: PackedStage) -> list:
    """`pack_stage_weights` undone: resblock dicts of `convs{1,2}_{i}_kernel`
    (k, C, C) and `_bias` (C,) in the packed dtype."""
    c = packed.bias.shape[1]
    dtype = packed.weight.dtype
    index = _index(c, dtype, packed.weight.device)
    per_tap = _tap_numel(c, dtype)
    blocks, pos, n = [], 0, 0
    for k in packed.kernel_sizes:
        bp = {}
        for i in range(packed.n_dil):
            for cn in ("convs1", "convs2"):
                flat = packed.weight[pos:pos + k * per_tap]
                pos += k * per_tap
                bp[f"{cn}_{i}_kernel"] = _unpack_tap_weights(flat, k, c, index)
                bp[f"{cn}_{i}_bias"] = packed.bias[n].to(dtype)
                n += 1
        blocks.append(bp)
    return blocks


def fused_mrf_stage(x: torch.Tensor, block_params: Sequence[dict],
                    kernel_sizes: Sequence[int],
                    dilation_sizes: Sequence[Sequence[int]],
                    packed: Optional[PackedStage] = None) -> torch.Tensor:
    """One MRF stage on channel-last x (B, T, C) -> (B, T, C).

    CUDA tensors launch kernel K4 (f32 or bf16, contiguous, C in 32/64, odd
    kernels, chain radius <= 64) on `packed`, the weights that
    `pack_stage_weights` made for x's dtype and device, or on `block_params`
    packed now; CPU tensors run `fused_mrf_stage_plain`.
    """
    if x.device.type != "cuda":
        return fused_mrf_stage_plain(x, block_params, kernel_sizes, dilation_sizes)

    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_mrf kernel takes f32 or bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_mrf kernel takes contiguous (B, T, C), got "
                         f"shape {tuple(x.shape)}")
    b, t, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_mrf kernel takes C in {KERNEL_CHANNELS}, got {c}")
    n_res = len(kernel_sizes)
    n_dil = len(dilation_sizes[0])
    if not (1 <= n_res <= 4 and 1 <= n_dil <= 4 and len(block_params) == n_res
            and len(dilation_sizes) == n_res
            and all(len(d) == n_dil for d in dilation_sizes)):
        raise ValueError("fused_mrf kernel takes 1-4 resblocks of 1-4 dilation units each")
    for k, dils in zip(kernel_sizes, dilation_sizes):
        if k % 2 == 0 or chain_halo(k, dils) > KERNEL_HALO \
                or max(dils) * (k - 1) // 2 > KERNEL_MAX_PAD:
            raise ValueError(f"fused_mrf kernel cannot run k={k}, dilations={dils}: "
                             f"needs odd k, chain radius <= {KERNEL_HALO} and "
                             f"(k-1)/2*d <= {KERNEL_MAX_PAD}")

    if packed is None:
        packed = pack_stage_weights(block_params, kernel_sizes, n_dil, x.dtype, x.device)
    n_conv = 2 * n_dil * n_res
    if (packed.weight.dtype != x.dtype or packed.weight.device != x.device
            or packed.bias.device != x.device
            or tuple(packed.bias.shape) != (n_conv, c) or packed.n_dil != n_dil
            or packed.kernel_sizes != tuple(kernel_sizes)
            or packed.weight.numel() != 2 * n_dil * sum(kernel_sizes) * _tap_numel(c, x.dtype)):
        raise ValueError("packed weights do not match this stage, dtype or device")
    out = torch.empty_like(x)
    # the kernel's f32 sum of the resblock outputs, one row per output row
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    ks = (ctypes.c_int * n_res)(*kernel_sizes)
    dils = (ctypes.c_int * (n_res * n_dil))(*[d for ds in dilation_sizes for d in ds])
    lib = _build.load("fused_mrf")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.masg_fused_mrf(x.data_ptr(), out.data_ptr(), packed.weight.data_ptr(),
                                  packed.bias.data_ptr(), acc.data_ptr(), b, t, c,
                                  _KERNEL_DTYPES[x.dtype], n_res, n_dil, ks, dils,
                                  x.device.index, stream)
    _build.check(code, "fused_mrf")
    fused_mrf_stage.launches += 1
    return out


fused_mrf_stage.launches = 0  # kernel launches since the last reset
