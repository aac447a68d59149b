"""The arithmetic of the f32 K4 kernel (csrc/fused_mrf.cu, 3xTF32) on the CPU.

The kernel splits every operand x into hi = tf32(x) and lo = tf32(x - hi)
(to nearest, ties away) and takes each product as lo.hi' + hi.lo' + hi.hi'
in f32 (per k-step of 8 channels on the tensor cores, whose truncating
accumulation the card's own 2e-5 check covers; here the sums are rounded).
Here a V1 stage is computed that way, with the kernel's rounding
(`tf32_round`) and its packed weights (`pack_stage_weights`, unpacked into
the TF32 part and the remainder), and held against `fused_mrf_stage_plain`
at 5e-6, a quarter of the 2e-5 bar the kernel meets on the card. A single
TF32 product is shown to miss that bar, which is why the kernel takes three.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from masg_tpu_torch.ops.fused_mrf import (LRELU_SLOPE, fused_mrf_stage_plain, get_padding,
                                          pack_stage_weights, tf32_round)

torch.set_num_threads(2)

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3


def _stage_inputs(c, t, seed):
    """x (2, T, C) and V1 resblock weights as chip_smoke draws them:
    N(0, 1) / sqrt(C k) kernels, 0.1 N(0, 1) biases."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, t, c)).astype(np.float32))
    blocks = []
    for k in KS:
        bp = {}
        for i in range(3):
            for cn in ("convs1", "convs2"):
                bp[f"{cn}_{i}_kernel"] = torch.from_numpy(
                    (rng.normal(size=(k, c, c)) / np.sqrt(c * k)).astype(np.float32))
                bp[f"{cn}_{i}_bias"] = torch.from_numpy(
                    (0.1 * rng.normal(size=c)).astype(np.float32))
        blocks.append(bp)
    return x, blocks


def _split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _conv_3xtf32(a_cf, w_kio, b, k, d, products):
    """conv(k, d) of (B, C, T) `a_cf` as the kernel forms it: `products`
    lists which (a part, w part) products are summed, in order."""
    parts_a = _split(a_cf)
    parts_w = _split(w_kio)
    out = None
    for ia, iw in products:
        y = F.conv1d(parts_a[ia], parts_w[iw].permute(2, 1, 0), padding=get_padding(k, d),
                     dilation=d)
        out = y if out is None else out + y
    return out + b[None, :, None]


def _stage_3xtf32(x, blocks, products):
    x_cf = x.transpose(1, 2)
    xs = None
    for bp, k, dils in zip(blocks, KS, DS):
        h = x_cf
        for i, d in enumerate(dils):
            t = _conv_3xtf32(F.leaky_relu(h, LRELU_SLOPE), bp[f"convs1_{i}_kernel"],
                             bp[f"convs1_{i}_bias"], k, d, products)
            t = _conv_3xtf32(F.leaky_relu(t, LRELU_SLOPE), bp[f"convs2_{i}_kernel"],
                             bp[f"convs2_{i}_bias"], k, 1, products)
            h = t + h
        xs = h if xs is None else xs + h
    return (xs / len(KS)).transpose(1, 2)


THREE = ((1, 0), (0, 1), (0, 0))  # lo.hi', hi.lo', hi.hi': the kernel's order


@pytest.mark.parametrize("c,t", [(32, 2000), (64, 1999)])
def test_3xtf32_stage_matches_plain(c, t):
    x, blocks = _stage_inputs(c, t, seed=c)
    want = fused_mrf_stage_plain(x, blocks, KS, DS)
    got = _stage_3xtf32(x, blocks, THREE)
    err = (got - want).abs().max().item()
    print(f"[parity] 3xTF32 K4 arithmetic, C={c} T={t}: max abs err vs f32 plain "
          f"{err:.3g} (bar 5e-6; max |ref| {want.abs().max().item():.3g})")
    assert err <= 5e-6
    # one TF32 product (hi.hi') misses even the card's 2e-5 bar
    single = (_stage_3xtf32(x, blocks, ((0, 0),)) - want).abs().max().item()
    assert single > 2e-5


def test_packed_weights_are_the_kernels_split():
    """The packed f32 weights carry hi(w) and w - hi(w); the kernel's lo is
    tf32 of that remainder, so its (hi, lo) is `_split(w)`."""
    c = 32
    _, blocks = _stage_inputs(c, 8, seed=5)
    packed = pack_stage_weights(blocks, KS, 3, torch.float32, "cpu").weight
    frag = packed[:3 * c * c * 2].reshape(3, c // 8, c // 8, 32, 4)  # resblock 0, convs1_0
    w = blocks[0]["convs1_0_kernel"]
    hi, lo = _split(w)
    lane = torch.arange(32)
    for kk in range(c // 8):
        for n in range(c // 8):
            for e in range(2):
                ci, co = 8 * kk + lane % 4 + 4 * e, 8 * n + lane // 4
                assert torch.equal(frag[:, kk, n, :, e], hi[:, ci, co])
                assert torch.equal(tf32_round(frag[:, kk, n, :, 2 + e]), lo[:, ci, co])
