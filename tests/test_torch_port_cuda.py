"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. On a machine with one, where JAX (which
tests/conftest.py imports) and pytest-xdist may be absent:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import os

import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dkv_plain, flash_attention_dq,
                                              flash_attention_dq_plain, flash_attention_plain)
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage, fused_mrf_stage_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)

    # K1 at a ragged T with lengths 0, 1 and T; f32 at masg_tpu's 2e-5 bar
    q, k, v = (torch.randn(3, 2, 200, 128, generator=gen).cuda() for _ in range(3))
    lens = torch.tensor([0, 1, 200], device="cuda")
    n0 = flash_attention.launches
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, lens)
    assert flash_attention.launches == n0 + 1
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=0)
    assert (o[0] == 0).all() and torch.isinf(lse[0]).all()
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=1e-4, rtol=0)
    ob = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), lens)
    ob_ref, _ = flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), lens)
    torch.testing.assert_close(ob.float(), ob_ref.float(), atol=1e-2, rtol=1e-2)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), lens)

    # K2/K3 through the autograd Function, against the plain versions: f32 at
    # masg_tpu's flash-gradient bar (5e-3), bf16 at 1e-2 (both sides round the
    # same f32 sums to bf16: about one bf16 ulp at |grad| up to 4)
    valid = (torch.arange(200, device="cuda")[None, :] < lens[:, None])[:, None, :, None]
    do = torch.randn(3, 2, 200, 128, generator=gen).cuda() * valid
    for dtype, tol in ((torch.float32, 5e-3), (torch.bfloat16, 1e-2)):
        qg, kg, vg = (x.detach().to(dtype).requires_grad_() for x in (q, k, v))
        counts = (flash_attention.launches, flash_attention_dq.launches,
                  flash_attention_dkv.launches)
        o, lse = flash_attention(qg, kg, vg, lens, return_lse=True)
        o.backward(do.to(dtype))
        assert (flash_attention.launches, flash_attention_dq.launches,
                flash_attention_dkv.launches) == tuple(c + 1 for c in counts)
        delta = (do.to(dtype).float() * o.detach().float()).sum(-1)
        args = (qg.detach(), kg.detach(), vg.detach(), do.to(dtype), lse, delta, lens)
        dq_ref = flash_attention_dq_plain(*args)
        dk_ref, dv_ref = flash_attention_dkv_plain(*args)
        torch.testing.assert_close((qg.grad * valid).float(), (dq_ref * valid).float(),
                                   atol=tol, rtol=tol if dtype == torch.bfloat16 else 0)
        for got, want in ((kg.grad, dk_ref), (vg.grad, dv_ref)):
            assert got.dtype == dtype and not torch.isnan(got).any()
            assert (got * ~valid == 0).all() and (got[0] == 0).all()
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol if dtype == torch.bfloat16 else 0)

    # K4 at a V1 stage width over several tiles and both sequence edges
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    blocks = []
    for kk in ks:
        bp = {}
        for i in range(3):
            for cn in ("convs1", "convs2"):
                bp[f"{cn}_{i}_kernel"] = (torch.randn(kk, 64, 64, generator=gen)
                                          / (64 * kk) ** 0.5).cuda()
                bp[f"{cn}_{i}_bias"] = (0.1 * torch.randn(64, generator=gen)).cuda()
        blocks.append(bp)
    x = torch.randn(2, 1000, 64, generator=gen).cuda()
    n0 = fused_mrf_stage.launches
    y = fused_mrf_stage(x, blocks, ks, ds)
    assert fused_mrf_stage.launches == n0 + 1
    torch.testing.assert_close(y, fused_mrf_stage_plain(x, blocks, ks, ds), atol=2e-5, rtol=0)
    with pytest.raises(ValueError):  # 24 channels: not a width masg_tpu's K4 takes
        fused_mrf_stage(torch.randn(1, 10, 24, device="cuda"), blocks, ks, ds)
    torch.cuda.synchronize()


def _mrf_blocks(c, gen, ks=(3, 7, 11)):
    blocks = []
    for kk in ks:
        bp = {}
        for i in range(3):
            for cn in ("convs1", "convs2"):
                bp[f"{cn}_{i}_kernel"] = (torch.randn(kk, c, c, generator=gen)
                                          / (c * kk) ** 0.5).cuda()
                bp[f"{cn}_{i}_bias"] = (0.1 * torch.randn(c, generator=gen)).cuda()
        blocks.append(bp)
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize("c,t", [(32, 3000), (64, 2000)])
def test_bf16_fused_mrf_matches_plain_over_tiles_and_edges(c, t):
    """The tensor-core K4 (tiles of 1408 rows at C=32, 640 at C=64) at both
    sequence edges and across tile joins: bar 0.125 (each conv output is
    rounded to bf16 on both sides; a flip early in the chain carries on, 4
    ulps at magnitudes 4-8). A run that starts 37 rows into the second tile
    gives the same bits at every row more than 64 rows past the cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage, fused_mrf_stage_plain

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(c)
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    blocks = [{n: v.bfloat16() for n, v in b.items()} for b in _mrf_blocks(c, gen)]
    x = torch.randn(2, t, c, generator=gen).cuda().bfloat16()
    y = fused_mrf_stage(x, blocks, ks, ds)
    y_ref = fused_mrf_stage_plain(x, blocks, ks, ds)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), y_ref.float(), atol=0.125, rtol=0)
    s0 = {32: 1408, 64: 640}[c] + 37
    y_cut = fused_mrf_stage(x[:, s0:].contiguous(), blocks, ks, ds)
    assert torch.equal(y_cut[:, 65:], y[:, s0 + 65:])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_bf16_flash_forward_ragged(dh):
    """The tensor-core K1 at a ragged T (not a multiple of its 64-row tiles)
    with lengths 0, 1, T and one in between: o at atol = rtol = 1e-2 (p is
    rounded to bf16 for p.v), LSE at 1e-4, rows with no key give o = 0 and
    LSE = -inf, no NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    gen = torch.Generator().manual_seed(dh)
    t = 200
    q, k, v = (torch.randn(4, 2, t, dh, generator=gen).cuda().bfloat16() for _ in range(3))
    lens = torch.tensor([0, 1, t, 77], device="cuda")
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, lens)
    assert o.dtype == torch.bfloat16 and not torch.isnan(o.float()).any()
    assert (o[0] == 0).all() and torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    assert torch.isfinite(lse[1:]).all()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=1e-4, rtol=0)
    # a length-1 row attends to its one key: o = v[0] exactly
    assert torch.equal(o[1], v[1, :, :1].expand_as(o[1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_bf16_flash_backward_ragged(dh):
    """The tensor-core K2/K3 at a ragged T (not a multiple of their 64-row
    tiles) with lengths 0, 1, T and one in between: dQ (at valid rows), dK and
    dV at atol = rtol = 1e-2 (p and ds are rounded to bf16 for the products),
    dK/dV exactly 0 at keys >= len and for the length-0 row, no NaN, the same
    bits from two launches, and the autograd path launching K1-K3 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dkv_plain, flash_attention_dq,
                                              flash_attention_dq_plain)

    gen = torch.Generator().manual_seed(100 + dh)
    t = 200
    q, k, v = (torch.randn(4, 2, t, dh, generator=gen).cuda().bfloat16() for _ in range(3))
    lens = torch.tensor([0, 1, t, 77], device="cuda")
    valid = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, :, None]
    do = (torch.randn(4, 2, t, dh, generator=gen).cuda() * valid).bfloat16()
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, lens)
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkv(*args)
    dq_ref = flash_attention_dq_plain(*args)
    dk_ref, dv_ref = flash_attention_dkv_plain(*args)
    for g in (dq, dk, dv):
        assert g.dtype == torch.bfloat16 and not torch.isnan(g.float()).any()
    torch.testing.assert_close((dq * valid).float(), (dq_ref * valid).float(), atol=1e-2,
                               rtol=1e-2)
    for got, want in ((dk, dk_ref), (dv, dv_ref)):
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
        assert (got * ~valid == 0).all() and (got[0] == 0).all()
    assert torch.equal(flash_attention_dq(*args), dq)
    assert all(torch.equal(a, b) for a, b in zip(flash_attention_dkv(*args), (dk, dv)))

    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    counts = (flash_attention.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    flash_attention(qg, kg, vg, lens).backward(do)
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == tuple(c + 1 for c in counts)
    assert torch.equal(qg.grad, dq) and torch.equal(kg.grad, dk) and torch.equal(vg.grad, dv)
    torch.cuda.synchronize()


def _ragged_lens(b, t, gen):
    """Lengths 0, 1, T and 77 first, then random ones in [1, T]."""
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[:4] = torch.tensor([0, 1, t, 77])
    return lens.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 40])
@pytest.mark.parametrize("dh", [64, 128])
def test_f32_flash_forward_ragged(dh, b):
    """The register-tiled f32 K1 at a ragged T (not a multiple of its 32- or
    64-row query tiles or its 64-key tiles) with lengths 0, 1, T and 77: o
    within masg_tpu's 2e-5, LSE within 1e-4, o = 0 and LSE = -inf for the
    length-0 row, and a length-1 row equal to its one value row. B = 4 gives
    32 blocks of 64 rows, so the launcher takes 32-row tiles; B = 40, 64-row
    ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(200 + dh + b)
    t = 200
    q, k, v = (torch.randn(b, 2, t, dh, generator=gen).cuda() for _ in range(3))
    lens = _ragged_lens(b, t, gen)
    n0 = flash_attention.launches
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    assert flash_attention.launches == n0 + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, lens)
    assert o.dtype == torch.float32 and not torch.isnan(o).any()
    assert (o[0] == 0).all() and torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    assert torch.isfinite(lse[1:]).all()
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=1e-4, rtol=0)
    assert torch.equal(o[1], v[1, :, :1].expand_as(o[1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_f32_flash_dkv_ragged(dh):
    """The register-tiled f32 K3 at a ragged T (not a multiple of its 64-key
    or 32-query tiles) with lengths 0, 1, T and 77: dK and dV within
    masg_tpu's 5e-3, exactly 0 at keys >= len and for the length-0 row, no
    NaN, and the same bits from two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dkv_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(300 + dh)
    t = 200
    q, k, v = (torch.randn(4, 2, t, dh, generator=gen).cuda() for _ in range(3))
    lens = _ragged_lens(4, t, gen)
    valid = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, :, None]
    do = torch.randn(4, 2, t, dh, generator=gen).cuda() * valid
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, lens)
    n0 = flash_attention_dkv.launches
    dk, dv = flash_attention_dkv(*args)
    assert flash_attention_dkv.launches == n0 + 1
    dk_ref, dv_ref = flash_attention_dkv_plain(*args)
    for got, want in ((dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.float32 and not torch.isnan(got).any()
        torch.testing.assert_close(got, want, atol=5e-3, rtol=0)
        assert (got * ~valid == 0).all() and (got[0] == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(flash_attention_dkv(*args), (dk, dv)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,b", [(16, 4), (32, 40), (64, 4), (64, 40), (128, 4), (128, 40)])
def test_f32_flash_dq_ragged(dh, b):
    """The register-tiled f32 K2 at a ragged T (not a multiple of its 32- or
    64-row query tiles or its 32-key tiles) with lengths 0, 1, T and 77: dQ at
    valid rows within masg_tpu's 5e-3, no NaN anywhere (the length-0 row
    gives 0), the same bits from two launches, and one launch counted. B = 4
    gives 32 blocks of 64 rows, so the launcher takes 32-row tiles; B = 40,
    64-row ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dq,
                                              flash_attention_dq_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(400 + dh + b)
    t = 200
    q, k, v = (torch.randn(b, 2, t, dh, generator=gen).cuda() for _ in range(3))
    lens = _ragged_lens(b, t, gen)
    valid = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, :, None]
    do = torch.randn(b, 2, t, dh, generator=gen).cuda() * valid
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, lens)
    n0 = flash_attention_dq.launches
    dq = flash_attention_dq(*args)
    assert flash_attention_dq.launches == n0 + 1
    dq_ref = flash_attention_dq_plain(*args)
    assert dq.dtype == torch.float32 and not torch.isnan(dq).any()
    assert (dq[0] == 0).all()
    torch.testing.assert_close(dq * valid, dq_ref * valid, atol=5e-3, rtol=0)
    assert torch.equal(flash_attention_dq(*args), dq)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("c,t", [(32, 3000), (64, 2000), (64, 1), (32, 1), (64, 50), (32, 40)])
def test_f32_fused_mrf_matches_plain_over_tiles_and_edges(c, t):
    """The 3xTF32 K4 (tiles of 640 rows at C=32, 256 at C=64) at both sequence
    edges, across tile joins, at T = 1 and at T below the 64-row halo, within
    2e-5 of the f32 plain path with TF32 off. Where T spans two tiles, a run
    that starts 37 rows into the second tile gives the same bits at every row
    more than 64 rows past the cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage, fused_mrf_stage_plain

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(500 + c + t)
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    blocks = _mrf_blocks(c, gen)
    x = torch.randn(2, t, c, generator=gen).cuda()
    n0 = fused_mrf_stage.launches
    y = fused_mrf_stage(x, blocks, ks, ds)
    assert fused_mrf_stage.launches == n0 + 1
    y_ref = fused_mrf_stage_plain(x, blocks, ks, ds)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    torch.testing.assert_close(y, y_ref, atol=2e-5, rtol=0)
    tile = {32: 640, 64: 256}[c]
    if t > tile + 37 + 65:
        s0 = tile + 37
        y_cut = fused_mrf_stage(x[:, s0:].contiguous(), blocks, ks, ds)
        assert torch.equal(y_cut[:, 65:], y[:, s0 + 65:])
    torch.cuda.synchronize()


# the narrow kernels' output rows per block (csrc/fused_mrf.cu FGeo / TGeo)
NARROW_TILE = {(torch.float32, 16): 1536, (torch.float32, 8): 3328,
               (torch.bfloat16, 16): 3328, (torch.bfloat16, 8): 6912}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t,ks", [(16, 3500, (3, 7, 11)), (8, 7100, (3, 7, 11)),
                                    (16, 2000, (3, 7)), (8, 40, (3, 7, 11)), (16, 1, (3, 7)),
                                    (4, 3000, (3, 7)), (2, 100, (3, 7, 11)), (1, 50, (3,))])
def test_narrow_fused_mrf_matches_plain_over_tiles_and_edges(c, t, ks, dtype):
    """K4 at the widths of HiFi-GAN V2's and the demo vocoder's last stages
    (C = 16, 8; V2's kernels and the demo's two resblocks) and at C = 4, 2, 1
    (run at 8 on zero-padded channels): one launch each, within 2e-5 (f32)
    and 0.125 (bf16) of the plain stage, as at C = 32 / 64; across a tile
    join, a run that starts 37 rows into the second tile gives the same bits
    at every row more than 64 rows past the cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.ops.fused_mrf import (fused_mrf_stage, fused_mrf_stage_plain,
                                              kernel_channels)

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(900 + c + t)
    ds = ((1, 3, 5),) * len(ks)
    blocks = [{n: v.to(dtype) for n, v in b.items()} for b in _mrf_blocks(c, gen, ks)]
    x = torch.randn(2, t, c, generator=gen).cuda().to(dtype)
    n0 = fused_mrf_stage.launches
    y = fused_mrf_stage(x, blocks, ks, ds)
    assert fused_mrf_stage.launches == n0 + 1
    y_ref = fused_mrf_stage_plain(x, blocks, ks, ds)
    assert y.shape == x.shape and y.dtype == dtype and torch.isfinite(y.float()).all()
    tol = 2e-5 if dtype == torch.float32 else 0.125
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=0)
    tile = NARROW_TILE[(dtype, kernel_channels(c))]
    if t > tile + 37 + 65:
        s0 = tile + 37
        y_cut = fused_mrf_stage(x[:, s0:].contiguous(), blocks, ks, ds)
        assert torch.equal(y_cut[:, 65:], y[:, s0 + 65:])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_generators_of_128_channels_run_every_stage_through_k4():
    """HiFi-GAN V2 (128 initial channels, kernels 3 / 7 / 11) and the demo's
    vocoder (kernels 3 / 7) on the card: all four MRF stages (C = 64, 32, 16,
    8) launch K4, and the wav is within 2 LSB of the plain MRF's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    from masg_tpu_torch.infer.vocoder import Vocoder, vocoder_infer
    from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mel = torch.randn(2, 120, 80, generator=torch.Generator().manual_seed(0)).cuda()
    for ks in ((3, 7, 11), (3, 7)):
        kw = dict(upsample_initial_channel=128, resblock_kernel_sizes=ks,
                  resblock_dilation_sizes=((1, 3, 5),) * len(ks))
        wavs = {}
        for fused in (True, False):
            gen = HiFiGANGenerator(fused_mrf=fused, **kw)
            init_random_weights(gen, torch.Generator().manual_seed(3))
            n0 = fused_mrf_stage.launches
            wavs[fused] = vocoder_infer(mel, Vocoder(gen.cuda()))
            assert fused_mrf_stage.launches - n0 == (4 if fused else 0)
        for a, b in zip(wavs[True], wavs[False]):
            assert np.abs(a.astype(np.int32)).max() > 1000
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 2


@pytest.mark.cuda
def test_streaming_vocoder_on_the_card_matches_one_shot():
    """V1 at full width on the card, f32 (K4 in the two narrow stages, cuDNN
    in the wide ones): the streamed wav against the one-shot vocode of the
    same mel within 2 LSB (window and full-length shapes may take other cuDNN
    algorithms), and the receptive field measured on the card equals the
    CPU's for the same weights (outside the field the probe and the base run
    see the same inputs, so the card must give the same bits there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import copy

    import numpy as np

    from masg_tpu_torch.infer.vocoder import (Vocoder, measure_receptive_field_frames,
                                              vocode_streaming, vocoder_infer)
    from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = HiFiGANGenerator()
    init_random_weights(gen, torch.Generator().manual_seed(1))
    cpu = Vocoder(copy.deepcopy(gen))
    card = Vocoder(gen.cuda())
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    try:
        rf_cpu = measure_receptive_field_frames(cpu)
    finally:
        torch.set_num_threads(threads)
    rf = measure_receptive_field_frames(card)
    assert rf == rf_cpu, (rf, rf_cpu)
    for t in (700, 576, 193, 100):
        mel = torch.randn(1, t, 80, generator=torch.Generator().manual_seed(t))
        full = vocoder_infer(mel.cuda(), card)[0]
        n0 = fused_mrf_stage.launches
        chunks = list(vocode_streaming(card, mel, chunk_frames=192))
        assert fused_mrf_stage.launches - n0 == 2 * len(chunks)
        stream = np.concatenate(chunks)
        assert stream.shape == full.shape
        assert np.abs(full.astype(np.int32)).max() > 1000
        diff = np.abs(stream.astype(np.int32) - full.astype(np.int32))
        assert diff.max() <= 2, (t, int(diff.max()), float((diff > 0).mean()))


@pytest.mark.cuda
def test_fused_mrf_refuses_a_backward_on_the_card():
    """K4 has no backward: on the card `fused_mrf_stage` raises when its input
    or its weights require grad (a generator built with the default
    `fused_mrf=True` and trained would otherwise get no gradient below its
    fused stages); under `torch.no_grad()` it launches; the vocoder trainer's
    generator runs the plain MRF and every parameter gets a gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage
    from masg_tpu_torch.train.vocoder import init_vocoder_train_state, make_vocoder_train_step

    gen = HiFiGANGenerator()  # V1: stages C = 256, 128 (cuDNN), 64, 32 (K4)
    init_random_weights(gen, torch.Generator().manual_seed(2))
    gen.cuda()
    mel = torch.randn(1, 20, 80, device="cuda")
    with pytest.raises(RuntimeError, match="inference-only"):
        gen(mel)
    with pytest.raises(RuntimeError, match="fused_mrf=False"):
        gen(mel.requires_grad_())
    n0 = fused_mrf_stage.launches
    with torch.no_grad():
        gen(mel)
    assert fused_mrf_stage.launches == n0 + 2

    from masg_tpu_torch.infer.vocoder import DEFAULT_HIFIGAN_CONFIG

    cfg = {**DEFAULT_HIFIGAN_CONFIG, "segment_size": 2048,
           "mpd_periods": [2, 3], "mpd_channels": [4, 8, 16, 16], "msd_scales": 2,
           "msd_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}
    state = init_vocoder_train_state(cfg, 1, device="cuda")
    n0 = fused_mrf_stage.launches
    state, m = make_vocoder_train_step(cfg)(state, 0.5 * torch.randn(2, 2048, device="cuda"))
    assert fused_mrf_stage.launches == n0 and torch.isfinite(m.gen_loss)
    assert all(p.grad is not None and bool(p.grad.abs().max() > 0)
               for p in state.generator.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vocoder_infer_makes_the_int16_wav_on_the_card(dtype):
    """At B = 16, lengths 0 and T among the rows: the wav `vocoder_infer`
    converts and trims on the card equals numpy's `to_int16` and trim of the
    same generator output fetched to the host, bit for bit; a first call's
    arrays are unchanged by a second; the span and the counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    from masg_tpu_torch.infer.vocoder import Vocoder, to_int16, vocoder_infer
    from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
    from masg_tpu_torch.utils import profiling

    class Kept(Vocoder):
        def __call__(self, mel):
            self.wav = super().__call__(mel)
            return self.wav

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, frames = 16, 40
    t = frames * 256
    gen = HiFiGANGenerator(upsample_initial_channel=128)
    init_random_weights(gen, torch.Generator().manual_seed(4))
    voc = Kept(gen.to("cuda", dtype))
    rng = np.random.default_rng(5)
    lengths = [0, t, t + 300, 1] + rng.integers(0, t, b - 4).tolist()

    def numpy_path(wav, lens):
        out = list(to_int16(wav.float().cpu().numpy(), voc.max_wav_value))
        return [w[: int(n)] for w, n in zip(out, lens)]

    calls = []
    for seed in (0, 1):
        mel = torch.randn(b, frames, 80, generator=torch.Generator().manual_seed(seed))
        profiling.clear()
        with profiling.recording():
            got = vocoder_infer(mel.cuda(), voc, lengths)
        want = numpy_path(voc.wav, lengths)
        assert [s.name for s in profiling.spans()] == ["vocoder.to_int16"]
        assert profiling.counters() == {"vocoder.device_int16": b, "vocoder.samples": b * t,
                                        "vocoder.useful_samples": sum(min(n, t) for n in lengths)}
        assert len(got) == b and [len(w) for w in got] == [min(n, t) for n in lengths]
        for g, w in zip(got, want):
            assert g.dtype == np.int16
            np.testing.assert_array_equal(g, w)
        assert np.abs(np.concatenate(want).astype(np.int32)).max() > 1000
        calls.append((got, [w.copy() for w in got]))
    profiling.clear()
    (first, first_copy), (second, _) = calls
    for g, c in zip(first, first_copy):
        np.testing.assert_array_equal(g, c)
    assert not any(np.shares_memory(a, s) for a in first for s in second if a.size and s.size)
    whole = vocoder_infer(mel.cuda(), voc)
    assert [len(w) for w in whole] == [t] * b
    for g, w in zip(whole, numpy_path(voc.wav, [t] * b)):
        np.testing.assert_array_equal(g, w)
