"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. On a machine with one, where JAX (which
tests/conftest.py imports) and pytest-xdist may be absent:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

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
    with pytest.raises(ValueError):
        fused_mrf_stage(torch.randn(1, 10, 16, device="cuda"), blocks, ks, ds)
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
