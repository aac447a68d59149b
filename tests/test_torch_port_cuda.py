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
