"""The flash-attention backward of the port (kernels K2/K3 through their
plain versions on the CPU) against masg_tpu's Pallas backward in interpret
mode, plus its own properties: zero dK/dV past the length, and gradcheck."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.ops.attention import flash_attention as jax_flash_attention
from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                          flash_attention_dkv_plain, flash_attention_dq,
                                          flash_attention_dq_plain)
import torch_port_support  # noqa: F401  (the port tests' thread count)


def _inputs(seed, lengths, h, t, dh, dtype=np.float32):
    """q, k, v, do (do zero at query rows >= length: the model's contract)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(len(lengths), h, t, dh)).astype(dtype) for _ in range(4))
    valid = (np.arange(t)[None, :] < np.asarray(lengths)[:, None])[:, None, :, None]
    return q, k, v, do * valid, valid


def _port_grads(q, k, v, do, lengths):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(qt, kt, vt, torch.tensor(lengths))
    o.backward(torch.from_numpy(do))
    return qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def test_backward_matches_pallas_interpret():
    """B = 2 plus a length-0 row, T = 200, Dh = 64: dQ at valid rows, dK and
    dV within masg_tpu's flash-gradient bar (tests/test_flash_attention.py)."""
    lengths = [200, 77, 0]
    q, k, v, do, valid = _inputs(7, lengths, 2, 200, 64)
    gj = jax.grad(lambda q, k, v: jnp.sum(
        jax_flash_attention(q, k, v, jnp.asarray(lengths, jnp.int32)) * do),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gj = [np.asarray(g) for g in gj]
    gt = _port_grads(q, k, v, do, lengths)
    errs = [np.abs((gt[0] - gj[0]) * valid).max(), np.abs(gt[1] - gj[1]).max(),
            np.abs(gt[2] - gj[2]).max()]
    print(f"[parity] flash backward vs Pallas interpret, T=200: max abs err "
          f"dQ {errs[0]:.3g} dK {errs[1]:.3g} dV {errs[2]:.3g} (bar 5e-3)")
    assert max(errs) <= 5e-3, errs
    assert all(np.isfinite(g).all() for g in gt)


def test_dk_dv_zero_past_length_and_for_empty_rows():
    lengths = [50, 13, 0]
    q, k, v, do, valid = _inputs(3, lengths, 2, 50, 16)
    _, dk, dv = _port_grads(q, k, v, do, lengths)
    for g in (dk, dv):
        assert (g * ~valid == 0).all()
        assert (g[2] == 0).all()
    assert np.abs(dk[0]).max() > 0 and np.abs(dv[1]).max() > 0


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    lengths = torch.tensor([9, 4, 0])
    q, k, v, do, _ = (torch.from_numpy(a) for a in _inputs(1, [9, 4, 0], 2, 9, 16))
    o, lse = flash_attention(q, k, v, lengths, return_lse=True)
    delta = (do * o).sum(-1)
    before = (flash_attention.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    assert torch.equal(flash_attention_dq(q, k, v, do, lse, delta, lengths),
                       flash_attention_dq_plain(q, k, v, do, lse, delta, lengths))
    for a, b in zip(flash_attention_dkv(q, k, v, do, lse, delta, lengths),
                    flash_attention_dkv_plain(q, k, v, do, lse, delta, lengths)):
        assert torch.equal(a, b)
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == before


@pytest.mark.parametrize("lengths", [[9, 4, 0], [9, 9, 1]])
def test_gradcheck_f64(lengths):
    """The Function's analytic gradient against finite differences, on the
    output masked at query rows >= length (the contract the model meets)."""
    q, k, v, _, valid = _inputs(5, lengths, 2, 9, 8, np.float64)
    lens = torch.tensor(lengths)
    mask = torch.from_numpy(valid.astype(np.float64))
    args = tuple(torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    assert torch.autograd.gradcheck(lambda q, k, v: flash_attention(q, k, v, lens) * mask,
                                    args)


def _bf16_kernel_rounding(q, k, v, do, lse, delta, lengths):
    """What the bf16 K2/K3 compute: p and ds from f32 sums of the bf16
    inputs, rounded to bf16 only as the operands of the p^T.do, ds.k and
    ds^T.q products, whose sums stay f32; K3 drops query rows >= length.
    Returns (dq, dk, dv) in bf16."""
    f32, t = torch.float32, q.shape[2]
    qf, kf, vf, dof = (x.to(f32) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    valid = torch.arange(t)[None, :] < lengths[:, None]
    live = torch.isfinite(lse)
    s = scale * (qf @ kf.transpose(-1, -2))
    p = torch.exp(s - torch.where(live, lse, torch.zeros_like(lse))[..., None])
    p = torch.where(valid[:, None, None, :] & live[..., None], p, torch.zeros_like(p))
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    rows = valid[:, None, :, None]
    p_k, ds_k = (torch.where(rows, x, torch.zeros_like(x)).to(torch.bfloat16).to(f32)
                 for x in (p, ds))
    dq = scale * (ds.to(torch.bfloat16).to(f32) @ kf)
    dk = scale * (ds_k.transpose(-1, -2) @ qf)
    dv = p_k.transpose(-1, -2) @ dof
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def test_bf16_operand_rounding_meets_the_kernel_bar():
    """The bf16 K2/K3 round p and ds to bf16 for the tensor cores; at the
    decoder's shape (T = 640, Dh = 128) with lengths 0, 1, T and one between,
    that rounding stays within the card's bar (atol = rtol = 1e-2) of the
    plain versions, which round only their f32 results."""
    lengths = [0, 1, 640, 333]
    q, k, v, do, valid = (torch.from_numpy(a) for a in _inputs(11, lengths, 2, 640, 128))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    lens = torch.tensor(lengths)
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, lens)
    dq, dk, dv = _bf16_kernel_rounding(*args)
    dq_ref = flash_attention_dq_plain(*args)
    dk_ref, dv_ref = flash_attention_dkv_plain(*args)
    pairs = ((dq * valid, dq_ref * valid), (dk, dk_ref), (dv, dv_ref))
    errs = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
    print(f"[parity] bf16 operand rounding of K2/K3 vs plain, T=640, Dh=128: max abs err "
          f"dQ {errs[0]:.3g} dK {errs[1]:.3g} dV {errs[2]:.3g} (bar atol = rtol = 1e-2)")
    for got, want in pairs:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    for g in (dk, dv):
        assert (g * ~valid == 0).all() and (g[0] == 0).all()
    assert max(errs) > 0  # the rounding is emulated, not the plain path again
