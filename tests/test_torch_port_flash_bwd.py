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

torch.set_num_threads(1)


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
