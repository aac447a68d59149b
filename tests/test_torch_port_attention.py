"""Attention (masg_tpu_torch.ops.attention) against masg_tpu.ops.attention:
K1's plain version and the CPU wrapper against the Pallas flash kernel in
interpret mode, and the plain masked attention against masg_tpu's XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.ops.attention import flash_attention as jax_flash_attention
from masg_tpu.ops.attention import mha_attention as jax_mha_attention
from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_plain,
                                          mha_attention)
import torch_port_support  # noqa: F401  (the port tests' thread count)


def _qkv(seed, b, h, t, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [200, 256])
def test_flash_plain_matches_pallas_interpret(t):
    """flash semantics at ragged T: lengths 0, 3 and T; a row with no valid
    key gives 0 (tests/test_flash_attention.py's 2e-5 bar)."""
    q, k, v = _qkv(t, 3, 2, t, 32)
    lengths = np.array([0, 3, t], np.int32)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lengths)))
    args = [torch.from_numpy(a) for a in (q, k, v)] + [torch.from_numpy(lengths)]
    o, lse = flash_attention_plain(*args)
    print(f"[parity] K1 plain vs Pallas interpret, T={t}: max abs err "
          f"{np.abs(o.numpy() - want).max():.3g} (bar 2e-5)")
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5)
    assert (o[0] == 0).all() and torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    assert torch.isfinite(lse[1:]).all()
    # the wrapper on CPU tensors is the plain version
    o2, lse2 = flash_attention(*args, return_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_flash_lse_is_the_row_logsumexp():
    q, k, v = _qkv(5, 2, 1, 40, 16)
    lengths = torch.tensor([40, 7])
    _, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), lengths)
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) / 4.0
    want = torch.stack([torch.logsumexp(s[0, :, :, :40], -1),
                        torch.logsumexp(s[1, :, :, :7], -1)])
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mha_attention_matches_jax(dtype):
    import jax

    q, k, v = (a.astype(dtype) for a in _qkv(11, 2, 2, 48, 16))
    lengths = np.array([48, 19])
    pad = np.arange(48)[None, :] >= lengths[:, None]
    got = mha_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pad))
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_mha_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), jnp.asarray(pad)))
    print(f"[parity] mha_attention {dtype.__name__}: max abs err "
          f"{np.abs(got.numpy() - want).max():.3g}")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 if dtype == np.float32 else 1e-12)

