"""Port ops (masg_tpu_torch.ops) against masg_tpu.ops on the same numpy inputs:
masks, the sinusoid table, the length regulator, variance bucketizing and
the GMM speaker prior."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.models.variance_adaptor import make_bins as jax_make_bins
from masg_tpu.ops import gmm as jgmm
from masg_tpu.ops.length_regulator import expand_scalars as jax_expand_scalars
from masg_tpu.ops.length_regulator import regulate_lengths as jax_regulate_lengths
from masg_tpu.ops.masks import pad_mask_from_lengths as jax_pad_mask
from masg_tpu.ops.positional import sinusoid_table as jax_sinusoid_table
from masg_tpu_torch.models.variance_adaptor import VarianceAdaptor, make_bins
from masg_tpu_torch.ops import gmm as tgmm
from masg_tpu_torch.ops.length_regulator import expand_scalars, regulate_lengths
from masg_tpu_torch.ops.masks import masked_fill_time, pad_mask_from_lengths
from masg_tpu_torch.ops.positional import sinusoid_table
import torch_port_support  # noqa: F401  (the port tests' thread count)


def test_pad_mask_and_masked_fill():
    lengths = np.array([0, 3, 7], np.int32)
    got = pad_mask_from_lengths(torch.from_numpy(lengths), 7).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pad_mask(jnp.asarray(lengths), 7)))
    x = torch.ones(3, 7, 2)
    filled = masked_fill_time(x, torch.from_numpy(got))
    assert filled[0].abs().sum() == 0 and filled[2].sum() == 14


@pytest.mark.parametrize("n,d", [(1, 4), (640, 256), (1001, 32)])
def test_sinusoid_table_bit_identical(n, d):
    np.testing.assert_array_equal(sinusoid_table(n, d).numpy(),
                                  np.asarray(jax_sinusoid_table(n, d)))


def test_regulate_lengths_matches_jax_including_overflow():
    rng = np.random.default_rng(0)
    b, l, h, cap = 4, 9, 5, 20
    x = rng.normal(size=(b, l, h)).astype(np.float32)
    d = rng.integers(0, 5, size=(b, l)).astype(np.int32)
    d[1, 6:] = 0  # padded phonemes
    d[2] = 0  # an utterance of zero frames
    d[3] = 4  # 36 frames > cap: truncated, mel_len clipped
    out, mel_len = regulate_lengths(torch.from_numpy(x), torch.from_numpy(d), cap)
    j_out, j_len = jax_regulate_lengths(jnp.asarray(x), jnp.asarray(d), cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(j_len))
    assert mel_len.tolist()[2:] == [0, cap]
    assert out.dtype == torch.float32 and mel_len.dtype == torch.int32

    v = rng.normal(size=(b, l)).astype(np.float32)
    np.testing.assert_array_equal(
        expand_scalars(torch.from_numpy(v), torch.from_numpy(d), cap).numpy(),
        np.asarray(jax_expand_scalars(jnp.asarray(v), jnp.asarray(d), cap)))


@pytest.mark.parametrize("quant", ["linear", "log"])
def test_bins_and_bucketize_at_exact_edges(quant):
    lo, hi = (0.5, 9.0) if quant == "log" else (-2.0, 9.0)
    edges = make_bins(lo, hi, 256, quant)
    np.testing.assert_array_equal(edges, jax_make_bins(lo, hi, 256, quant))
    # every edge exactly, the values just around it, and both ends beyond
    vals = np.concatenate([edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf),
                           [lo - 1.0, hi + 1.0]]).astype(np.float32)
    got = VarianceAdaptor._embed(torch.nn.Identity(), torch.from_numpy(edges),
                                 torch.from_numpy(vals)).numpy()
    want = np.asarray(jnp.searchsorted(jnp.asarray(edges), jnp.asarray(vals), side="left"))
    np.testing.assert_array_equal(got, want)


def _gmm_inputs(seed=0, batch=(3,), k=3, d=8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=batch + (k,))
    pi = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    pi[0, 0] = 0.0  # exercises the 1e-37 clip
    pi[0] /= pi[0].sum()
    mu = rng.normal(size=batch + (k, d)).astype(np.float32)
    sigma = np.exp(0.3 * rng.normal(size=batch + (k, d))).astype(np.float32)
    x = rng.normal(size=batch + (d,)).astype(np.float32)
    return pi, mu, sigma, x


def test_gmm_log_prob_and_mean_match_jax():
    pi, mu, sigma, x = _gmm_inputs()
    t = tgmm.DiagGMM(*(torch.from_numpy(a) for a in (pi, mu, sigma)))
    j = jgmm.DiagGMM(*(jnp.asarray(a) for a in (pi, mu, sigma)))
    np.testing.assert_allclose(tgmm.log_prob(t, torch.from_numpy(x)).numpy(),
                               np.asarray(jgmm.log_prob(j, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tgmm.component_log_prob(t, torch.from_numpy(x)).numpy(),
                               np.asarray(jgmm.component_log_prob(j, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tgmm.mean(t).numpy(), np.asarray(jgmm.mean(j)),
                               rtol=1e-6, atol=1e-6)


def test_gmm_sample_with_explicit_noise():
    """The same component draws and normal noise give mu_c + sigma_c * eps,
    the arithmetic of masg_tpu's sample after its key-driven draws."""
    pi, mu, sigma, _ = _gmm_inputs(1)
    rng = np.random.default_rng(7)
    comp = rng.integers(0, 3, size=(5, 3))
    eps = rng.normal(size=(5, 3, 8)).astype(np.float32)
    t = tgmm.DiagGMM(*(torch.from_numpy(a) for a in (pi, mu, sigma)))
    got = tgmm.sample_with_noise(t, torch.from_numpy(comp), torch.from_numpy(eps)).numpy()
    onehot = np.eye(3, dtype=np.float32)[comp]  # masg_tpu's gather-by-one-hot
    mu_c = np.einsum("...k,...kd->...d", onehot, np.broadcast_to(mu, (5, 3, 3, 8)))
    sg_c = np.einsum("...k,...kd->...d", onehot, np.broadcast_to(sigma, (5, 3, 3, 8)))
    np.testing.assert_allclose(got, mu_c + sg_c * eps, rtol=1e-6, atol=1e-6)


def test_gmm_sample_is_seeded_and_shaped():
    pi, mu, sigma, _ = _gmm_inputs(2)
    t = tgmm.DiagGMM(*(torch.from_numpy(a) for a in (pi, mu, sigma)))
    a = tgmm.sample(t, torch.Generator().manual_seed(3), sample_shape=(4,))
    b = tgmm.sample(t, torch.Generator().manual_seed(3), sample_shape=(4,))
    assert a.shape == (4, 3, 8) and torch.equal(a, b)
    # all weight on component 2: samples are N(mu_2, sigma_2^2) per dimension
    one = tgmm.DiagGMM(torch.tensor([0.0, 0.0, 1.0]), t.mu[0], t.sigma[0])
    s = tgmm.sample(one, torch.Generator().manual_seed(4), sample_shape=(4000,))
    z = (s - t.mu[0, 2]) / t.sigma[0, 2]
    assert z.mean(0).abs().max() < 0.1 and (z.std(0) - 1).abs().max() < 0.1
