"""The port's attribute probe (masg_tpu_torch/eval/attribute_probe.py)
against masg_tpu's: `AttributeAxes` scores and `embed_wavs` with a GE2E
embedder whose weights are carried across, `extract_f0` bit for bit, and
masg_tpu's four tests/test_attribute_probe.py cases re-run on the port."""

import jax.numpy as jnp
import numpy as np
import torch

from masg_tpu.audio.f0 import extract_f0 as jax_extract_f0
from masg_tpu.eval import attribute_probe as jprobe
from masg_tpu.models.speaker_encoder import SpeechEmbedder as JaxSpeechEmbedder
from masg_tpu_torch.audio.f0 import extract_f0
from masg_tpu_torch.compat.from_jax import ge2e_state_dict_from_jax
from masg_tpu_torch.eval.attribute_probe import AttributeAxes, embed_wavs, mean_voiced_f0
from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
from torch_port_support import jax_variables


def _corner_cloud(rng, center, n=6, d=8, spread=0.05):
    return center + spread * rng.normal(size=(n, d))


def test_axes_scores_match():
    rng = np.random.default_rng(3)
    corners = {k: rng.normal(size=(5, 16)) for k in ("M_ja", "F_ja", "M_en", "F_en")}
    probe = rng.normal(size=(7, 16))
    ours, theirs = AttributeAxes(corners), jprobe.AttributeAxes(corners)
    for name in ("gender_score", "language_score"):
        np.testing.assert_allclose(getattr(ours, name)(probe), getattr(theirs, name)(probe),
                                   rtol=1e-5, atol=1e-5)
    indep = {k: rng.normal(size=(9, 16)) for k in corners}
    a, b = ours.separation_of(indep), theirs.separation_of(indep)
    assert a.keys() == b.keys()
    np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], rtol=1e-5, atol=1e-5)


def test_embed_wavs_matches_with_carried_weights():
    """A GE2E embedder (hidden 32, 2 layers, proj 16, 80 mels) from masg_tpu's
    init: each wav's chunked d-vector within 1e-5, one wav shorter than a
    chunk (padded) among them."""
    je = JaxSpeechEmbedder(n_mels=80, hidden=32, n_layers=2, proj=16)
    p = jax_variables(je, 0, jnp.zeros((2, 150, 80)))["params"]
    te = SpeechEmbedder(n_mels=80, hidden=32, n_layers=2, proj=16)
    te.load_state_dict(ge2e_state_dict_from_jax(p), strict=True)
    rng = np.random.default_rng(4)
    t = np.arange(60000) / 22050.0
    wavs = [(0.3 * np.sin(2 * np.pi * 140 * t) + 0.02 * rng.normal(size=t.size))
            .astype(np.float32), rng.normal(size=22050).astype(np.float32) * 0.1]
    want = jprobe.embed_wavs(je, p, wavs)
    te.train()
    got = embed_wavs(te, wavs)
    assert te.training  # back in its mode
    err = float(np.abs(got - want).max())
    print(f"[parity] embed_wavs: max abs err {err:.3g} (bar 1e-5)")
    assert got.shape == (2, 16) and err <= 1e-5


def test_extract_f0_is_masg_tpus_numpy_path():
    rng = np.random.default_rng(5)
    t = np.arange(16000) / 22050.0
    x = np.sin(2 * np.pi * 160 * t) + 0.3 * np.sin(2 * np.pi * 320 * t) \
        + 0.05 * rng.normal(size=t.size)
    for sig in (x, rng.normal(size=8000), np.zeros(4000)):
        got = extract_f0(sig, 22050, use_native=False)
        want = jax_extract_f0(sig, 22050, use_native=False)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # the default is the native extension, as in masg_tpu
        got = extract_f0(sig, 22050)
        want = jax_extract_f0(sig, 22050)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# masg_tpu's tests/test_attribute_probe.py, on the port


def test_axes_projection_recovers_mixture():
    rng = np.random.default_rng(0)
    d = 8
    m_dir = np.zeros(d); m_dir[0] = 1.0  # noqa: E702
    f_dir = np.zeros(d); f_dir[0] = -1.0  # noqa: E702
    ja_dir = np.zeros(d); ja_dir[1] = 1.0  # noqa: E702
    en_dir = np.zeros(d); en_dir[1] = -1.0  # noqa: E702
    corners = {
        "M_ja": m_dir + ja_dir, "F_ja": f_dir + ja_dir,
        "M_en": m_dir + en_dir, "F_en": f_dir + en_dir,
    }
    axes = AttributeAxes({k: _corner_cloud(rng, v) for k, v in corners.items()})
    p = 0.7 * corners["M_ja"] + 0.3 * corners["F_ja"]
    assert abs(float(axes.gender_score(p[None])[0]) - 0.3) < 0.05
    assert abs(float(axes.language_score(p[None])[0]) - 0.0) < 0.05


def test_separation_of_is_not_circular():
    rng = np.random.default_rng(1)
    fit = {k: rng.normal(size=(6, 8)) for k in ("M_ja", "F_ja", "M_en", "F_en")}
    axes = AttributeAxes(fit)
    assert abs(axes.separation()["gender_margin"] - 1.0) < 1e-6
    indep = {k: rng.normal(size=(50, 8)) for k in fit}
    sep = axes.separation_of(indep)
    assert abs(sep["gender_margin"]) < 0.5  # noise: no real margin


def test_embed_wavs_shapes_and_norm():
    class _StubEmbedder(torch.nn.Module):
        def forward(self, x):
            # a deterministic projection of the chunk mean: embedding dim 4
            m = x.mean(dim=(1, 2))
            return {"embeddings": torch.stack([m, m + 1, m * 2, torch.ones_like(m)], -1)}

    rng = np.random.default_rng(2)
    wavs = [rng.normal(size=60000).astype(np.float32),
            rng.normal(size=22050).astype(np.float32)]  # 1 s: single pad chunk
    embs = embed_wavs(_StubEmbedder(), wavs)
    assert embs.shape == (2, 4)
    np.testing.assert_allclose(np.linalg.norm(embs, axis=-1), 1.0, rtol=1e-5)


def test_mean_voiced_f0_tracks_tone():
    t = np.arange(22050) / 22050.0
    for f0 in (120.0, 210.0):
        x = np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
        est = mean_voiced_f0(x)
        assert abs(est - f0) < 0.03 * f0, (f0, est)
    assert mean_voiced_f0(np.zeros(22050)) == 0.0
