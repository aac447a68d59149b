"""FastSpeech2 (masg_tpu_torch.models) against masg_tpu's, with masg_tpu's
weights carried across by fs2_state_dict_from_jax (loaded with strict=True)
and masg_tpu's flash attention in Pallas interpret mode."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.core import config as jcfg
from masg_tpu.infer.serving import with_duration_bias as jax_with_duration_bias
from masg_tpu.models import FastSpeech2 as JaxFastSpeech2
from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax, with_duration_bias
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models import FastSpeech2
import torch_port_support  # noqa: F401  (the port tests' thread count)

MAX_MEL = 64


def tiny_config(mod):
    """2 + 2 layers, hidden 32, 2 heads, filter 64, in either package's config."""
    cfg = mod.ExperimentConfig(
        preprocess=mod.PreprocessConfig(), model=mod.ModelConfig(), train=mod.TrainConfig(),
        stats=mod.Stats(pitch=(-2.0, 9.0, 0.0, 1.0), energy=(-1.5, 8.0, 0.0, 1.0)),
        speakers={f"spk{i}": [i, "M", "ja"] for i in range(4)})
    tr = cfg.model.transformer
    tr.encoder_layer = tr.decoder_layer = 2
    tr.encoder_hidden = tr.decoder_hidden = 32
    tr.encoder_head = tr.decoder_head = 2
    tr.conv_filter_size = 64
    cfg.model.variance_predictor.filter_size = 32
    return cfg


def make_batch(seed=0, b=3, length=11):
    rng = np.random.default_rng(seed)
    texts = rng.integers(1, 100, size=(b, length)).astype(np.int32)
    src_lens = np.array([length, length - 3, 1][:b], np.int32)
    for i in range(b):
        texts[i, src_lens[i]:] = 0
    durations = rng.integers(1, 5, size=(b, length)).astype(np.int32)
    for i in range(b):
        durations[i, src_lens[i]:] = 0
    meta = np.zeros((b, 4), np.float32)
    meta[:, 1] = meta[:, 2] = 1.0
    return dict(
        speakers=(np.arange(b) % 4).astype(np.int32), texts=texts, src_lens=src_lens,
        accents=rng.integers(0, 5, size=(b, length)).astype(np.int32),
        mel_lens=durations.sum(1).astype(np.int32), d_targets=durations,
        p_targets=rng.normal(size=(b, length)).astype(np.float32),
        e_targets=rng.normal(size=(b, length)).astype(np.float32), speaker_meta=meta)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax variables, port model) sharing one set of weights; the
    PostNet BatchNorm statistics are randomised so eval-mode BN is exercised."""
    b = make_batch()
    jm = JaxFastSpeech2.from_config(tiny_config(jcfg), use_flash=True)
    variables = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in
                                                 ("speakers", "texts", "src_lens")),
                        MAX_MEL, accents=jnp.asarray(b["accents"]),
                        speaker_meta=jnp.asarray(b["speaker_meta"]))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for bn in stats["postnet"].values():
        bn["mean"] = rng.normal(scale=0.1, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, size=bn["var"].shape).astype(np.float32)
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": stats}
    tm = FastSpeech2.from_config(tiny_config(tcfg), use_flash=True).eval()
    tm.load_state_dict(fs2_state_dict_from_jax(variables["params"], stats, tiny_config(tcfg)),
                       strict=True)
    return jm, variables, tm


def _t(batch, key):
    a = batch[key]
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


def _assert_out_close(got, want, what, atol=2e-4):
    err = np.abs(got.postnet_mel.numpy() - np.asarray(want.postnet_mel)).max()
    print(f"[parity] FastSpeech2 {what}: max abs postnet_mel err {err:.3g} (bar {atol})")
    for name in ("mel", "postnet_mel", "pitch_prediction", "energy_prediction",
                 "log_duration_prediction"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=atol, err_msg=name)


def test_teacher_forced_matches(models):
    jm, variables, tm = models
    b = make_batch(2)
    t_mel = int(b["mel_lens"].max())
    keys = ("mel_lens", "p_targets", "e_targets", "d_targets", "accents", "speaker_meta")
    want = jm.apply(variables, jnp.asarray(b["speakers"]), jnp.asarray(b["texts"]),
                    jnp.asarray(b["src_lens"]), t_mel,
                    **{k: jnp.asarray(b[k]) for k in keys})
    with torch.no_grad():
        got = tm(_t(b, "speakers"), _t(b, "texts"), _t(b, "src_lens"), t_mel,
                 **{k: _t(b, k) for k in keys})
    _assert_out_close(got, want, "teacher-forced")
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(want.mel_len))
    np.testing.assert_allclose(got.speaker_emb.numpy(), np.asarray(want.speaker_emb))


def test_free_running_with_duration_bias(models):
    """Durations and mel lengths exact first, then the mels."""
    jm, variables, tm = models
    jvars = jax_with_duration_bias(variables, math.log(5.0))
    orig = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.load_state_dict(with_duration_bias(orig, math.log(5.0)))
    try:
        b = make_batch(3)
        kw = dict(p_control=1.1, e_control=0.7, d_control=1.2)
        want = jm.apply(jvars, jnp.asarray(b["speakers"]), jnp.asarray(b["texts"]),
                        jnp.asarray(b["src_lens"]), MAX_MEL,
                        accents=jnp.asarray(b["accents"]),
                        speaker_meta=jnp.asarray(b["speaker_meta"]), **kw)
        with torch.no_grad():
            got = tm(_t(b, "speakers"), _t(b, "texts"), _t(b, "src_lens"), MAX_MEL,
                     accents=_t(b, "accents"), speaker_meta=_t(b, "speaker_meta"), **kw)
        np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                      np.asarray(want.duration_rounded))
        np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(want.mel_len))
        assert got.mel_len.min() > 0
        _assert_out_close(got, want, "free-running")
        np.testing.assert_array_equal(got.mel_pad_mask.numpy(), np.asarray(want.mel_pad_mask))
        for name in ("pi", "mu", "sigma"):
            np.testing.assert_allclose(getattr(got.speaker_gmm, name).numpy(),
                                       np.asarray(getattr(want.speaker_gmm, name)),
                                       rtol=1e-6, atol=1e-6)
    finally:
        tm.load_state_dict(orig)


def test_synthesize_from_speaker_emb_and_distribution(models):
    jm, variables, tm = models
    jvars = jax_with_duration_bias(variables, math.log(4.0))
    orig = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.load_state_dict(with_duration_bias(orig, math.log(4.0)))
    try:
        b = make_batch(4)
        emb = np.random.default_rng(5).normal(size=(3, 32)).astype(np.float32)
        want = jm.apply(jvars, jnp.asarray(b["texts"]), jnp.asarray(b["src_lens"]), MAX_MEL,
                        jnp.asarray(emb), accents=jnp.asarray(b["accents"]),
                        method=JaxFastSpeech2.synthesize_from_speaker_emb)
        with torch.no_grad():
            got = tm.synthesize_from_speaker_emb(_t(b, "texts"), _t(b, "src_lens"), MAX_MEL,
                                                 torch.from_numpy(emb),
                                                 accents=_t(b, "accents"))
        np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(want.mel_len))
        _assert_out_close(got, want, "from speaker embedding")

        meta = np.eye(4, dtype=np.float32)
        jg = jm.apply(jvars, jnp.asarray(meta), method=JaxFastSpeech2.speaker_distribution)
        with torch.no_grad():
            tg = tm.speaker_distribution(torch.from_numpy(meta))
        for name in ("pi", "mu", "sigma"):
            np.testing.assert_allclose(getattr(tg, name).numpy(),
                                       np.asarray(getattr(jg, name)), rtol=1e-6, atol=1e-6)
    finally:
        tm.load_state_dict(orig)


def test_bf16_cast_keeps_bins_and_bn_stats_float32(models):
    tm = models[2]
    import copy

    half = copy.deepcopy(tm).to(torch.bfloat16)
    assert half.variance_adaptor.pitch_bins.dtype == torch.float32
    assert torch.equal(half.variance_adaptor.pitch_bins, tm.variance_adaptor.pitch_bins)
    bn, bn32 = half.postnet.convolutions[0][1], tm.postnet.convolutions[0][1]
    assert torch.equal(bn.running_var, bn32.running_var) and bn.weight.dtype == torch.bfloat16
    b = make_batch(6)
    with torch.no_grad():
        out = half(_t(b, "speakers"), _t(b, "texts"), _t(b, "src_lens"), MAX_MEL,
                   accents=_t(b, "accents"))
    assert out.postnet_mel.dtype == torch.bfloat16
    assert torch.isfinite(out.postnet_mel.float()).all()
