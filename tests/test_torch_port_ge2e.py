"""The port's GE2E slice against masg_tpu's: the STFT / mel filterbank / GE2E
mel and chunk archives, `SpeechEmbedder` (weights carried across by
`compat/from_jax.py`), the GE2E similarity and losses, `LangDiscriminator`,
the GE2E trainer's f64 trajectories (the five cases of masg_tpu's
tests/test_ge2e_train_parity.py, dropout off), `evaluate_eer`, and
`cli.train_speech_embedder` writing a checkpoint that masg_tpu reads."""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.audio.stft import mel_filterbank as jax_mel_filterbank
from masg_tpu.audio.stft import stft_magnitude as jax_stft_magnitude
from masg_tpu.compat.torch_fs2 import export_torch_ge2e
from masg_tpu.models.discriminator import LangDiscriminator as JaxLangDiscriminator
from masg_tpu.models import speaker_encoder as jse
from masg_tpu.preprocessor import ge2e_preprocess as jpre
from masg_tpu.train import ge2e as jge2e
from masg_tpu_torch.audio.stft import mel_filterbank, stft_magnitude
from masg_tpu_torch.audio.wavio import write_wav
from masg_tpu_torch.compat.from_jax import (ge2e_state_dict_from_jax,
                                            lang_discriminator_state_dict_from_jax)
from masg_tpu_torch.models import speaker_encoder as tse
from masg_tpu_torch.models.discriminator import LangDiscriminator
from masg_tpu_torch.preprocessor import ge2e_preprocess as tpre
from masg_tpu_torch.train import ge2e as tge2e

torch.set_num_threads(2)

N, M, NMELS, T_FRAMES = 3, 2, 20, 24
HIDDEN, LAYERS, PROJ = 32, 2, 16
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x),
                        tree)


def jax_embedder(dtype=jnp.float32, n_mels=NMELS, seed=0, bias_scale=0.1):
    """masg_tpu's embedder and params (its LSTM biases, zero at init, moved off 0)."""
    je = jse.SpeechEmbedder(n_mels=n_mels, hidden=HIDDEN, n_layers=LAYERS, proj=PROJ,
                            dtype=dtype)
    p = _np(je.init(jax.random.PRNGKey(seed), jnp.zeros((2, T_FRAMES, n_mels), dtype))["params"])
    rng = np.random.default_rng(seed + 100)
    p = jax.tree.map(lambda x: (x + bias_scale * rng.normal(size=x.shape)).astype(x.dtype), p)
    return je, p


def port_embedder(params, dtype=torch.float32, n_mels=NMELS, dropout=True):
    te = tse.SpeechEmbedder(n_mels=n_mels, hidden=HIDDEN, n_layers=LAYERS, proj=PROJ).to(dtype)
    te.load_state_dict(ge2e_state_dict_from_jax(params), strict=True)
    if not dropout:
        for m in te.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return te


# ---------------------------------------------------------------------------
# features and archives
# ---------------------------------------------------------------------------


def test_mel_filterbank_is_exact_and_stft_matches():
    for args in ((80, 1024, 22050, 0.0, 8000.0), (80, 1024, 22050, 55.0, 8000.0),
                 (40, 512, 16000, 20.0, 7600.0)):
        assert np.array_equal(mel_filterbank(*args), jax_mel_filterbank(*args))
    rng = np.random.default_rng(0)
    audio = rng.uniform(-0.5, 0.5, size=(2, 5000)).astype(np.float32)
    want = np.asarray(jax_stft_magnitude(jnp.asarray(audio)))
    got = stft_magnitude(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 513, 1 + 5000 // 256)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"[parity] stft_magnitude: max err {err:.3g} of the largest magnitude (bar 1e-5)")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # pad_to: the frames inside the signal keep their values, the tail reads zeros
    padded = stft_magnitude(torch.from_numpy(audio[0]), pad_to=6144).numpy()
    want_p = np.asarray(jax_stft_magnitude(jnp.asarray(audio[0]), pad_to=6144))
    assert padded.shape == want_p.shape
    np.testing.assert_allclose(padded[:, :want.shape[-1]], got[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="pad_to"):
        stft_magnitude(torch.from_numpy(audio[0]), pad_to=100)


def test_ge2e_mel_matches():
    rng = np.random.default_rng(1)
    t = np.arange(22050) / 22050.0
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.normal(size=t.size)).astype(np.float32)
    want = jpre.ge2e_mel(wav)
    got = tpre.ge2e_mel(wav)
    err = float(np.abs(got - want).max())
    print(f"[parity] ge2e_mel: max abs err {err:.3g} (bar 1e-5)")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert err <= 1e-5


def _write_speakers(root, n_speakers=4, seconds=6.0):
    """A tone with a silent gap (two VAD spans of 2.7 s, two 150-frame chunks
    each at stride 75), one wav per speaker."""
    rng = np.random.default_rng(2)
    sr = 22050
    out = {}
    for s in range(n_speakers):
        n = int(seconds * sr)
        t = np.arange(n) / sr
        f0 = 110.0 + 40.0 * s
        wav = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.normal(size=n)
        wav[int(0.45 * n):int(0.55 * n)] = 0.0
        path = os.path.join(root, f"s{s}.wav")
        write_wav(path, wav.astype(np.float32), sr)
        out[f"spk{s}"] = ([path], "MF"[s % 2], "ja" if s < n_speakers // 2 else "en")
    return out


def test_chunk_archives_match(tmp_path):
    """Both packages write the same archives: names, shapes, and log-mels
    within 5e-5. The two f32 FFTs (torch's, XLA's) round differently, ~5e-7
    of a frame's peak magnitude; the log turns that into up to ~1.6e-5 at
    bins 40 dB under the peak (a few dozen of 192,000 values exceed 1e-5)."""
    speakers = _write_speakers(str(tmp_path))
    want = jpre.build_ge2e_corpus(speakers, str(tmp_path / "jax"), "SYNTH")
    got = tpre.build_ge2e_corpus(speakers, str(tmp_path / "port"), "SYNTH")
    assert got == want and len(got) == 4
    worst, over = 0.0, 0
    for name in got:
        a = np.load(tmp_path / "port" / name)
        b = np.load(tmp_path / "jax" / name)
        assert a.shape == b.shape and a.shape[0] > 2 and a.shape[1:] == (80, 150)
        worst = max(worst, float(np.abs(a - b).max()))
        over += int((np.abs(a - b) > 1e-5).sum())
    print(f"[parity] build_ge2e_corpus: {len(got)} archives, max abs err {worst:.3g} "
          f"(bar 5e-5), {over} values over 1e-5")
    assert worst <= 5e-5
    strided = tpre.chunk_speaker_wavs(speakers["spk0"][0], stride=0)
    assert strided.shape[1:] == (80, 150)
    np.testing.assert_allclose(strided, jpre.chunk_speaker_wavs(speakers["spk0"][0], stride=0),
                               atol=5e-5)


# ---------------------------------------------------------------------------
# the embedder and the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, bar", [("float32", 1e-5), ("float64", 1e-12)])
def test_speech_embedder_forward_matches(dtype, bar):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, T_FRAMES, NMELS)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        je, p = jax_embedder(getattr(jnp, dtype))
        if dtype == "float64":
            p = _to64(p)
        want = je.apply({"params": p}, jnp.asarray(x), deterministic=True)
        want = {k: np.asarray(v) for k, v in want.items()}
        want_d = je.apply({"params": p}, jnp.asarray(x), detach=True, deterministic=True)
    te = port_embedder(p, getattr(torch, dtype)).eval()
    got = te(torch.from_numpy(x))
    errs = {k: float(np.abs(got[k].detach().numpy() - want[k]).max()) for k in want}
    print(f"[parity] SpeechEmbedder {dtype}: {errs} (bar {bar:g})")
    assert max(errs.values()) <= bar
    # detach=True: same values, no gradient from the head into the trunk
    xt = torch.from_numpy(x).requires_grad_(True)
    te(xt, detach=True)["da_lang_logits"].sum().backward()
    assert xt.grad is None
    np.testing.assert_allclose(te(torch.from_numpy(x), detach=True)["da_lang_logits"]
                               .detach().numpy(), np.asarray(want_d["da_lang_logits"]),
                               atol=bar)


def test_state_dict_round_trips_against_export_torch_ge2e():
    _, p = jax_embedder()
    want = export_torch_ge2e(p)
    got = ge2e_state_dict_from_jax(p)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    te = tse.SpeechEmbedder(n_mels=NMELS, hidden=HIDDEN, n_layers=LAYERS, proj=PROJ)
    assert set(te.state_dict()) == set(want)
    # a fresh embedder: the reference's init, both biases of a gate zero
    assert all(float(v.abs().max()) == 0.0 for k, v in te.state_dict().items() if "bias_" in k)
    assert [n for n, _ in te.named_parameters()] == [
        n for n in __import__("masg_tpu.compat.torch_fs2", fromlist=["x"])
        .ge2e_param_order(LAYERS)]


def test_similarity_losses_bce_and_chunking_match():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(4, 3, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    sim_w = np.asarray(jse.ge2e_similarity(jnp.asarray(emb)))
    sim_t = tse.ge2e_similarity(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(sim_t, sim_w, atol=1e-6)
    s = jnp.asarray(sim_w * 7 - 2)
    for jf, tf in ((jse.ge2e_softmax_loss, tse.ge2e_softmax_loss),
                   (jse.ge2e_contrast_loss, tse.ge2e_contrast_loss)):
        np.testing.assert_allclose(float(tf(torch.from_numpy(np.asarray(s)))), float(jf(s)),
                                   rtol=1e-6)
    logits = rng.normal(size=12).astype(np.float32) * 3
    targets = rng.uniform(size=12).astype(np.float32)
    np.testing.assert_allclose(
        float(tse.bce_with_logits_sum(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(jse.bce_with_logits_sum(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tse.bce_with_logits_sum(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(torch.nn.BCEWithLogitsLoss(reduction="sum")(torch.from_numpy(logits),
                                                          torch.from_numpy(targets))),
        rtol=1e-6)
    langs = (np.arange(12) % 2).astype(np.float32)
    for loss_type in ("softmax", "contrast"):
        jp = jse.GE2ELossParams(w=jnp.asarray(9.0), b=jnp.asarray(-4.0))
        want = jse.ge2e_loss(jp, jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(langs),
                             loss_type)
        got = tse.ge2e_loss(tse.GE2ELossParams(9.0, -4.0), torch.from_numpy(emb),
                            torch.from_numpy(logits), torch.from_numpy(langs), loss_type)
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                                   rtol=1e-6)
    _, no_da, da0 = tse.ge2e_loss(tse.init_ge2e_params(), torch.from_numpy(emb), None, None)
    assert float(da0) == 0.0 and float(no_da) > 0
    for t in (149, 150, 220, 300):
        mel = rng.normal(size=(3, t, 80)).astype(np.float32)
        want = np.asarray(jse.chunk_mels(jnp.asarray(mel), 150))
        got = tse.chunk_mels(torch.from_numpy(mel), 150).numpy()
        assert got.shape == want.shape == (3 * (t // 150 + 1), 150, 80)
        assert np.array_equal(got, want)


def test_lang_discriminator_matches():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 30, 20)).astype(np.float32)
    jd = JaxLangDiscriminator(n_mels=20, hidden=16)
    p = _np(jd.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    p = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(a.dtype), p)
    want = np.asarray(jd.apply({"params": p}, jnp.asarray(x)))
    td = LangDiscriminator(n_mels=20, hidden=16)
    td.load_state_dict(lang_discriminator_state_dict_from_jax(p), strict=True)
    got = td(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (5, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer: f64 trajectories against masg_tpu's make_ge2e_train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_corpus(tmp_path_factory):
    """4 speakers over two languages, 5 chunks each of NMELS x T_FRAMES."""
    root = tmp_path_factory.mktemp("chunks")
    rng = np.random.default_rng(6)
    for s in range(4):
        base = rng.normal(size=(NMELS, T_FRAMES))
        chunks = (base[None] + 0.3 * rng.normal(size=(5, NMELS, T_FRAMES))).astype(np.float32)
        np.save(root / f"synth_spk{s}_{'MF'[s % 2]}_{'ja' if s < 2 else 'en'}.npy", chunks)
    return str(root)


def _datasets(path, seed):
    kw = dict(m_utts=M, tisv_frame=T_FRAMES, seed=seed)
    return (jge2e.SpeakerChunkDataset(path, ["SYNTH"], **kw),
            tge2e.SpeakerChunkDataset(path, ["SYNTH"], **kw))


def _batches(path, seed, n):
    """n batches from both packages' datasets with one seed: they must agree."""
    jds, tds = _datasets(path, seed)
    out = []
    for _ in range(n):
        (jm, jl), (tm, tl) = jds.sample_batch(N), tds.sample_batch(N)
        assert np.array_equal(jm, tm) and np.array_equal(jl, tl)
        out.append((jm.astype(np.float64), jl.astype(np.float64)))
    return out


@pytest.fixture(scope="module")
def no_dropout():
    import flax.linen as fnn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        yield


def jax_trajectory(batches, threshold, use_ge2e_backward=True, subroutine_after=None,
                   sub_stream=(), anneal_after=()):
    """masg_tpu's step in f64 from its own init: (initial params, w, b, losses)."""
    with jax.enable_x64(True):
        je = jse.SpeechEmbedder(n_mels=NMELS, hidden=HIDDEN, n_layers=LAYERS, proj=PROJ,
                                dtype=jnp.float64)
        init_state, step = jge2e.make_ge2e_train_step(
            je, N, M, lr=LR, use_ge2e_backward=use_ge2e_backward, da_threshold=threshold)
        state = init_state(jax.random.PRNGKey(0), jnp.asarray(batches[0][0]))
        to64 = lambda t: jax.tree.map(  # noqa: E731
            lambda x: jnp.asarray(x, jnp.float64)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, t)
        state = jge2e.GE2ETrainState(*(to64(x) for x in state))
        init = (_np(state.embedder_params), float(state.ge2e.w), float(state.ge2e.b))
        traj, key, lr_scale = [], jax.random.PRNGKey(1), 1.0
        for i, (mels, langs) in enumerate(batches):
            key, sub = jax.random.split(key)
            state, loss, da = step(state, jnp.asarray(mels), jnp.asarray(langs), sub,
                                   jnp.asarray(False), jnp.asarray(lr_scale, jnp.float64))
            traj.append((float(loss), float(da)))
            if i in anneal_after:
                lr_scale /= 2
            if i == subroutine_after:
                _, sub_step, _ = jge2e.make_da_subroutine_step(je)
                p_main, p_da = jge2e._split_da(state.embedder_params)
                opt_da = state.opt_state_da
                for s_mels, s_langs in sub_stream:
                    key, sub2 = jax.random.split(key)
                    p_da, opt_da, s_loss = sub_step(p_da, opt_da, p_main, jnp.asarray(s_mels),
                                                    jnp.asarray(s_langs), sub2)
                    traj.append((0.0, float(s_loss)))
                state = state._replace(embedder_params={**p_main, **p_da},
                                       opt_state_da=opt_da)
    return init, traj


def port_trajectory(init, batches, threshold, use_ge2e_backward=True, subroutine_after=None,
                    sub_stream=(), anneal_after=()):
    params, w, b = init
    te = port_embedder(params, torch.float64, dropout=False)
    init_state, step = tge2e.make_ge2e_train_step(te, N, M, lr=LR,
                                                  use_ge2e_backward=use_ge2e_backward,
                                                  da_threshold=threshold)
    state = init_state(tse.GE2ELossParams(w, b))
    assert state.ge2e.w.dtype == torch.float64
    sub_step = tge2e.make_da_subroutine_step()
    traj, gates, lr_scale = [], [], 1.0
    for i, (mels, langs) in enumerate(batches):
        state, loss, da = step(state, mels, langs, False, lr_scale)
        traj.append((float(loss), float(da)))
        gates.append(float(da) < threshold)
        if i in anneal_after:
            lr_scale /= 2
        if i == subroutine_after:
            for s_mels, s_langs in sub_stream:
                traj.append((0.0, float(sub_step(state, s_mels, s_langs))))
    return traj, gates


def _assert_match(got, want, what):
    worst = max(abs(g - w) / max(abs(w), 1e-30) for gs, ws in zip(got, want)
                for g, w in zip(gs, ws) if w)
    print(f"[parity] GE2E trajectory, {what}: {len(got)} steps, largest relative err "
          f"{worst:.3g} (rtol 1e-6, atol 1e-9)")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=f"{what}: step {i}")


def _threshold(batches, use_ge2e_backward):
    """A DA threshold between the observed da values, so the gate toggles."""
    _, traj = jax_trajectory(batches, math.inf, use_ge2e_backward)
    das = sorted(d for _, d in traj)
    return (das[len(das) // 2 - 1] + das[len(das) // 2]) / 2


@pytest.mark.parametrize("case", ["always_gated", "gate_toggles", "ablation_no_ge2e_backward",
                                  "da_subroutine_shares_adam", "lr_anneal"])
def test_ge2e_trajectory_matches(case, chunk_corpus, no_dropout):
    """masg_tpu's five GE2E update-math cases (tests/test_ge2e_train_parity.py:
    255-330), port against masg_tpu, f64, dropout off, batches from both
    packages' SpeakerChunkDataset with one seed."""
    seed = {"always_gated": 1, "gate_toggles": 2, "ablation_no_ge2e_backward": 3,
            "da_subroutine_shares_adam": 4, "lr_anneal": 6}[case]
    batches = _batches(chunk_corpus, seed, 8 if case in ("gate_toggles",
                                                          "ablation_no_ge2e_backward") else 6)
    kw = dict(use_ge2e_backward=case != "ablation_no_ge2e_backward")
    threshold = math.inf
    if case in ("gate_toggles", "ablation_no_ge2e_backward"):
        threshold = _threshold(batches, kw["use_ge2e_backward"])
    if case == "da_subroutine_shares_adam":
        kw.update(subroutine_after=2, sub_stream=_batches(chunk_corpus, 40, 3))
    if case == "lr_anneal":
        kw["anneal_after"] = (2,)
    init, want = jax_trajectory(batches, threshold, **kw)
    got, gates = port_trajectory(init, batches, threshold, **kw)
    if threshold == math.inf:
        assert all(gates)
    else:
        assert any(gates) and not all(gates), f"the gate never toggled (thr={threshold})"
    _assert_match(got, want, case)


def test_evaluate_eer_matches(chunk_corpus):
    je, p = jax_embedder()
    te = port_embedder(p)
    jds, tds = (jge2e.SpeakerChunkDataset(chunk_corpus, ["SYNTH"], m_utts=4,
                                          tisv_frame=T_FRAMES, seed=9),
                tge2e.SpeakerChunkDataset(chunk_corpus, ["SYNTH"], m_utts=4,
                                          tisv_frame=T_FRAMES, seed=9))
    want = jge2e.evaluate_eer(je, p, jds, n_speakers=4, m_utts=4, epochs=3)
    te.train()
    got = tge2e.evaluate_eer(te, tds, n_speakers=4, m_utts=4, epochs=3)
    assert te.training  # the embedder goes back to its mode
    print(f"[parity] evaluate_eer: port {got}, masg_tpu {want}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_da_threshold_and_subroutine_loop(chunk_corpus):
    assert tge2e.compute_da_threshold(32, 10) == jge2e.compute_da_threshold(32, 10)
    assert tge2e.compute_da_threshold(4, 2, 3) == jge2e.compute_da_threshold(4, 2, 3)
    torch.manual_seed(0)
    te = tse.SpeechEmbedder(n_mels=NMELS, hidden=HIDDEN, n_layers=LAYERS, proj=PROJ)
    init_state, _ = tge2e.make_ge2e_train_step(te, 4, M)
    state = init_state()
    _, tds = _datasets(chunk_corpus, 0)
    main_before = [p.detach().clone() for p in te.main_parameters()]
    da_before = [p.detach().clone() for p in te.da_parameters()]
    state = tge2e.run_da_subroutine(state, tds, 4, batches=2, max_epochs=3)
    # the head moved, the trunk did not, and the shared optimizer holds moments
    assert all(torch.equal(a, b) for a, b in zip(main_before, te.main_parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(da_before, te.da_parameters()))
    assert len(state.opt_da.state) == len(da_before) and not state.opt_main.state
    with pytest.raises(FileNotFoundError, match="ge2e_preprocess"):
        tge2e.SpeakerChunkDataset(chunk_corpus, ["NONE"])


def test_train_speech_embedder_cli_checkpoint_loads_in_masg_tpu(tmp_path):
    """`cli.train_speech_embedder --device cpu` at the default width writes the
    reference's torch checkpoint; masg_tpu's `load_ge2e_checkpoint` reads it to
    the same parameters, and so does the port's."""
    from masg_tpu.train.loop import load_ge2e_checkpoint as jax_load_ge2e_checkpoint
    from masg_tpu_torch.cli.train_speech_embedder import main
    from masg_tpu_torch.train.loop import load_ge2e_checkpoint

    rng = np.random.default_rng(7)
    data = tmp_path / "chunks"
    data.mkdir()
    for s in range(4):
        base = rng.normal(size=(80, 150))
        np.save(data / f"synth_s{s}_{'MF'[s % 2]}_{'ja' if s % 2 else 'en'}.npy",
                (base[None] + 0.3 * rng.normal(size=(3, 80, 150))).astype(np.float32))
    out = tmp_path / "out"
    args = ["--data_path", str(data), "--datasets", "SYNTH", "--out_dir", str(out), "-N", "4",
            "-M", "2", "--epochs", "2", "--checkpoint_interval", "1", "--device", "cpu"]
    state = main(args)
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*.pth"))) == [
        "ckpt_epoch_1.pth", "ckpt_epoch_2.pth", "final_epoch_2.pth"]
    path = str(out / "final_epoch_2.pth")
    sd = {k: v for k, v in state.embedder.state_dict().items()}
    # masg_tpu reads it: its folded bias is the sum of the two, equal halves
    je = jse.SpeechEmbedder(n_mels=80)
    jp = jax_load_ge2e_checkpoint(path, je)
    back = ge2e_state_dict_from_jax(_np(jp))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    loaded = load_ge2e_checkpoint(path)
    assert (loaded.hidden, loaded.proj, loaded.n_layers) == (256, 64, 3)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(FileNotFoundError):
        load_ge2e_checkpoint(str(out / "missing.pth"))
    with pytest.raises(ValueError, match="torch format"):
        load_ge2e_checkpoint(str(out))
    with pytest.raises(ValueError, match="no model axis"):  # masg_tpu trains GE2E with n_model=1
        main(args + ["--n_model", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args[:-2])
