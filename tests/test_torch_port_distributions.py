"""The port's W2 speaker distributions and their CLIs against masg_tpu's, on
the CPU: `exact_emd`, `InterpolateGMM`, `metadata_corners` and `BarycenterGMM`
on the same (pi, mu, sigma) (plans and components within 1e-6), then
`cli.build_distribution` of both packages on the same FastSpeech2 weights
(the `.npz` within 1e-6), `load_distribution` on the reference's pickled
`.pth` and on the `.npz`, and the two example CLIs writing their wavs and
embeddings."""

import glob
import math
import os

import jax
import numpy as np
import pytest
import torch

from masg_tpu.distributions import wasserstein as jw
from masg_tpu.ops.gmm import DiagGMM as JaxGMM
from masg_tpu_torch.distributions import wasserstein as tw
from masg_tpu_torch.ops import gmm as tgmm
import torch_port_support  # noqa: F401  (the port tests' thread count)


def random_gmm(rng, k=3, d=8):
    return (rng.dirichlet(np.ones(k)).astype(np.float32)[None],
            rng.normal(size=(1, k, d)).astype(np.float32),
            rng.uniform(0.3, 1.5, size=(1, k, d)).astype(np.float32))


def both(arrays, batched=True):
    """The same arrays as masg_tpu's and the port's DiagGMM; the port's
    without the leading batch of 1 when not `batched`."""
    t = [torch.from_numpy(a if batched else a[0]) for a in arrays]
    return JaxGMM(*arrays), tgmm.DiagGMM(*t)


def assert_gmm_close(got, want, what):
    for name, g, w in zip(("pi", "mu", "sigma"), got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32 and g.device.type == "cpu"
        assert tuple(g.shape) == np.asarray(w).shape, (what, name)
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= 1e-6, (what, name, err)


def test_exact_emd_matches_masg_tpu():
    rng = np.random.default_rng(1)
    for ka, kb in ((3, 3), (3, 2), (1, 3)):
        a, b = rng.dirichlet(np.ones(ka)), rng.dirichlet(np.ones(kb))
        cost = rng.uniform(0, 5, size=(ka, kb))
        plan = tw.exact_emd(a, b, cost)
        np.testing.assert_allclose(plan, jw.exact_emd(a, b, cost), atol=1e-6, rtol=0)
        np.testing.assert_allclose(plan.sum(axis=1), a, atol=1e-9)
        np.testing.assert_allclose(plan.sum(axis=0), b, atol=1e-9)
        assert (plan * cost).sum() <= (np.outer(a, b) * cost).sum() + 1e-9


@pytest.mark.parametrize("bug", [False, True])
def test_interpolate_matches_masg_tpu(bug):
    rng = np.random.default_rng(2)
    ja, ta = both(random_gmm(rng, k=3))
    jb, tb = both(random_gmm(rng, k=2), batched=False)
    want = jw.InterpolateGMM(ja, jb, reproduce_reference_scale_bug=bug)
    got = tw.InterpolateGMM(ta, tb, reproduce_reference_scale_bug=bug)
    np.testing.assert_allclose(got.ot_plan, want.ot_plan, atol=1e-6, rtol=0)
    for t in (0.0, 0.5, 1.0):
        assert_gmm_close(got.interpolate_rate(t), want.interpolate_rate(t), f"t={t}")
    assert tw.w2sq_diag(ta.mu[0, 0], ta.sigma[0, 0], tb.mu[1], tb.sigma[1]) == pytest.approx(
        jw.w2sq_diag(ja.mu[0, 0], ja.sigma[0, 0], jb.mu[0, 1], jb.sigma[0, 1]), rel=1e-6)


def test_metadata_corners_match_masg_tpu():
    meta = {"gender": {"M": 0, "F": 1}, "language": {"ja": 0, "en": 1, "zh": 2}}
    got, want = tw.metadata_corners(meta), jw.metadata_corners(meta)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rates", [None, [0.7, 0.1, 0.15, 0.05]])
def test_barycenter_matches_masg_tpu(rates):
    rng = np.random.default_rng(5)
    pairs = [both(random_gmm(rng, k=3)) for _ in range(4)]
    want = jw.BarycenterGMM([j for j, _ in pairs], rates=rates)
    got = tw.BarycenterGMM([t for _, t in pairs], rates=rates)
    assert_gmm_close(got.gmm, want.gmm, f"rates={rates}")
    skew = [0.1, 0.2, 0.3, 0.4]
    assert_gmm_close(got.barycenter_rate(skew), want.barycenter_rate(skew), "skew")
    with pytest.raises(ValueError, match="sum"):
        got.barycenter_rate([0.5, 0.5, 0.5, 0.5])


# --- the CLIs on the same weights ----------------------------------------------

MODEL_YAML = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 32,
                              "decoder_hidden": 32, "conv_filter_size": 64},
              "variance_predictor": {"filter_size": 32}, "max_seq_len": 128}
VOC = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
       "upsample_initial_channel": 64, "num_mels": 80}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A config dir, masg_tpu's seeded random FastSpeech2 (what its CLIs load
    at -r 0) with the duration bias ln 5, and the same weights as a
    reference-format checkpoint for the port's --checkpoint."""
    import json

    import yaml
    from masg_tpu.compat.torch_fs2 import export_torch_checkpoint
    from masg_tpu.core.config import load_config_dir
    from masg_tpu.infer.serving import with_duration_bias
    from masg_tpu.infer.synthesis import load_model

    root = tmp_path_factory.mktemp("distri")
    for name, body in (("preprocess.yaml", {}), ("model.yaml", MODEL_YAML),
                       ("train.yaml", {})):
        (root / name).write_text(yaml.safe_dump(body))
    (root / "stats.json").write_text(json.dumps({"pitch": [-2.0, 9.0, 0.0, 1.0],
                                                 "energy": [-1.5, 8.0, 0.0, 1.0]}))
    (root / "speakers.json").write_text(json.dumps(
        {f"spk{i}": [i, "MF"[i % 2], "ja"] for i in range(5)}))
    (root / "hifigan_config.json").write_text(json.dumps(VOC))
    cfg = load_config_dir(str(root))
    model, variables = load_model(cfg, 0)
    variables = jax.tree.map(np.asarray, dict(variables))
    biased = with_duration_bias(variables, math.log(5.0))
    sd = export_torch_checkpoint(biased["params"], biased["batch_stats"], cfg)["model"]
    ckpt = root / "model.pth.tar"
    torch.save({"model": {n: torch.as_tensor(np.ascontiguousarray(a)) for n, a in sd.items()}},
               ckpt)
    return {"dir": str(root), "ckpt": str(ckpt), "cfg": cfg, "model": model,
            "variables": variables, "biased": biased}


@pytest.mark.parametrize("mode", [["--mode", "barycenter"],
                                  ["--mode", "interpolate", "--corner_a", "gender=M",
                                   "language=en", "--corner_b", "gender=F", "--t", "0.3"]])
def test_build_distribution_cli_matches_masg_tpu(tmp_path, weights, mode):
    from masg_tpu.cli.build_distribution import main as jax_main

    from masg_tpu_torch.cli.build_distribution import main

    want_path, got_path = str(tmp_path / "want.npz"), str(tmp_path / "got.npz")
    jax_main(["-c", weights["dir"], *mode, "-o", want_path])
    main(["-c", weights["dir"], "--checkpoint", weights["ckpt"], "--device", "cpu", *mode,
          "-o", got_path])
    want, got = np.load(want_path), np.load(got_path)
    err = max(float(np.abs(got[k] - want[k]).max()) for k in ("pi", "mu", "sigma"))
    print(f"[parity] cli.build_distribution {mode[1]}: {got['pi'].shape[-1]} components, "
          f"max abs err {err:.3g} (bar 1e-6)")
    for k in ("pi", "mu", "sigma"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    assert err <= 1e-6


def test_load_distribution_reads_pth_and_npz(tmp_path):
    from test_torch_distribution_ingest import _make_reference_style_pth

    from masg_tpu_torch.cli.examples_gen_distri import load_distribution

    pth = str(tmp_path / "distri_n_new.pth")
    pi, mu, sigma = _make_reference_style_pth(pth, seed=2)
    gmm = load_distribution(pth)
    for got, want in zip(gmm, (pi, mu, sigma)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

    npz = str(tmp_path / "d.npz")
    np.savez(npz, pi=pi[None], mu=mu[None], sigma=sigma[None])
    gmm = load_distribution(npz)
    np.testing.assert_array_equal(gmm.mu.numpy(), mu[None])
    assert tgmm.sample(gmm, torch.Generator().manual_seed(0)).shape == (1, mu.shape[1])


def _masg_prior(weights, meta):
    from masg_tpu.models import FastSpeech2

    g = weights["model"].apply(weights["variables"], np.asarray(meta, np.float32)[None],
                               method=FastSpeech2.speaker_distribution)
    return tgmm.DiagGMM(*(torch.from_numpy(np.asarray(x)) for x in g))


def test_examples_gen_distri_cli_writes_voices(tmp_path, weights):
    from masg_tpu_torch.cli.build_distribution import main as build
    from masg_tpu_torch.cli.examples_gen_distri import load_distribution, main

    npz = str(tmp_path / "neutral.npz")
    build(["-c", weights["dir"], "--checkpoint", weights["ckpt"], "--device", "cpu",
           "-o", npz])
    out = tmp_path / "out"
    main(["-c", weights["dir"], "--checkpoint", weights["ckpt"], "--device", "cpu",
          "-d", npz, "--n_speakers", "2", "--seed", "3", "--output_path", str(out)])
    wavs = sorted(glob.glob(str(out / "*.wav")))
    assert [os.path.basename(w) for w in wavs] == ["gen001_ja.wav", "gen002_ja.wav"]
    assert all(os.path.getsize(w) > 44 + 2 * 16 for w in wavs)  # mel_len > 0
    gen = torch.Generator().manual_seed(3)
    gmm = load_distribution(npz)
    for i in (1, 2):
        emb = np.load(out / f"gen{i:03d}.npy")
        np.testing.assert_array_equal(emb, tgmm.sample(gmm, gen).reshape(1, -1).numpy())


def test_examples_gen_cli_writes_table_and_prior_voices(tmp_path, weights):
    from masg_tpu_torch.cli.examples_gen import main

    out = tmp_path / "out"
    main(["-c", weights["dir"], "--checkpoint", weights["ckpt"], "--device", "cpu",
          "--output_path", str(out), "--max_real_speakers", "2", "--seed", "5"])
    names = ["spk0", "spk1"] + [f"{g}_{lang}gen001" for lang in ("ja", "en") for g in "MF"]
    for name in names:
        for lang in ("ja", "en"):
            assert os.path.getsize(out / f"{name}_{lang}.wav") > 44 + 2 * 16
    table = weights["biased"]["params"]["speaker_emb"]["embedding"]
    for sid in (0, 1):
        np.testing.assert_array_equal(np.load(out / f"spk{sid}.npy"), table[sid:sid + 1])
    # prior voices: masg_tpu's prior GMM at each corner, sampled with the
    # port's seeded draws (masg_tpu draws from JAX's RNG instead)
    schema = weights["cfg"].preprocess.speaker_generation
    gen = torch.Generator().manual_seed(5)
    for lang in ("ja", "en"):
        for g in "MF":
            prior = _masg_prior(weights, schema.one_hot({"gender": g, "language": lang}))
            want = tgmm.sample(prior, gen).numpy()
            got = np.load(out / f"{g}_{lang}gen001.npy")
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
