"""The plain reference against the program's plain CPU path at tiny widths.
The test imports both; the reference itself imports neither JAX nor
anything of the program (checked here too)."""

import ast

import numpy as np
import torch

from portbench import build, harness, traffic
from portbench.drivers import synth, train
from portbench.reference import fastspeech2 as ref_fs2
from portbench.reference import hifigan as ref_hifigan
from portbench.tests import tiny


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "masg_tpu",
                                               "masg_tpu_torch", "portbench"), (path, n)


def _setup(seed=3):
    config = tiny.config()
    cell = tiny.cell("v1_synth_b16")
    fs2_sd, voc_sd = build.weights(config, seed, "cpu")
    _, langs = build.speakers(config)
    pool = synth._prior_pool(config, cell["traffic"], fs2_sd, seed)
    batches = traffic.synth_batches(seed, cell["traffic"], config["n_symbols"], langs, len(pool))
    synth.calibrate_durations(config, fs2_sd, batches, pool, "cpu")
    return config, cell, fs2_sd, voc_sd, pool, batches


def test_free_running_synthesis_matches_the_program():
    from masg_tpu_torch.infer.synthesis import synthesize_batch

    config, cell, sd, _, pool, batches = _setup()
    model = build.port_fs2(config, sd, "cpu")
    for b in batches[:2]:  # a table batch and a prior batch
        emb = pool[b["who"]] if b["source"] == "prior" else None
        out = synthesize_batch(model, synth.program_batch(config, b, pool), max_mel_len=96,
                               speaker_emb=emb)
        inp = synth._inputs(config, b, pool, sd, "cpu")
        with torch.no_grad():
            r = ref_fs2.infer(sd, config["model"], inp["texts"], inp["src_lens"], inp["accents"],
                              inp["speaker_vec"], 96)
        assert torch.equal(out.duration_rounded.long(), r.duration.long())
        assert torch.equal(out.mel_len.long(), r.mel_len.long())
        assert out.mel_len.float().mean() > 10  # the calibrated durations are not zero
        torch.testing.assert_close(out.postnet_mel, r.postnet_mel, rtol=0, atol=2e-5)


def test_generator_matches_the_program():
    config, _, _, voc_sd, _, _ = _setup()
    vocoder = build.port_vocoder(config, voc_sd, "cpu")
    mel = torch.randn(2, 20, 80, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref_hifigan.generate(voc_sd, config["vocoder"], mel)
    torch.testing.assert_close(vocoder(mel), want, rtol=0, atol=1e-5)


def test_prior_matches_the_program():
    config, _, sd, _, _, _ = _setup()
    model = build.port_fs2(config, sd, "cpu")
    meta = torch.tensor([[1.0, 0, 1, 0], [0.5, 0.5, 0, 1]])
    g = model.speaker_distribution(meta)
    pi, mu, sigma = ref_fs2.gmm(sd, meta, 3)
    for a, b in ((g.pi, pi), (g.mu, mu), (g.sigma, sigma)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_training_steps_match_the_program():
    from masg_tpu_torch.core.config import OptimizerConfig
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import batch_to_device, make_train_step

    ctx = tiny.context("v1_train_fs2_b16")
    config, t = ctx.config, ctx.cell["traffic"]
    sd, _ = build.weights(config, 4, "cpu", vocoder=False)
    model = build.port_fs2(config, sd, "cpu")
    state = create_train_state(model, OptimizerConfig(), 64)
    step = make_train_step(model)
    ds = train._dataset_class()(config, t, 4)
    stream = train._stream(ds, t, 4)
    batches = [next(stream) for _ in range(3)]
    seeds = [harness.seed_int(4, i) for i in range(3)]
    got = []
    for b, s in zip(batches, seeds):
        _, m = step(state, batch_to_device(b, "cpu", torch.float32), s)
        got.append(float(m.total - m.speaker_prior))
    want, _, _ = train.reference_readings(config, sd, batches, seeds, "cpu")
    # dropout on: the same seeded masks on both sides, so the losses agree
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] != got[2]
