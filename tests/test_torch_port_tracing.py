"""The port's tracing (`masg_tpu_torch/utils/profiling.py`) on the CPU: spans
and counters record only while a profiler session or `recording()` is
open; parents and threads; the spans the program opens in FastSpeech2,
`vocoder_infer` and the train step, in order; and outputs, losses and
updated parameters bit-identical with tracing on and off."""

import json
import math
import threading

import numpy as np
import pytest
import torch

from masg_tpu_torch.compat.from_jax import with_duration_bias
from masg_tpu_torch.core.config import (ExperimentConfig, ModelConfig, PreprocessConfig, Stats,
                                        TrainConfig)
from masg_tpu_torch.infer.synthesis import load_model, synthesize_batch
from masg_tpu_torch.infer.vocoder import Vocoder, vocoder_infer
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import batch_to_device, make_train_step
from masg_tpu_torch.utils import profiling
import torch_port_support  # noqa: F401  (the port tests' thread count)

B, L, T, HIDDEN = 2, 9, 40, 64


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def tiny_config(grad_acc_step=1):
    cfg = ExperimentConfig(
        preprocess=PreprocessConfig(), model=ModelConfig(), train=TrainConfig(),
        stats=Stats(pitch=(-3.0, 3.0, 0.0, 1.0), energy=(-3.0, 3.0, 0.0, 1.0)),
        speakers={f"spk{i}": [i, "MF"[i % 2], "ja" if i < 2 else "en"] for i in range(4)})
    tr = cfg.model.transformer
    tr.encoder_layer = tr.decoder_layer = 2
    tr.encoder_hidden = tr.decoder_hidden = HIDDEN
    tr.conv_filter_size = 128
    cfg.model.variance_predictor.filter_size = 64
    cfg.train.optimizer.warm_up_step = 10
    cfg.train.optimizer.grad_acc_step = grad_acc_step
    return cfg


def tiny_model(cfg):
    m = load_model(cfg, device="cpu")
    m.load_state_dict(with_duration_bias(m.state_dict(), math.log(5.0)))  # nonzero durations
    return m


def synth_batch():
    rng = np.random.default_rng(0)
    texts = rng.integers(1, 100, (B, L)).astype(np.int32)
    texts[1, 7:] = 0
    return dict(texts=texts, src_lens=np.array([L, 7], np.int32),
                accents=rng.integers(0, 5, (B, L)).astype(np.int32),
                speakers=np.arange(B, dtype=np.int32),
                speaker_meta=np.zeros((B, 4), np.float32))


def train_batch(seed):
    rng = np.random.default_rng(seed)
    durations = rng.integers(1, 4, size=(B, L)).astype(np.int32)
    meta = np.zeros((B, 4), np.float32)
    meta[:, 0] = meta[:, 2] = 1.0
    return dict(speakers=np.arange(B, dtype=np.int32),
                texts=rng.integers(1, 100, size=(B, L)).astype(np.int32),
                src_lens=np.full(B, L, np.int32),
                accents=rng.integers(0, 5, size=(B, L)).astype(np.int32),
                durations=durations, mel_lens=durations.sum(1).astype(np.int32),
                mels=rng.normal(size=(B, T, 80)).astype(np.float32),
                pitches=rng.normal(size=(B, L)).astype(np.float32),
                energies=rng.normal(size=(B, L)).astype(np.float32), speaker_meta=meta)


def tiny_vocoder():
    gen = HiFiGANGenerator(upsample_initial_channel=32)
    init_random_weights(gen, torch.Generator().manual_seed(1))
    return Vocoder(gen)


def names(spans):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns)]


def test_nothing_is_recorded_when_tracing_is_off():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")  # one shared object, nothing made
    with profiling.span("a", stream_time=torch.ones(1)):
        profiling.count("c", 1)
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_spans_record_under_the_profiler_and_under_recording(how):
    on = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
          if how == "profiler" else profiling.recording())
    with on:
        assert profiling.enabled()
        with profiling.span("outer"):
            with profiling.span("inner", stream_time=torch.ones(1)):
                pass
    with profiling.span("after"):
        pass
    inner, outer = profiling.spans()  # in the order they closed
    assert (outer.name, outer.parent, inner.name, inner.parent) == ("outer", None, "inner",
                                                                    outer.id)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.stream_ms is None  # a CPU tensor's work has no stream


def test_a_span_on_another_thread_is_no_child():
    got = {}

    def work():
        with profiling.span("other"):
            got["ident"] = threading.get_ident()

    with profiling.recording():
        with profiling.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            with profiling.span("child"):
                pass
    assert not t.is_alive()
    by = {s.name: s for s in profiling.spans()}
    assert by["other"].parent is None and by["other"].thread == got["ident"]
    assert by["child"].parent == by["main"].id
    assert by["main"].thread == by["child"].thread == threading.get_ident() != got["ident"]


def test_counters_add_and_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        profiling.count("x", 2)
        profiling.count("x", 5)
        profiling.count("y", 1)
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert profiling.counters() == {"x": 7, "y": 1, "profiling.dropped_spans": 2}
    assert len(profiling.spans()) == 3


def test_trace_shows_the_spans_in_the_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer.block"):
            y = x @ x
    with open(tmp_path / "trace.json") as f:
        events = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert "outer.block" in events and y.shape == (32, 32)
    assert names(profiling.spans()) == ["outer.block"]


def test_synthesize_batch_records_the_variance_adaptor_and_decoder():
    m = tiny_model(tiny_config())
    with profiling.recording():
        out = synthesize_batch(m, synth_batch(), max_mel_len=96)
    sp = profiling.spans()
    assert names(sp) == ["fs2.variance_adaptor", "fs2.length_regulator", "fs2.decoder"]
    by = {s.name: s for s in sp}
    va, lr, dec = by["fs2.variance_adaptor"], by["fs2.length_regulator"], by["fs2.decoder"]
    assert lr.parent == va.id and va.parent is None and dec.parent is None
    assert va.start_ns <= lr.start_ns <= lr.end_ns <= va.end_ns <= dec.start_ns
    assert int(out.mel_len.min()) > 0


@pytest.mark.parametrize("lengths", [None, [3000, 1000]], ids=["untrimmed", "trimmed"])
def test_vocoder_infer_records_the_int16_copy_and_its_samples(lengths):
    voc = tiny_vocoder()
    frames = 16
    with profiling.recording():
        wavs = vocoder_infer(torch.randn(B, frames, 80), voc, lengths)
    assert names(profiling.spans()) == ["vocoder.to_int16"]
    total = B * frames * 256
    assert profiling.counters() == {"vocoder.samples": total,
                                    "vocoder.useful_samples": total if lengths is None
                                    else sum(lengths)}
    assert [len(w) for w in wavs] == ([frames * 256] * B if lengths is None else lengths)


def test_vocoder_infer_counts_the_frames_its_cut_leaves_out():
    voc = tiny_vocoder()
    frames, lengths = 64, [3000, 1000]
    # ceil(3000 / 256) = 12 frames, + R = 14, rounded up to 16s: 32
    t_cut = 32
    with profiling.recording():
        wavs = vocoder_infer(torch.randn(B, frames, 80), voc, lengths)
    assert profiling.counters() == {"vocoder.samples": B * t_cut * 256,
                                    "vocoder.cut_frames": B * (frames - t_cut),
                                    "vocoder.useful_samples": sum(lengths)}
    assert [len(w) for w in wavs] == lengths


@pytest.mark.parametrize("grad_acc_step", [1, 2])
def test_a_train_step_records_its_phases_in_order(grad_acc_step):
    cfg = tiny_config(grad_acc_step)
    m = tiny_model(cfg).train()
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    step = make_train_step(m)
    with profiling.recording():
        for i in range(grad_acc_step):
            step(state, batch_to_device(train_batch(i), "cpu", torch.float32), seed=i)
    sp = profiling.spans()
    top = [s.name for s in sorted(sp, key=lambda s: s.start_ns) if s.parent is None]
    phases = ["data.to_device", "train.forward", "train.backward"]
    assert top == phases * grad_acc_step + ["train.optimizer"]
    # FastSpeech2's own spans open inside the forward
    fwd = {s.id for s in sp if s.name == "train.forward"}
    assert all(s.parent in fwd for s in sp if s.name in ("fs2.variance_adaptor",
                                                          "fs2.decoder"))


def test_outputs_are_bit_identical_with_tracing_on_and_off():
    cfg = tiny_config()
    batch, voc = synth_batch(), tiny_vocoder()

    def synth():
        m = tiny_model(cfg)
        out = synthesize_batch(m, batch, max_mel_len=96)
        return out.postnet_mel, vocoder_infer(out.postnet_mel, voc,
                                              out.mel_len.numpy() * 256)

    def train():
        m = tiny_model(cfg).train()
        state = create_train_state(m, cfg.train.optimizer, HIDDEN)
        step = make_train_step(m)
        losses = [step(state, batch_to_device(train_batch(i), "cpu", torch.float32),
                       seed=i)[1] for i in range(2)]
        return losses, [p.detach().clone() for p in state.params()]

    mel_off, wav_off = synth()
    losses_off, params_off = train()
    with profiling.recording():
        mel_on, wav_on = synth()
        losses_on, params_on = train()
    assert torch.equal(mel_on, mel_off)
    assert all(np.array_equal(a, b) for a, b in zip(wav_on, wav_off))
    for a, b in zip(losses_on, losses_off):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))
    assert len(profiling.spans()) > 0
