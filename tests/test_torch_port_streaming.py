"""The port's streaming vocoder and flax `.msgpack` generator files on the CPU.

`vocode_streaming` must reproduce the one-shot vocode of the whole mel at the
int16 output: interior windows see at least the generator's receptive field
of real context, and the edge windows keep the true utterance edges, so the
generator's own zero padding applies as in the full run (masg_tpu's bar:
at most 1 LSB, under 1 % of samples differ; tests/test_vocoder_streaming.py).
The port's chunks are also held against masg_tpu's `vocode_streaming` on the
same weights (2 LSB), and its measured receptive field against masg_tpu's.

The generator is HiFi-GAN V1 at `upsample_initial_channel=32` (all four MRF
stages take the fused path, the plain K4 on the CPU) with the port's
`init_random_weights` (std 1/sqrt(fan_in)), so the wav keeps an audio-range
level and the receptive field is visible; masg_tpu's fixture boosts its flax
init x3 at 512 channels, which at 32 channels leaves the wav at 1 LSB.

masg_tpu's side compiles one XLA graph per mel length (~10 s each on a CPU),
so every comparison with it runs at the two window lengths of (KJ, CJ), and
tests/test_torch_port_serving.py vocodes at those same lengths through the
same jitted function (`masg_tpu_vocoder` in tests/torch_port_support.py): each
compiles once per process.
"""

import numpy as np
import pytest
import torch

from masg_tpu_torch.infer import vocoder as tvoc
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from torch_port_support import masg_tpu_vocoder

K, C = 192, 24  # masg_tpu's chunk and context frames
KJ, CJ = 128, 128  # against masg_tpu: windows of 256 and 384 frames, its serving caps


@pytest.fixture(scope="module")
def generator():
    gen = HiFiGANGenerator(upsample_initial_channel=32)
    init_random_weights(gen, torch.Generator().manual_seed(0))
    return gen


@pytest.fixture(scope="module")
def vocoder(generator):
    return tvoc.Vocoder(generator)


@pytest.fixture(scope="module")
def jax_vocoder(generator):
    return masg_tpu_vocoder(generator)


def mel_of(t, seed):
    return np.random.default_rng(seed).normal(size=(1, t, 80)).astype(np.float32)


def lsb(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


@pytest.mark.parametrize("t", [700, 576, 193, 100])
def test_streaming_matches_one_shot(vocoder, t):
    """Ragged tail (700), an exact multiple of the chunk (576 = 3 K), a
    barely-two-chunk length (193) and the one-chunk path (100 <= K + 2C)."""
    mel = mel_of(t, t)
    full = tvoc.vocoder_infer(torch.from_numpy(mel), vocoder)[0]
    chunks = list(tvoc.vocode_streaming(vocoder, mel, chunk_frames=K, context_frames=C))
    stream = np.concatenate(chunks)
    assert stream.shape == full.shape and stream.dtype == np.int16
    assert np.abs(full.astype(np.int32)).max() > 1000  # audio-range, not a few LSB
    d = lsb(stream, full)
    print(f"[parity] vocode_streaming vs one-shot, t={t}: max {d.max()} LSB, "
          f"{(d > 0).mean():.3%} of samples differ (bar 1 LSB, < 1 %)")
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    if t > K + 2 * C:
        assert len(chunks) >= 2 and len(chunks[0]) == K * vocoder.hop_length
    else:
        assert len(chunks) == 2


def test_chunks_match_masg_tpu(vocoder, jax_vocoder):
    """The same weights streamed by both packages: the same chunk lengths
    (a first window, interior ones and a right-aligned last one), samples
    within 2 LSB (the int16 cast truncates f32 sums taken in other orders)."""
    import jax.numpy as jnp
    from masg_tpu.infer.vocoder import vocode_streaming as jax_streaming

    mel = mel_of(700, 7)
    got = list(tvoc.vocode_streaming(vocoder, mel, chunk_frames=KJ, context_frames=CJ))
    want = list(jax_streaming(jax_vocoder, jnp.asarray(mel), chunk_frames=KJ,
                              context_frames=CJ))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert len(got) == 5 and len(got[-1]) != len(got[0])
    worst = max(int(lsb(g, w).max()) for g, w in zip(got, want))
    print(f"[parity] vocode_streaming vs masg_tpu's, t=700: {len(got)} chunks, "
          f"max {worst} LSB (bar 2)")
    assert worst <= 2


def test_receptive_field_matches_masg_tpu(generator):
    """The measured field is masg_tpu's integer, cached per Vocoder (both
    probe at the interior window's length); the default context (field + 2)
    streams within the bar."""
    from masg_tpu.infer.vocoder import measure_receptive_field_frames as jax_rf

    voc = tvoc.Vocoder(generator)  # a fresh Vocoder: no cached field yet
    rf = tvoc.measure_receptive_field_frames(voc, probe_frames=KJ + 2 * CJ)
    assert voc._rf_frames == rf
    assert tvoc.measure_receptive_field_frames(voc) == rf  # cached
    want = jax_rf(masg_tpu_vocoder(generator), probe_frames=KJ + 2 * CJ)
    assert rf == want, (rf, want)
    assert 1 <= rf <= 64
    mel = mel_of(500, 3)
    full = tvoc.vocoder_infer(torch.from_numpy(mel), voc)[0]
    stream = np.concatenate(list(tvoc.vocode_streaming(voc, mel, chunk_frames=128)))
    assert lsb(stream, full).max() <= 1


def test_context_below_the_field_diverges(vocoder):
    """The equality above measures the context machinery: with context far
    below the field the interior chunks differ."""
    mel = mel_of(700, 0)
    full = tvoc.vocoder_infer(torch.from_numpy(mel), vocoder)[0]
    stream = np.concatenate(list(tvoc.vocode_streaming(vocoder, mel, chunk_frames=K,
                                                       context_frames=2)))
    assert lsb(stream, full).max() > 1


def test_short_inputs(vocoder):
    """2C < t <= K + 2C streams as two edge-aligned windows of the interior
    shape; t <= 2C vocodes at its own length; an empty mel yields nothing."""
    for t, n_chunks in ((100, 2), (40, 1)):
        mel = mel_of(t, 4)
        full = tvoc.vocoder_infer(torch.from_numpy(mel), vocoder)[0]
        chunks = list(tvoc.vocode_streaming(vocoder, mel, chunk_frames=K, context_frames=C))
        assert len(chunks) == n_chunks, (t, len(chunks))
        stream = np.concatenate(chunks)
        assert stream.shape == full.shape and lsb(stream, full).max() <= 1
    assert list(tvoc.vocode_streaming(vocoder, np.zeros((1, 0, 80), np.float32),
                                      chunk_frames=K, context_frames=C)) == []


def test_invalid_chunk_params(vocoder):
    mel = np.zeros((1, 300, 80), np.float32)
    with pytest.raises(ValueError, match="chunk_frames"):
        next(tvoc.vocode_streaming(vocoder, mel, chunk_frames=0, context_frames=8))
    with pytest.raises(ValueError, match="chunk_frames"):
        next(tvoc.vocode_streaming(vocoder, mel, chunk_frames=8, context_frames=-1))
    with pytest.raises(ValueError, match="single utterance"):
        next(tvoc.vocode_streaming(vocoder, np.zeros((2, 300, 80), np.float32)))


@pytest.mark.parametrize("suffix", [".msgpack", ".pth", ""])
def test_flax_msgpack_generator_loads(tmp_path, generator, jax_vocoder, suffix):
    """A generator file written by flax.serialization.to_bytes (as
    masg_tpu.cli.train_vocoder writes one) loads into the port through
    get_vocoder, whatever its suffix, and gives masg_tpu's wav."""
    import json

    import flax.serialization
    import jax.numpy as jnp
    from masg_tpu.infer.vocoder import vocoder_infer as jax_infer

    from masg_tpu_torch.core.config import ModelConfig

    path = tmp_path / f"generator_10{suffix}"
    path.write_bytes(flax.serialization.to_bytes(jax_vocoder.params))
    (tmp_path / "hifigan_config.json").write_text(json.dumps({"upsample_initial_channel": 32}))
    voc = tvoc.get_vocoder(ModelConfig(), str(tmp_path), checkpoint=str(path), device="cpu")
    sd = voc.generator.state_dict()
    for name, want in generator.state_dict().items():
        torch.testing.assert_close(sd[name], want, atol=0, rtol=0)

    mel = mel_of(KJ + 2 * CJ, 9)  # a window length masg_tpu's vocoder has run
    got = tvoc.vocoder_infer(torch.from_numpy(mel), voc)[0]
    want = jax_infer(jnp.asarray(mel), jax_vocoder)[0]
    print(f"[parity] .msgpack generator{suffix or ' (no suffix)'}: max "
          f"{lsb(got, want).max()} LSB against masg_tpu's wav (bar 2)")
    assert lsb(got, want).max() <= 2


def test_flax_msgpack_chunked_arrays_raise():
    import msgpack

    data = msgpack.packb({"conv_pre_kernel": {"__msgpack_chunked_array__": True,
                                              "shape": {"0": 1}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        tvoc.read_flax_msgpack(data)
