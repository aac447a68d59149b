"""The port's MelGAN vocoder (masg_tpu_torch.models.melgan,
infer/vocoder.py's MelGAN branch) against masg_tpu's: the generator from
masg_tpu's params, a descript-layout torch checkpoint through both loaders,
`get_vocoder`'s checkpoint keys and `mel_scale`, streaming against one-shot,
and `ServingEngine` with a MelGAN vocoder.

No descript checkpoint is in the repository: as tests/test_melgan.py does,
the checkpoint is a torch generator built in descript's module order
(`build_torch_descript_generator`) from a seed. masg_tpu's params come from
the port's seeded weights through masg_tpu's own converter, so no flax init
runs.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.infer.vocoder import Vocoder as JaxVocoder
from masg_tpu.infer.vocoder import get_vocoder as jax_get_vocoder
from masg_tpu.infer.vocoder import measure_receptive_field_frames as jax_receptive_field
from masg_tpu.infer.vocoder import vocoder_infer as jax_vocoder_infer
from masg_tpu.models.melgan import MelGANGenerator as JaxMelGAN
from masg_tpu.models.melgan import convert_torch_state_dict
from masg_tpu_torch.compat.from_jax import melgan_state_dict_from_jax
from masg_tpu_torch.infer.vocoder import (Vocoder, get_vocoder, measure_receptive_field_frames,
                                          vocode_streaming, vocoder_infer)
from masg_tpu_torch.models.melgan import (MelGANGenerator, convert_descript_state_dict,
                                          init_random_weights, reflect_pad)
from test_melgan import build_torch_descript_generator
from torch_port_support import masg_tpu_engine, port_tiny_config

TINY = dict(ngf=8, n_residual_layers=2, ratios=(4, 2))
NARROW = dict(ngf=8)  # descript's structure and hop 256 at 128 -> 8 channels
LN10 = 1.0 / math.log(10.0)


def lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def port_generator(seed=1, **kw):
    gen = MelGANGenerator(**kw)
    init_random_weights(gen, torch.Generator().manual_seed(seed))
    return gen.eval()


def masg_tpu_params(gen):
    """masg_tpu MelGAN params of the port generator `gen`: its state_dict
    is a descript one with plain weights, numbered in descript's order."""
    sd, idx = {}, 2
    own = gen.state_dict()

    def put(prefix, name):
        sd[f"model.{prefix}.weight"] = own[f"{name}.weight"].numpy()
        sd[f"model.{prefix}.bias"] = own[f"{name}.bias"].numpy()

    put(1, "conv_pre")
    for i in range(len(gen.ratios)):
        idx += 1
        put(idx, f"ups.{i}")
        idx += 1
        for j in range(gen.n_residual_layers):
            put(f"{idx}.block.2", f"res.{i}.{j}.conv1")
            put(f"{idx}.block.4", f"res.{i}.{j}.conv2")
            put(f"{idx}.shortcut", f"res.{i}.{j}.shortcut")
            idx += 1
    put(idx + 2, "conv_post")
    return convert_torch_state_dict(sd, gen.ngf, gen.n_residual_layers, gen.ratios)


def speech_like_mel(t, seed=0):
    """A natural-log mel at speech-like levels (-11 .. 2)."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(-5.0, 2.0, size=(2, t, 80)), -11.5, 2.0).astype(np.float32)


@pytest.mark.parametrize("kw", [TINY, NARROW], ids=["tiny", "ngf8"])
def test_generator_from_masg_tpu_params_matches(kw):
    """`melgan_state_dict_from_jax` of masg_tpu's params: the port's wav
    against masg_tpu's, within 1e-5 (T * prod(ratios) samples on both)."""
    params = masg_tpu_params(port_generator(**kw))
    jm = JaxMelGAN(n_mels=80, **kw)
    mel = speech_like_mel(19) * LN10
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(mel)))
    gen = MelGANGenerator(**kw)
    gen.load_state_dict(melgan_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    err = float(np.abs(got - want).max())
    print(f"[parity] MelGAN {kw} from masg_tpu's params: max abs err {err:.3g} (bar 1e-5)")
    assert got.shape == want.shape == (2, 19 * int(np.prod(jm.ratios)))
    assert err <= 1e-5 and np.abs(want).mean() > 1e-3


@pytest.fixture(scope="module")
def descript_checkpoint(tmp_path_factory):
    """A descript-layout generator at the default width (weight norm's
    g and v, `model.<idx>` keys) saved under `model_g`, and its torch model."""
    ref = build_torch_descript_generator(torch)
    with torch.no_grad():  # move g off its init so the fold matters
        for name, p in ref.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(1.0 + 0.1 * torch.rand(p.shape, generator=torch.Generator().manual_seed(0)))
    path = tmp_path_factory.mktemp("melgan") / "melgan.pt"
    torch.save({"model_g": ref.state_dict()}, str(path))
    return str(path), ref


def test_descript_checkpoint_through_both_loaders(descript_checkpoint):
    """The same local descript checkpoint through masg_tpu's and the port's
    `get_vocoder`: the int16 wavs within 1 LSB, both within 1 LSB of the
    descript module itself on the log10 mel."""
    path, ref = descript_checkpoint
    cfg = SimpleNamespace(vocoder=SimpleNamespace(model="MelGAN", speaker="universal"))
    mel = speech_like_mel(11)[:1]
    want = jax_vocoder_infer(jnp.asarray(mel), jax_get_vocoder(cfg, checkpoint=path))[0]
    voc = get_vocoder(cfg, checkpoint=path, device="cpu")
    got = vocoder_infer(torch.from_numpy(mel), voc)[0]
    with torch.no_grad():
        ref_wav = ref(torch.from_numpy(mel * LN10).transpose(1, 2))[0, 0].numpy()
    ref16 = np.clip(ref_wav * 32768.0, -32768, 32767).astype(np.int16)
    print(f"[parity] descript checkpoint: port vs masg_tpu {lsb(got, want)} LSB, port vs "
          f"the descript module {lsb(got, ref16)} LSB (bar 1)")
    assert got.shape == want.shape == (11 * 256,) and got.dtype == np.int16
    assert lsb(got, want) <= 1 and lsb(got, ref16) <= 1
    assert np.abs(want.astype(np.int32)).max() > 100


def test_get_vocoder_keys_scale_and_missing_checkpoint(descript_checkpoint, tmp_path):
    """`mel_scale` is 1/ln 10 for MelGAN and 1 for HiFi-GAN, as masg_tpu's;
    the state_dict loads from under each of `model_g`, `generator`, `netG`,
    `state_dict` or bare, with `mel2wav.` prefixes and plain weights; seeded
    random weights repeat; a missing checkpoint raises."""
    path, ref = descript_checkpoint
    mel_cfg = SimpleNamespace(vocoder=SimpleNamespace(model="MelGAN", speaker="universal"))
    hifi_cfg = SimpleNamespace(vocoder=SimpleNamespace(model="HiFi-GAN", speaker="universal"))
    voc = get_vocoder(mel_cfg, checkpoint=path, device="cpu")
    assert voc.mel_scale == pytest.approx(LN10, rel=1e-15)
    assert voc.mel_scale == jax_get_vocoder(mel_cfg, checkpoint=path).mel_scale
    assert get_vocoder(hifi_cfg, device="cpu").mel_scale == 1.0
    want = voc.generator.state_dict()
    sd, plain = ref.state_dict(), {}  # weight norm folded, under a `mel2wav.` prefix
    for k in sd:
        if k.endswith(".weight_v"):
            p = k[:-len(".weight_v")]
            plain[f"mel2wav.{p}.weight"] = torch._weight_norm(sd[k], sd[p + ".weight_g"], 0)
            plain[f"mel2wav.{p}.bias"] = sd[p + ".bias"]
    assert convert_descript_state_dict(plain).keys() == want.keys()
    for i, payload in enumerate(({"generator": ref.state_dict()}, {"netG": ref.state_dict()},
                                 {"state_dict": ref.state_dict()}, ref.state_dict(), plain)):
        p = tmp_path / f"ckpt{i}.pt"
        torch.save(payload, str(p))
        got = get_vocoder(mel_cfg, checkpoint=str(p), device="cpu").generator.state_dict()
        assert all(torch.allclose(got[k], want[k], rtol=0, atol=1e-6) for k in want), i
    a = get_vocoder(mel_cfg, device="cpu", seed=3).generator.state_dict()
    b = get_vocoder(mel_cfg, device="cpu", seed=3).generator.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(FileNotFoundError, match="not found"):
        get_vocoder(mel_cfg, checkpoint=str(tmp_path / "nope.pt"), device="cpu")


def test_reflect_pad_past_the_length_matches_numpy():
    """A pad at or past the length repeats the reflection as numpy (and so
    masg_tpu's `jnp.pad`) does: a window of one to three frames still runs."""
    for t in (1, 2, 3, 5):
        x = torch.arange(2 * t, dtype=torch.float64).reshape(1, 2, t)
        for pad in (1, 3, 9):
            want = np.pad(x.numpy(), ((0, 0), (0, 0), (pad, pad)), mode="reflect")
            np.testing.assert_array_equal(reflect_pad(x, pad).numpy(), want)


@pytest.fixture(scope="module")
def streaming_vocoder():
    """The default-width MelGAN with seeded random weights behind the port's
    Vocoder (mel_scale 1/ln 10)."""
    return Vocoder(port_generator(seed=2), mel_scale=LN10)


def test_receptive_field_matches_masg_tpu(streaming_vocoder):
    """The measured field (reflection padding inside the probe) is the same
    on masg_tpu's vocoder over the same weights."""
    params = masg_tpu_params(streaming_vocoder.generator)
    jvoc = JaxVocoder(JaxMelGAN(), params, mel_scale=LN10)
    got = measure_receptive_field_frames(streaming_vocoder)
    assert got == jax_receptive_field(jvoc) and 0 < got < 64


@pytest.mark.parametrize("t", [400, 150, 30, 3])
def test_streaming_matches_one_shot(streaming_vocoder, t):
    """`vocode_streaming` against the one-shot vocode within 1 LSB: interior,
    first and final windows (400), the two edge-aligned windows (150), one
    window at its own length (30) and one shorter than the reflection pads
    (3), as tests/test_vocoder_streaming.py:120 holds masg_tpu's."""
    mel = torch.from_numpy(speech_like_mel(t, seed=t)[:1])
    full = vocoder_infer(mel, streaming_vocoder)[0]
    chunks = list(vocode_streaming(streaming_vocoder, mel, chunk_frames=128))
    stream = np.concatenate(chunks)
    print(f"[parity] MelGAN streaming t = {t}: {len(chunks)} chunks, "
          f"{lsb(stream, full)} LSB from one-shot (bar 1)")
    assert stream.shape == full.shape == (t * 256,) and lsb(stream, full) <= 1
    assert np.abs(full.astype(np.int32)).max() > 100


def test_serving_engine_with_melgan_matches_masg_tpu():
    """`ServingEngine` with a MelGAN vocoder (ngf 8) against masg_tpu's
    mel-only engine + its MelGAN vocoder over the full padded mel, trimmed:
    mel_len identical, the wav within 2 LSB."""
    from masg_tpu.infer.serving import with_duration_bias
    from test_fastspeech2 import tiny_config

    from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax
    from masg_tpu_torch.infer.serving import ServingEngine

    gen = port_generator(seed=4, **NARROW)
    jeng = masg_tpu_engine(tiny_config(), vocoder=None, text_buckets=(16,), frames_per_phone=12)
    jeng.variables = with_duration_bias(jax.tree.map(np.asarray, dict(jeng.variables)),
                                        math.log(5.0))
    jvoc = JaxVocoder(JaxMelGAN(**NARROW), masg_tpu_params(gen), mel_scale=LN10)
    cfg = port_tiny_config()
    sd = fs2_state_dict_from_jax(jeng.variables["params"], jeng.variables["batch_stats"], cfg)
    teng = ServingEngine(cfg, state_dict=sd, vocoder=Vocoder(gen, mel_scale=LN10),
                         text_buckets=(16,), frames_per_phone=12, device="cpu")
    ids = list(range(5, 14))
    got = teng.synthesize(ids, speaker_id=1, duration_control=0.5)
    texts, src_lens, acc, _ = jeng._pad_request(ids, None)
    mel, mel_len = jeng._run(texts, src_lens, acc, 1, None, None, (1.0, 1.0, 0.5))
    mel_len = int(np.asarray(mel_len)[0])
    want = jax_vocoder_infer(mel, jvoc, lengths=[mel_len * 256])[0]
    print(f"[parity] ServingEngine with MelGAN: mel_len {got['mel_len']} identical, "
          f"{lsb(got['wav'], want)} LSB (bar 2)")
    assert got["mel_len"] == mel_len > 0 and got["wav"].shape == want.shape
    assert lsb(got["wav"], want) <= 2 and np.abs(want.astype(np.int32)).max() > 100


def test_synthesize_cli_with_melgan(descript_checkpoint, tmp_path):
    """`cli.synthesize` with `vocoder.model: MelGAN` and a local descript
    checkpoint (`--vocoder_checkpoint`) on the CPU writes the wav that the
    port's own one-utterance batch gives through that vocoder (mel_len x 256
    samples, audio-range)."""
    import glob
    import wave

    from masg_tpu_torch.cli.synthesize import main, single_utterance_batch
    from masg_tpu_torch.compat.from_jax import with_duration_bias
    from masg_tpu_torch.core.config import load_config_dir
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus
    from masg_tpu_torch.infer.synthesis import load_model, synthesize_batch
    from masg_tpu_torch.text import phone_string_to_sequence

    tiny = {"transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                            "decoder_hidden": 32, "conv_filter_size": 64},
            "variance_predictor": {"filter_size": 32}, "vocoder": {"model": "MelGAN"}}
    pre = write_preprocessed_corpus(str(tmp_path / "pre"), n_utts=4, n_speakers=2, n_val=2)
    cfg_dir = write_config_dir(str(tmp_path / "cfg"), pre, str(tmp_path / "out"), model=tiny)
    cfg = load_config_dir(cfg_dir)
    model = load_model(cfg, device="cpu")
    model.load_state_dict(with_duration_bias(model.state_dict(), math.log(5.0)))
    ckpt = tmp_path / "model.pth.tar"
    torch.save({"model": model.state_dict()}, str(ckpt))
    phones = "{k o N n i ch i w a}"
    main(["-c", cfg_dir, "--checkpoint", str(ckpt), "--device", "cpu", "--phones", phones,
          "--max_frames", "64", "--result_path", str(tmp_path / "res"),
          "--vocoder_checkpoint", descript_checkpoint[0]])
    (wav_path,) = glob.glob(str(tmp_path / "res" / "*.wav"))
    with wave.open(wav_path) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)

    batch = single_utterance_batch(phone_string_to_sequence(phones), None)
    batch.update(speakers=np.zeros(1, np.int32),
                 speaker_meta=np.zeros((1, cfg.preprocess.speaker_generation.one_hot_dim),
                                       np.float32))
    out = synthesize_batch(model, batch, max_mel_len=64)
    voc = get_vocoder(cfg.model, checkpoint=descript_checkpoint[0], device="cpu")
    mel_len = int(out.mel_len[0])
    want = vocoder_infer(out.postnet_mel, voc, [mel_len * 256])[0]
    assert mel_len > 0 and pcm.shape == want.shape == (mel_len * 256,)
    assert lsb(pcm, want) <= 1 and np.abs(want.astype(np.int32)).max() > 100
