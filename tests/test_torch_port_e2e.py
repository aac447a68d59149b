"""The port's slice as a whole on the CPU against masg_tpu: free-running
text -> mel -> int16 wav through synthesize_batch + vocoder_infer (masg_tpu
with flash attention and the fused MRF stages in Pallas interpret mode), and
the port's synthesize CLI on a checkpoint that masg_tpu exports."""

import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from masg_tpu.compat.torch_fs2 import export_torch_checkpoint
from masg_tpu.core import config as jcfg
from masg_tpu.infer import synthesis as jsyn
from masg_tpu.infer import vocoder as jvoc
from masg_tpu.infer.serving import with_duration_bias as jax_with_duration_bias
from masg_tpu.models import FastSpeech2 as JaxFastSpeech2
from masg_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from masg_tpu.models.hifigan import convert_torch_state_dict
from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.infer import synthesis as tsyn
from masg_tpu_torch.infer import vocoder as tvoc
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
import torch_port_support  # noqa: F401  (the port tests' thread count)

# a narrow HiFi-GAN whose two MRF stages (C = 64, 32) both take the fused path
VOC = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
       "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 7, 11],
       "resblock_dilation_sizes": [[1, 3, 5]] * 3, "num_mels": 80}
HOP = 16
MODEL_YAML = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 32,
                              "decoder_hidden": 32, "conv_filter_size": 64},
              "variance_predictor": {"filter_size": 32}, "max_seq_len": 128}
STATS = {"pitch": [-2.0, 9.0, 0.0, 1.0], "energy": [-1.5, 8.0, 0.0, 1.0]}
SPEAKERS = {f"spk{i}": [i, "M", "ja"] for i in range(4)}


def write_config_dir(path):
    for name, body in (("preprocess.yaml", {}), ("model.yaml", MODEL_YAML),
                       ("train.yaml", {"path": {"result_path": str(path / "result")}})):
        (path / name).write_text(yaml.safe_dump(body))
    (path / "stats.json").write_text(json.dumps(STATS))
    (path / "speakers.json").write_text(json.dumps(SPEAKERS))
    (path / "hifigan_config.json").write_text(json.dumps(VOC))
    return str(path)


def jax_fs2(cfg, use_flash):
    model = JaxFastSpeech2.from_config(cfg, use_flash=use_flash)
    ids = jnp.zeros((1, 8), jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(1, jnp.int32), ids,
                           jnp.asarray([8], jnp.int32), 16, accents=ids,
                           speaker_meta=jnp.zeros((1, 4)))
    variables = jax.tree.map(np.asarray, dict(variables))
    return model, jax_with_duration_bias(variables, math.log(5.0))


def batch(seed=0, b=3, length=13):
    rng = np.random.default_rng(seed)
    texts = rng.integers(1, 100, size=(b, length)).astype(np.int32)
    src_lens = np.array([length, 9, 4][:b], np.int32)
    for i in range(b):
        texts[i, src_lens[i]:] = 0
    meta = np.zeros((b, 4), np.float32)
    meta[:, 0] = meta[:, 3] = 1.0
    return {"texts": texts, "src_lens": src_lens,
            "accents": rng.integers(0, 5, size=(b, length)).astype(np.int32),
            "speakers": np.arange(b, dtype=np.int32), "speaker_meta": meta}


def test_text_to_wav_matches_masg_tpu(tmp_path):
    cfg_dir = write_config_dir(tmp_path)
    jc, tc = jcfg.load_config_dir(cfg_dir), tcfg.load_config_dir(cfg_dir)
    jmodel, jvars = jax_fs2(jc, use_flash=True)
    tmodel = tsyn.load_model(tc, device="cpu")
    tmodel.load_state_dict(fs2_state_dict_from_jax(jvars["params"], jvars["batch_stats"], tc),
                           strict=True)

    gen = HiFiGANGenerator(n_mels=80, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                           upsample_initial_channel=128)
    init_random_weights(gen, torch.Generator().manual_seed(0))
    jgen_params = convert_torch_state_dict({k: v.numpy() for k, v in gen.state_dict().items()},
                                           VOC)
    jvocoder = jvoc.Vocoder(JaxGenerator(n_mels=80, upsample_rates=(4, 4),
                                         upsample_kernel_sizes=(8, 8),
                                         upsample_initial_channel=128, fused_mrf=True,
                                         fused_interpret=True),
                            jgen_params, hop_length=HOP)
    tvocoder = tvoc.Vocoder(gen, hop_length=HOP)

    b = batch()
    want = jsyn.synthesize_batch(jmodel, jvars, b, max_mel_len=96)
    got = tsyn.synthesize_batch(tmodel, b, max_mel_len=96)
    np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                  np.asarray(want.duration_rounded))
    mel_len = got.mel_len.numpy()
    np.testing.assert_array_equal(mel_len, np.asarray(want.mel_len))
    assert mel_len.min() > 0
    mel_err = np.abs(got.postnet_mel.numpy() - np.asarray(want.postnet_mel)).max()
    np.testing.assert_allclose(got.postnet_mel.numpy(), np.asarray(want.postnet_mel), atol=2e-4)

    want_wavs = jvoc.vocoder_infer(want.postnet_mel, jvocoder, mel_len * HOP)
    got_wavs = tvoc.vocoder_infer(got.postnet_mel, tvocoder, mel_len * HOP)
    lsb = max(int(np.abs(g.astype(np.int32) - w.astype(np.int32)).max())
              for w, g in zip(want_wavs, got_wavs))
    print(f"[parity] text->wav: max abs postnet_mel err {mel_err:.3g} (bar 2e-4), "
          f"max int16 wav err {lsb} LSB (bar 2)")
    for w, g in zip(want_wavs, got_wavs):
        assert g.dtype == np.int16 and g.shape == w.shape
        assert np.abs(w.astype(np.int32)).max() > 1000  # audio-range, not a few LSB
        # float wavs agree to ~1e-6 (mels within 2e-4 through a unit-gain
        # generator); the int16 cast truncates, so a sample may land 1-2 LSB off
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 2


def test_synthesize_cli_on_a_masg_tpu_checkpoint(tmp_path):
    """masg_tpu exports a reference-format checkpoint; the port's CLI loads it
    strictly on the CPU and reproduces masg_tpu's chunked free-running mel."""
    from masg_tpu_torch.cli.synthesize import main

    cfg_dir = write_config_dir(tmp_path)
    jc = jcfg.load_config_dir(cfg_dir)
    jmodel, jvars = jax_fs2(jc, use_flash=False)
    ckpt = tmp_path / "model.pth.tar"
    # written as `python -m masg_tpu.cli.convert_checkpoint --to_torch` writes it
    sd = export_torch_checkpoint(jvars["params"], jvars["batch_stats"], jc)["model"]
    torch.save({"model": {n: torch.as_tensor(np.ascontiguousarray(a)) for n, a in sd.items()}},
               ckpt)

    phones = "{k o N n i ch i w a sp k o N b a N w a}"
    out_dir = tmp_path / "out"
    main(["-c", cfg_dir, "--checkpoint", str(ckpt), "--device", "cpu", "--phones", phones,
          "--chunk_phones", "8", "--no_vocoder", "--result_path", str(out_dir)])
    (npy,) = glob.glob(str(out_dir / "*.npy"))
    got = np.load(npy)

    from masg_tpu.text import phone_string_to_sequence

    want = jsyn.synthesize_long(jmodel, jvars, phone_string_to_sequence(phones),
                                max_phones=8, max_mel_len=128)
    assert want["n_chunks"] == 3 and want["mel_len"] > 0
    assert got.shape == want["mel"].shape
    print(f"[parity] synthesize CLI on a masg_tpu checkpoint: max abs mel err "
          f"{np.abs(got - want['mel']).max():.3g} (bar 2e-4)")
    np.testing.assert_allclose(got, want["mel"], atol=2e-4)

    # the one-utterance path with the (random, config-sized) vocoder writes a wav
    main(["-c", cfg_dir, "--checkpoint", str(ckpt), "--device", "cpu", "--phones", phones,
          "--result_path", str(out_dir)])
    (wav,) = glob.glob(str(out_dir / "*.wav"))
    assert os.path.getsize(wav) > 44
