"""The PyTorch port stands alone: it imports neither JAX nor masg_tpu, its
entry points refuse to run without a card unless asked for the CPU, and its
kernel loader raises where nvcc is absent instead of falling back."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "masg_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "masg_tpu")


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_masg_tpu_imports_in_sources():
    offenders = [(os.path.relpath(p, REPO), root) for p in _port_sources()
                 for root in _imported_roots(p) if root in FORBIDDEN]
    assert offenders == []


def test_every_module_imports_with_jax_and_masg_tpu_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import masg_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(masg_tpu_torch.__path__, "
        "'masg_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n"
        "print(len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    *_, names, count = r.stdout.strip().splitlines()
    assert int(count) >= 85
    for sub in ("preprocessor.ge2e_preprocess", "eval.attribute_probe", "train.ge2e",
                "models.speaker_encoder", "cli.train_speech_embedder", "cli.train_ganlike",
                "models.hifigan_disc", "train.vocoder", "data.vocoder", "cli.train_vocoder",
                "cli.dump_mels", "cli.preprocess", "audio.f0_native",
                "preprocessor.textgrid", "preprocessor.preprocessor", "models.jdit",
                "models.melgan", "preprocessor.alignments", "cli.retrieve", "cli.gather",
                "cli.make_config", "cli.prepare_alignments", "cli.graph2phone_lab",
                "cli.jvs_speakers", "parallel.distributed", "parallel.mesh", "parallel.tensor",
                "utils.profiling", "utils.mcd", "compat.torch_order"):
        assert f"masg_tpu_torch.{sub}" in names.split(), sub


def _tiny_cfg():
    from masg_tpu_torch.core.config import (ExperimentConfig, ModelConfig,
                                            PreprocessConfig, Stats, TrainConfig)

    cfg = ExperimentConfig(preprocess=PreprocessConfig(), model=ModelConfig(),
                           train=TrainConfig(), stats=Stats(),
                           speakers={"a": [0, "M", "ja"], "b": [1, "F", "ja"]})
    tr = cfg.model.transformer
    tr.encoder_layer = tr.decoder_layer = 1
    tr.encoder_hidden = tr.decoder_hidden = 32
    tr.conv_filter_size = 64
    cfg.model.variance_predictor.filter_size = 32
    return cfg


def test_entry_points_need_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from masg_tpu_torch.infer.synthesis import load_model
    from masg_tpu_torch.infer.vocoder import get_vocoder

    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_vocoder(cfg.model)
    model = load_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"

    from masg_tpu_torch.infer.serving import ServingEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, vocoder=None)
    engine = ServingEngine(cfg, vocoder=None, text_buckets=(16,), device="cpu")
    assert engine.device.type == "cpu"

    # the distribution CLIs run on the CPU when asked (cli.serve's engine is
    # the ServingEngine above; its main blocks in serve_forever)
    import json

    import yaml

    from masg_tpu_torch.cli import build_distribution, examples_gen, examples_gen_distri

    tiny = {"transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                            "decoder_hidden": 32, "conv_filter_size": 64},
            "variance_predictor": {"filter_size": 32}, "max_seq_len": 64}
    for name, body in (("preprocess.yaml", {}), ("model.yaml", tiny), ("train.yaml", {})):
        (tmp_path / name).write_text(yaml.safe_dump(body))
    (tmp_path / "speakers.json").write_text(json.dumps({"a": [0, "M", "ja"]}))
    cpu = ["-c", str(tmp_path), "--device", "cpu"]
    build_distribution.main([*cpu, "-o", str(tmp_path / "d.npz")])
    examples_gen_distri.main([*cpu, "--no_vocoder", "-d", str(tmp_path / "d.npz"),
                              "--n_speakers", "1", "--output_path", str(tmp_path / "o1")])
    examples_gen.main([*cpu, "--no_vocoder", "--output_path", str(tmp_path / "o2")])
    assert (tmp_path / "o1" / "gen001.npy").exists()
    assert (tmp_path / "o2" / "a.npy").exists() and (tmp_path / "o2" / "F_engen001.npy").exists()


def test_cli_device_flag_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import json

    from masg_tpu_torch.cli import (build_distribution, dump_mels, examples_gen,
                                    examples_gen_distri, preprocess, serve, speaker_gen,
                                    train_vocoder)

    for name in ("preprocess.yaml", "model.yaml", "train.yaml"):
        (tmp_path / name).write_text("{}\n")
    (tmp_path / "speakers.json").write_text(json.dumps({"a": [0, "M", "ja"]}))
    out = tmp_path / "out"
    cases = [
        (speaker_gen, ["-o", str(out / "spk.npy")]),
        (serve, ["--port", "0"]),
        (build_distribution, ["-o", str(out / "d.npz")]),
        (examples_gen, ["--output_path", str(out)]),
        (examples_gen_distri, ["-d", str(out / "d.npz"), "--output_path", str(out)]),
    ]
    for cli, args in cases:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-c", str(tmp_path), *args])
    for cli, args in ((dump_mels, ["-c", str(tmp_path), "--restore_step", "1", "--out",
                                   str(out)]),
                      (preprocess, ["--config", str(tmp_path)]),
                      (train_vocoder, ["--wav_dir", str(tmp_path), "--out", str(out)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
    assert not out.exists()


def test_unported_flags_raise_not_implemented():
    """JDIT and MelGAN (queue 1 item 11) build, and so do data and tensor
    parallelism (item 12: `--n_devices`, `--multihost`, `--data_parallel`,
    `--n_model`). The GE2E and vocoder trainers refuse `--n_model > 1`: masg_tpu
    trains them with no model axis. `--n_model 2` with too few devices raises
    instead of running on one."""
    from masg_tpu_torch.infer.vocoder import get_vocoder
    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.models.melgan import MelGANGenerator

    cfg = _tiny_cfg()
    cfg.model.jdit.use_jdit = True
    assert FastSpeech2.from_config(cfg).jdit is not None
    cfg.model.vocoder.model = "MelGAN"
    voc = get_vocoder(cfg.model, device="cpu")
    assert isinstance(voc.generator, MelGANGenerator)

    from masg_tpu_torch.cli.train_speech_embedder import main as train_speech_embedder
    from masg_tpu_torch.cli.train_vocoder import main as train_vocoder

    with pytest.raises(ValueError, match="no model axis"):
        train_vocoder(["--wav_dir", "unused", "--out", "unused", "--device", "cpu",
                       "--n_devices", "2", "--n_model", "2"])
    with pytest.raises(ValueError, match="no model axis"):
        train_speech_embedder(["--data_path", "unused", "--out_dir", "unused", "--device",
                               "cpu", "--n_model", "2"])
    import argparse

    from masg_tpu_torch.parallel.mesh import launch_data_parallel

    args = argparse.Namespace(n_model=2, n_devices=1, multihost=False, device="cpu")
    with pytest.raises(ValueError, match="--n_model 2 needs 2 devices"):
        launch_data_parallel(print, args, 4)


def test_kernel_loader_raises_without_nvcc():
    from masg_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here: the kernels can be built")
    for name in _build.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)


def test_cpu_tensors_take_the_plain_path_without_counting():
    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dq)
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage

    def counts():
        return (flash_attention.launches, flash_attention_dq.launches,
                flash_attention_dkv.launches, fused_mrf_stage.launches)

    before = counts()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention(q, q, q, torch.tensor([5])).sum().backward()
    bp = {f"{c}_0_kernel": torch.randn(3, 32, 32) for c in ("convs1", "convs2")}
    bp.update({f"{c}_0_bias": torch.zeros(32) for c in ("convs1", "convs2")})
    fused_mrf_stage(torch.randn(1, 20, 32), [bp], (3,), ((1,),))
    assert counts() == before
