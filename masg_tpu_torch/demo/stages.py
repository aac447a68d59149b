"""The demos' stages (port of scripts/demo_full_pipeline.py:61-417 and
scripts/demo_mid_attribute.py:35-137).

Each stage runs one part of the paper's recipe on `device` through the
port's entry points (its CLIs' `main`s where masg_tpu's demo calls a CLI)
and returns what it made and the evidence it gives. `StageClock` stamps
each stage with its wall time and the kernel launches (K1-K4) it made.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# a small HiFi-GAN, a copy of masg_tpu's (scripts/demo_mid_attribute.py:35-49):
# enough to vocode a 4-speaker synthetic corpus in minutes. Its four MRF
# stages run at C = 64, 32, 16 and 8 (kernel K4 on the card). segment_size
# 8192 (32 mel frames, upstream V1's): 16 frames are under the generator's
# receptive field, so boundary effects dominate every training example
DEMO_HIFIGAN = {
    "segment_size": 8192, "hop_size": 256, "n_fft": 1024, "win_size": 1024,
    "num_mels": 80, "sampling_rate": 22050, "fmin": 0, "fmax": 8000,
    "fmax_for_loss": None, "learning_rate": 2e-4, "adam_b1": 0.8,
    "adam_b2": 0.99, "lr_decay": 0.999, "batch_size": 8,
    "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 7],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
    "mpd_periods": [2, 3, 5], "mpd_channels": [8, 16, 32, 32],
    "msd_scales": 2,
    "msd_layers": [[16, 15, 1, 1], [32, 41, 4, 4], [32, 5, 1, 1]],
}

DATASET = "SYNTH"
PHONES_JA = "{a o i e u m a n o s a t e}"


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the kernel wrappers K1-K4."""
    from ..ops.attention import flash_attention, flash_attention_dkv, flash_attention_dq
    from ..ops.fused_mrf import fused_mrf_stage

    return {"K1": flash_attention.launches, "K2": flash_attention_dq.launches,
            "K3": flash_attention_dkv.launches, "K4": fused_mrf_stage.launches}


class StageClock:
    """Wall time since the start, and K1-K4 launches, of each stage."""

    def __init__(self):
        self.t0 = time.time()
        self.stages: List[list] = []  # [name, seconds since the start, launches]
        self._seen = kernel_launches()

    def mark(self, name: str) -> None:
        now = kernel_launches()
        launches = {k: now[k] - self._seen[k] for k in now}
        self._seen = now
        self.stages.append([name, time.time() - self.t0, launches])
        print(f"[demo +{self.stages[-1][1]:7.1f}s] {name}", flush=True)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def build_corpus(out: str, *, n_speakers: int = 4, utts_per_speaker: int = 20,
                 fs2_steps: int = 800, voice_variation: bool = True, log_step: int = 100,
                 hifigan: Optional[dict] = None, device: str = "cuda") -> str:
    """Stage 1: a bilingual vocal corpus over the (gender x language) corners
    (8 phones, ~1.1 s, an utterance), `cli.preprocess` on `device`, and its
    config dir (batch 8, total_step and save_step `fs2_steps`), with
    `hifigan` (default DEMO_HIFIGAN) written as its hifigan_config.json. A
    config dir that already holds stats.json is reused. Returns the config
    dir."""
    from ..data.synthetic import build_synthetic_experiment_dir

    cfg_dir = os.path.join(out, "config")
    if not os.path.exists(os.path.join(cfg_dir, "stats.json")):
        assert n_speakers % 4 == 0, n_speakers
        build_synthetic_experiment_dir(
            out, n_speakers=n_speakers, utts_per_speaker=utts_per_speaker, style="vocal",
            languages=("ja", "ja", "en", "en"), voice_variation=voice_variation, batch_size=8,
            group_size=1, total_step=max(fs2_steps, 1), log_step=log_step, val_step=10**9,
            synth_step=10**9,
            save_step=max(fs2_steps, 1), warm_up_step=100, device=device)
    with open(os.path.join(cfg_dir, "hifigan_config.json"), "w") as f:
        json.dump(hifigan or DEMO_HIFIGAN, f)
    return cfg_dir


def ge2e_chunks(out: str) -> Tuple[Dict[str, Tuple[List[str], str, str]], str, Dict[str, int]]:
    """Stage 2: GE2E chunk archives. A chunk needs >= 150 frames (1.74 s) of
    contiguous speech in one VAD span and the utterances are ~1.1 s, so each
    speaker's voiced spans are concatenated into one wav first (speaker
    identity is what the chunks keep, not utterance boundaries). Returns
    (speaker -> ([its concatenated wav], gender, language), the chunk dir,
    chunks per archive)."""
    from ..audio.wavio import read_wav, write_wav
    from ..preprocessor.ge2e_preprocess import build_ge2e_corpus, energy_split

    wav_root = os.path.join(out, "raw_data", DATASET)
    with open(os.path.join(out, "preprocessed_data", DATASET, "speakers.json")) as f:
        speakers = json.load(f)
    spk_map = {spk: (sorted(glob.glob(os.path.join(wav_root, spk, "*.wav"))), gender, lang)
               for spk, (_sid, gender, lang) in speakers.items()}
    cat_dir = os.path.join(out, "ge2e_cat_wavs")
    os.makedirs(cat_dir, exist_ok=True)
    for spk, (paths, gender, lang) in list(spk_map.items()):
        voiced = []
        for p in paths:
            wav = np.asarray(read_wav(p)[0], np.float32)
            voiced += [wav[s:e] for s, e in energy_split(wav)]
        cat = os.path.join(cat_dir, f"{spk}.wav")
        write_wav(cat, np.concatenate(voiced), 22050)
        spk_map[spk] = ([cat], gender, lang)
    ge2e_data = os.path.join(out, "ge2e_chunks")
    written = build_ge2e_corpus(spk_map, ge2e_data, dataset=DATASET,
                                stride=75)  # ~25 chunks per speaker
    n_chunks = {f: int(np.load(os.path.join(ge2e_data, f)).shape[0]) for f in written}
    return spk_map, ge2e_data, n_chunks


def train_ge2e(out: str, ge2e_data: str, epochs: int = 40, batches_per_epoch: int = 8,
               device: str = "cuda") -> Tuple[List[float], str]:
    """Stage 3 (the paper's stage 1): `cli.train_speech_embedder`, N x M = 4 x
    4, the DA gate live for the second half. Returns (the GE2E loss of every
    epoch, from its `Epoch n: avg ge2e` lines; the final checkpoint)."""
    from ..cli.train_speech_embedder import main as train_embedder

    enc_dir = os.path.join(out, "spk_enc")
    cap = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, cap)):
        train_embedder([
            "--data_path", ge2e_data, "--datasets", DATASET, "--out_dir", enc_dir,
            "-N", "4", "-M", "4", "--epochs", str(epochs),
            "--batches_per_epoch", str(batches_per_epoch),
            "--da_startpoint", "0.5", "--checkpoint_interval", str(epochs), "--seed", "0",
            "--device", device])
    losses = [float(line.split("avg ge2e")[1].split()[0])
              for line in cap.getvalue().splitlines() if line.startswith("Epoch ")]
    assert losses, "no GE2E epoch losses captured"
    return losses, os.path.join(enc_dir, f"final_epoch_{epochs}.pth")


def ge2e_eer(checkpoint: str, ge2e_data: str, epochs: int = 10,
             device: str = "cuda") -> Tuple[float, float]:
    """The trained encoder's speaker-verification EER over the training
    speakers, enrollment and verification split across chunks (a degenerate
    embedder scores ~0.5). Returns (EER, threshold)."""
    from ..device import resolve_device
    from ..train.ge2e import SpeakerChunkDataset, evaluate_eer
    from ..train.loop import load_ge2e_checkpoint

    embedder = load_ge2e_checkpoint(checkpoint).to(resolve_device(device))
    ds = SpeakerChunkDataset(ge2e_data, [DATASET], m_utts=10, seed=1)
    eer, thresh = evaluate_eer(embedder, ds, n_speakers=len(ds), m_utts=10, epochs=epochs)
    return float(eer), float(thresh)


def pretrain_fs2(cfg_dir: str, steps: int, device: str = "cuda") -> str:
    """Stage 4: `cli.train` (plain multi-speaker FastSpeech2 + the TacoSpawn
    prior) for `steps`. Returns its checkpoint dir."""
    import yaml

    from ..cli.train import main as train_main

    train_main(["-c", cfg_dir, "--max_steps", str(steps), "--seed", "0", "--device", device])
    with open(os.path.join(cfg_dir, "train.yaml")) as f:
        return yaml.safe_load(f)["path"]["ckpt_path"]


def finetune_clf(out: str, cfg_dir: str, discriminator: str, pretrain_ckpt: str,
                 steps: int, lambd: float = 1.0,
                 device: str = "cuda") -> Tuple[str, List[Tuple[int, float]]]:
    """Stage 5 (the paper's stage 2): `cli.train --use_clf` at one lambda,
    warm-started from the pretrain's latest checkpoint, against the stage-3
    encoder (`discriminator_path`), in a copy of the config dir with fresh
    log and checkpoint paths. Returns (that config dir, the logged
    discriminator BCE as (step, value))."""
    import yaml

    from ..cli.train import main as train_main

    clf_cfg_dir = os.path.join(out, "config_langemb")
    os.makedirs(clf_cfg_dir, exist_ok=True)
    for f in os.listdir(cfg_dir):
        shutil.copy(os.path.join(cfg_dir, f), os.path.join(clf_cfg_dir, f))
    with open(os.path.join(cfg_dir, "train.yaml")) as f:
        train_yaml = yaml.safe_load(f)
    train_yaml["discriminator_path"] = discriminator
    train_yaml["lambda"] = lambd
    train_yaml["path"] = dict(train_yaml["path"],
                              ckpt_path=os.path.join(out, "out_clf", "ckpt"),
                              log_path=os.path.join(out, "out_clf", "log"))
    train_yaml["step"] = dict(train_yaml["step"], total_step=steps, log_step=min(50, steps),
                              save_step=steps)
    with open(os.path.join(clf_cfg_dir, "train.yaml"), "w") as f:
        yaml.dump(train_yaml, f)
    # the port's --checkpoint is a run's checkpoint dir: its latest step (the
    # pretrain's last) warm-starts the model
    train_main(["-c", clf_cfg_dir, "--use_clf", "--checkpoint", pretrain_ckpt,
                "--max_steps", str(steps), "--seed", "0", "--device", device])
    dl = []
    with open(os.path.join(out, "out_clf", "log", "train", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "Loss/language_classification_loss":
                dl.append((int(rec["step"]), float(rec["value"])))
    return clf_cfg_dir, dl


def clf_liveness(out: str, clf_cfg_dir: str, pretrain_ckpt: str,
                 device: str = "cuda") -> float:
    """The adversarial branch's liveness: one `--use_clf` step from the same
    warm start at lambda 0 and at lambda 1000, on the same batch with the same
    seed; every difference between the two updated FastSpeech2s flows through
    the discriminator term. (masg_tpu's demo proves the branch live this way
    because on its first corpus the frozen encoder, trained on raw-audio
    log-mels, gave the model's feature mels near-zero logits, as in the
    reference, train.py:181-184; on the voice-varied corpus its BCE falls.)
    Returns the largest parameter difference."""
    from ..core.config import load_config_dir
    from ..train.loop import build_experiment

    params = {}
    for lam in (0.0, 1000.0):
        cfg = load_config_dir(clf_cfg_dir)
        cfg.train.lambda_ = lam
        cfg.train.path.ckpt_path = os.path.join(out, f"out_abl{int(lam)}", "ckpt")
        cfg.train.path.log_path = os.path.join(out, f"out_abl{int(lam)}", "log")
        tr = build_experiment(cfg, use_clf=True, seed=0, checkpoint=pretrain_ckpt,
                              device=device)
        batch = next(iter(tr.train_loader))[0]
        metrics = tr.train_on(batch, step=1)
        assert np.isfinite(float(metrics.total)), float(metrics.total)
        params[lam] = [p.detach().float().cpu() for p in tr.model.parameters()]
    return max(float((a - b).abs().max()) for a, b in zip(params[0.0], params[1000.0]))


def train_vocoder(out: str, cfg_dir: str, steps: int, log_step: int = 200,
                  device: str = "cuda", save_step: Optional[int] = None,
                  restore: Optional[str] = None) -> str:
    """Stage 6: `cli.train_vocoder` on the corpus wavs with the config dir's
    hifigan_config.json (the vocoder trains with the plain MRF; K4 has no
    backward), into <out>/vocoder, checkpoints every `save_step` (default
    `steps`), resuming from `restore` (a `vocoder_{step}.pth.tar`) when
    given. Returns the exported generator checkpoint of step `steps`."""
    from ..cli.train_vocoder import main as train_vocoder_main

    voc_out = os.path.join(out, "vocoder")
    train_vocoder_main(["--wav_dir", os.path.join(out, "raw_data", DATASET), "--out", voc_out,
                        "--config", os.path.join(cfg_dir, "hifigan_config.json"),
                        "--steps", str(steps), "--save_step", str(save_step or steps),
                        "--log_step", str(log_step), "--seed", "0", "--device", device]
                       + (["--restore", restore] if restore else []))
    return os.path.join(voc_out, f"generator_{steps}.pth.tar")


def vocode_ground_truth(generator_ckpt: str, hifigan: dict, wavs: Sequence[str],
                        device: str = "cuda") -> List[Tuple[np.ndarray, np.ndarray,
                                                            np.ndarray, np.ndarray]]:
    """Vocode the ground-truth mel of each wav (peak-normalized to 0.95, as
    the vocoder trained) through the generator, K4 in every MRF stage on the
    card. Returns per wav (ground truth, its mel, the output, its mel), on
    the host."""
    import torch

    from ..audio.wavio import read_wav
    from ..device import resolve_device
    from ..infer.vocoder import Vocoder, build_generator, load_generator_checkpoint
    from ..train.vocoder import mel_spectrogram_hifigan

    dev = resolve_device(device)
    gen = build_generator(hifigan)
    gen.load_state_dict(load_generator_checkpoint(generator_ckpt, hifigan), strict=True)
    hop = int(hifigan["hop_size"])
    voc = Vocoder(gen.to(dev), hop_length=hop)

    def mel(audio):
        return mel_spectrogram_hifigan(
            audio[None], n_fft=hifigan["n_fft"], hop_length=hop,
            win_length=hifigan["win_size"], n_mels=hifigan["num_mels"],
            sample_rate=hifigan["sampling_rate"], f_min=hifigan["fmin"],
            f_max=hifigan["fmax"])

    rows = []
    with torch.inference_mode():
        for path in wavs:
            wav = np.asarray(read_wav(path)[0], np.float32)
            wav = wav * (0.95 / max(float(np.abs(wav).max()), 1e-9))
            wav = wav[: len(wav) // hop * hop]
            gt_mel = mel(torch.from_numpy(wav).to(dev))
            out = voc(gt_mel)[0].float()
            rows.append((wav, gt_mel[0].cpu().numpy(), out.cpu().numpy(),
                         mel(out)[0].cpu().numpy()))
    return rows


def copy_synthesis(generator_ckpt: str, hifigan: dict, wavs: Sequence[str],
                   device: str = "cuda") -> Tuple[List[float], List[float]]:
    """`vocode_ground_truth`. Returns (the peak of each output, its MCD in dB
    against the ground truth)."""
    from ..utils.mcd import mcd

    rows = vocode_ground_truth(generator_ckpt, hifigan, wavs, device)
    return ([float(np.abs(out).max()) for _, _, out, _ in rows],
            [mcd(gt_mel, out_mel) for _, gt_mel, _, out_mel in rows])


def build_distributions(out: str, cfg_dir: str, step: int,
                        device: str = "cuda") -> Dict[str, str]:
    """Stage 7a: `cli.build_distribution` from the model at `step`: the W2
    interpolation of the M/ja and F/ja corners at t = 0.5, and the W2
    barycenter of all four corners. Returns {"interp", "barycenter"} ->
    .npz path."""
    from ..cli.build_distribution import main as build_distribution

    npz = {"interp": os.path.join(out, "interp_M_F_ja.npz"),
           "barycenter": os.path.join(out, "barycenter_all.npz")}
    build_distribution(["-c", cfg_dir, "-r", str(step), "--mode", "interpolate",
                        "--corner_a", "gender=M", "language=ja",
                        "--corner_b", "gender=F", "language=ja",
                        "--t", "0.5", "-o", npz["interp"], "--device", device])
    build_distribution(["-c", cfg_dir, "-r", str(step), "--mode", "barycenter",
                        "-o", npz["barycenter"], "--device", device])
    return npz


def synthesize_wavs(out: str, cfg_dir: str, step: int, npz: Dict[str, str],
                    generator_ckpt: str, n_speakers: int = 3,
                    device: str = "cuda") -> Dict[str, Dict[str, np.ndarray]]:
    """Stage 7b: `cli.examples_gen_distri` samples `n_speakers` new voices
    from each distribution and speaks a Japanese phrase with each through the
    trained vocoder. Returns {mode: {wav name: float audio}}."""
    from ..audio.wavio import read_wav
    from ..cli.examples_gen_distri import main as examples_gen_distri

    wavs = {}
    for name, path in npz.items():
        out_dir = os.path.join(out, f"wavs_{name}")
        examples_gen_distri(["-c", cfg_dir, "-r", str(step), "-d", path,
                             "--n_speakers", str(n_speakers), "--output_path", out_dir,
                             "--vocoder_checkpoint", generator_ckpt,
                             "--phones_ja", PHONES_JA, "--seed", "0", "--device", device])
        wavs[name] = {w: np.asarray(read_wav(os.path.join(out_dir, w))[0], np.float32)
                      for w in sorted(f for f in os.listdir(out_dir) if f.endswith(".wav"))}
    return wavs


def f0_gender_scores(spk_map: Dict[str, Tuple[List[str], str, str]],
                     wavs: Dict[str, Dict[str, np.ndarray]]) -> Tuple[dict, Dict[str, list]]:
    """Stage 8: each demo wav's mean voiced F0 placed between the corpus's
    corner means, 0 at M and 1 at F: a mid-attribute voice lands between
    them. Returns ({"M": Hz, "F": Hz}, {mode: [score per wav]})."""
    from ..audio.wavio import read_wav
    from ..eval.attribute_probe import mean_voiced_f0

    gt = {"M": [], "F": []}
    for paths, gender, _lang in spk_map.values():
        gt[gender].append(mean_voiced_f0(np.asarray(read_wav(paths[0])[0], np.float64)))
    f0_m, f0_f = float(np.mean(gt["M"])), float(np.mean(gt["F"]))
    scores = {name: [round(float((mean_voiced_f0(np.asarray(w, np.float64)) - f0_m)
                                 / (f0_f - f0_m)), 3) for w in ws.values()]
              for name, ws in wavs.items()}
    return {"M": f0_m, "F": f0_f}, scores
