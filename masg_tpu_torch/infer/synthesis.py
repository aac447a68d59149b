"""Shared synthesis helpers for the inference CLIs (port of
masg_tpu/infer/synthesis.py).

Reference: synthesize.py:104-131 (forward + synth_samples), utils/tools.py
:228-274 (per-utterance figure + wav writing), utils/model.py:11-34
(get_model checkpoint restore).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import ExperimentConfig
from ..device import DeviceLike, resolve_device
from ..models.fastspeech2 import FastSpeech2, FS2Output
from ..ops.length_regulator import expand_scalars
from ..text import NO_ACCENT_ID
from ..text.symbols import symbols
from .vocoder import Vocoder, vocoder_infer


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def load_model(cfg: ExperimentConfig, checkpoint: Optional[str] = None,
               device: DeviceLike = None, dtype: torch.dtype = torch.float32,
               use_flash: bool = True, seed: int = 0, restore_step: int = 0) -> FastSpeech2:
    """FastSpeech2 in eval mode on `device` (the card when None), with the
    weights the experiment's own training saved at `restore_step` (its
    `cfg.train.path.ckpt_path`, model only, as masg_tpu's `load_model(cfg,
    restore_step)`), or those of a reference-format checkpoint file
    (`{"model": state_dict}`, e.g. `python -m masg_tpu.cli.convert_checkpoint
    --to_torch`), or seeded random weights without either (reference
    get_model(train=False), utils/model.py:11-34)."""
    if checkpoint and restore_step:
        raise ValueError("load_model takes a checkpoint file or a restore_step, not both")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FastSpeech2.from_config(cfg, use_flash=use_flash)
    sd = None
    if restore_step:
        from ..core.checkpoint import CheckpointManager

        sd = CheckpointManager(cfg.train.path.ckpt_path).model_state_dict(restore_step)
    elif checkpoint:
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        sd = ckpt.get("model", ckpt)
    if sd is not None:
        # strip DataParallel 'module.' prefixes (reference train.py:272-275)
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        model.load_state_dict(sd, strict=True)
    return model.to(dev, dtype).eval()


def _model_dtype(model: FastSpeech2) -> torch.dtype:
    return model.mel_linear.weight.dtype


@torch.inference_mode()
def synthesize_batch(model: FastSpeech2, batch: Dict[str, np.ndarray],
                     p_control: float = 1.0, e_control: float = 1.0,
                     d_control: float = 1.0, max_mel_len: int = 1000,
                     speaker_emb: Optional[np.ndarray] = None) -> FS2Output:
    """Free-running forward. batch: texts/src_lens/accents + speakers
    + speaker_meta (or an explicit speaker_emb matrix); numpy arrays."""
    dev = model.mel_linear.weight.device
    dtype = _model_dtype(model)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

    texts, src_lens = ids(batch["texts"]), ids(batch["src_lens"])
    accents = ids(batch["accents"]) if batch.get("accents") is not None else None
    if speaker_emb is not None:
        emb = torch.as_tensor(np.asarray(speaker_emb), device=dev, dtype=dtype)
        return model.synthesize_from_speaker_emb(
            texts, src_lens, max_mel_len, emb, p_control=p_control,
            e_control=e_control, d_control=d_control, accents=accents)
    meta = torch.as_tensor(np.asarray(batch["speaker_meta"]), device=dev, dtype=dtype)
    return model(ids(batch["speakers"]), texts, src_lens, max_mel_len,
                 p_control=p_control, e_control=e_control, d_control=d_control,
                 accents=accents, speaker_meta=meta)


def pause_phone_ids():
    """Ids of silence/pause symbols (@sp/@spn/@sil + bare 'sp')."""
    return frozenset(i for i, s in enumerate(symbols)
                     if s in ("@sp", "@spn", "@sil", "sp", "sil", "pau"))


def chunk_phone_ids(ids, accent_ids=None, max_phones: int = 120,
                    pause_ids: Optional[frozenset] = None):
    """Split a long phone sequence into synthesis chunks.

    Prefers splitting right AFTER a pause phone (natural silence, so the
    stitched audio has no mid-word seams); hard-splits at `max_phones` when
    no pause occurs. Concatenating the chunks reproduces the input exactly.
    Returns a list of (ids_chunk, accents_chunk-or-None).
    """
    ids = list(ids)
    acc = list(accent_ids) if accent_ids is not None else None
    if pause_ids is None:
        pause_ids = pause_phone_ids()
    chunks = []
    start = 0
    last_pause = -1
    for i, pid in enumerate(ids):
        if pid in pause_ids:
            last_pause = i
        if i - start + 1 >= max_phones:
            end = last_pause + 1 if last_pause >= start else i + 1
            chunks.append((ids[start:end], acc[start:end] if acc is not None else None))
            start = end
            last_pause = -1
    if start < len(ids):
        chunks.append((ids[start:], acc[start:] if acc is not None else None))
    return chunks


def synthesize_long(model: FastSpeech2, ids, accent_ids=None, speaker_id: int = 0,
                    speaker_meta: Optional[np.ndarray] = None,
                    speaker_emb: Optional[np.ndarray] = None,
                    p_control: float = 1.0, e_control: float = 1.0,
                    d_control: float = 1.0, max_phones: int = 120,
                    max_mel_len: int = 1000, vocoder: Optional[Vocoder] = None,
                    meta_dim: int = 4):
    """Unbounded-length synthesis: the text splits into chunks at pause
    phones (chunk_phone_ids), all chunks synthesize in one batched
    free-running forward, the per-chunk mels stitch back in order, and the
    vocoder runs once over the stitched mel.
    Returns {"mel", "mel_len", "n_chunks"[, "wav"]}.
    """
    chunks = chunk_phone_ids(ids, accent_ids, max_phones=max_phones)
    if not chunks:
        raise ValueError("empty phone sequence")
    n = len(chunks)
    width = max(len(c) for c, _ in chunks)
    texts = np.zeros((n, width), np.int32)
    acc = np.zeros((n, width), np.int32)
    src_lens = np.zeros(n, np.int32)
    for i, (c, a) in enumerate(chunks):
        texts[i, :len(c)] = c
        if a is not None:
            m = min(len(a), len(c))
            acc[i, :m] = a[:m]
            acc[i, m:len(c)] = NO_ACCENT_ID  # short accents -> no-accent
        else:
            acc[i, :len(c)] = NO_ACCENT_ID
        src_lens[i] = len(c)

    batch = {
        "texts": texts, "src_lens": src_lens, "accents": acc,
        "speakers": np.full(n, speaker_id, np.int32),
        "speaker_meta": (
            np.tile(np.asarray(speaker_meta, np.float32).reshape(1, -1), (n, 1))
            if speaker_meta is not None else np.zeros((n, meta_dim), np.float32)),
    }
    emb = (np.tile(np.asarray(speaker_emb, np.float32).reshape(1, -1), (n, 1))
           if speaker_emb is not None else None)
    out = synthesize_batch(model, batch, p_control, e_control, d_control,
                           max_mel_len=max_mel_len, speaker_emb=emb)
    mel_lens = out.mel_len.cpu().numpy()
    mels = out.postnet_mel.float().cpu().numpy()
    stitched = np.concatenate([mels[i, :int(mel_lens[i])] for i in range(n)], 0)

    result = {"mel": stitched, "mel_len": int(stitched.shape[0]), "n_chunks": n}
    if vocoder is not None and stitched.shape[0] > 0:
        wavs = vocoder_infer(torch.from_numpy(stitched[None]), vocoder,
                             lengths=[stitched.shape[0] * vocoder.hop_length])
        result["wav"] = wavs[0]
    return result


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def save_synth_results(cfg: ExperimentConfig, batch: Dict[str, np.ndarray],
                       output: FS2Output, vocoder: Optional[Vocoder], result_path: str,
                       write_figures: bool = True) -> List[str]:
    """Per-utterance png (when matplotlib is installed) + wav
    (reference synth_samples, utils/tools.py:228-274)."""
    from ..audio.wavio import write_wav

    os.makedirs(result_path, exist_ok=True)
    written = []
    mel_lens = output.mel_len.cpu().numpy()
    postnet_mel = output.postnet_mel.float()
    hop = cfg.preprocess.stft.hop_length
    sr = cfg.preprocess.audio.sampling_rate

    if write_figures and cfg.stats is not None and _have_matplotlib():
        from matplotlib import pyplot as plt

        from ..utils.logging import plot_mel

        stats = list(cfg.stats.pitch) + list(cfg.stats.energy[:2])
        durations = output.duration_rounded.cpu().to(torch.int32)
        pitches = output.pitch_prediction.float().cpu()
        energies = output.energy_prediction.float().cpu()
        mels_np = postnet_mel.cpu().numpy()
        t_max = mels_np.shape[1]
        for i, basename in enumerate(batch["ids"]):
            mel_len = int(mel_lens[i])
            src_len = int(batch["src_lens"][i])
            per_frame = []
            for values, level in ((pitches, cfg.preprocess.pitch.feature),
                                  (energies, cfg.preprocess.energy.feature)):
                if level == "phoneme_level":
                    v = expand_scalars(values[i:i + 1, :src_len],
                                       durations[i:i + 1, :src_len], t_max)[0]
                else:
                    v = values[i]
                per_frame.append(v[:mel_len].numpy())
            fig = plot_mel([(mels_np[i, :mel_len].T, *per_frame)], stats,
                           ["Synthetized Spectrogram"])
            fig.savefig(os.path.join(result_path, f"{basename}.png"))
            plt.close(fig)

    if vocoder is not None:
        wavs = vocoder_infer(postnet_mel, vocoder, mel_lens * hop)
        for wav, basename in zip(wavs, batch["ids"]):
            p = os.path.join(result_path, f"{basename}.wav")
            write_wav(p, wav, sr)
            written.append(p)
    return written
