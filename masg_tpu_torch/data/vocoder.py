# Adapted from masg_tpu/data/vocoder.py (numpy only) so the port imports nothing of the JAX package:
# the same draws, plus the stream position a checkpoint saves and a check that a batch can be filled.
"""Audio segment sampling for vocoder (GAN) training.

Upstream jik876/hifi-gan's MelDataset loads a wav per item, random-crops
`segment_size` samples, and computes the mel on CPU workers. Here only the
raw audio segments leave the host — the jitted train step featurizes on
device (train/vocoder.py) — so the host side reduces to: cache wavs, crop,
stack. Small corpora are fully cached in RAM.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..audio.wavio import read_wav, resample_kaiser


class _ShuffledEpochs:
    """Shuffled epochs of whole batches over a dataset's items, and the
    stream's position (the RNG, this epoch's order, the next item), which a
    checkpoint saves (`stream_state`) so that a resume continues the stream
    where it stopped without drawing the batches before it."""

    _what = "items"

    def _init_stream(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)
        self._order: Optional[np.ndarray] = None
        self._pos = 0

    def _n_items(self) -> int:
        raise NotImplementedError

    def _check_batch(self, batch_size: int) -> None:
        # with fewer items than a batch no epoch yields one: the stream would spin
        if self._n_items() < batch_size:
            raise ValueError(f"{self._n_items()} {self._what} cannot fill a batch of "
                             f"{batch_size}: lower the batch size")

    def _index_batches(self, batch_size: int,
                       num_steps: Optional[int]) -> Iterator[np.ndarray]:
        step = 0
        while num_steps is None or step < num_steps:
            if self._order is None or self._pos + batch_size > len(self._order):
                self._order, self._pos = self._rng.permutation(self._n_items()), 0
            idx = self._order[self._pos:self._pos + batch_size]
            self._pos += batch_size
            yield idx
            step += 1

    def steps_per_epoch(self, batch_size: int) -> int:
        self._check_batch(batch_size)
        return self._n_items() // batch_size

    def stream_state(self) -> dict:
        """The stream's position after the last batch drawn (plain Python
        values, which `torch.load(weights_only=True)` reads back)."""
        return {"rng": self._rng.bit_generator.state,
                "order": None if self._order is None else self._order.tolist(),
                "pos": self._pos}

    def load_stream_state(self, state: dict) -> None:
        order = state["order"]
        if order is not None and len(order) != self._n_items():
            raise ValueError(f"the saved stream ran over {len(order)} {self._what}, "
                             f"this dataset has {self._n_items()}")
        self._rng.bit_generator.state = state["rng"]
        self._order = None if order is None else np.asarray(order, np.int64)
        self._pos = int(state["pos"])


def list_wavs(root: str) -> List[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.lower().endswith(".wav"):
                out.append(os.path.join(dirpath, n))
    return sorted(out)


class VocoderSegmentDataset(_ShuffledEpochs):
    """Random fixed-size segments from a set of wav files.

    Each epoch visits every file once in shuffled order with a fresh random
    crop (upstream MelDataset semantics: split=True random crop, shorter
    files zero-padded to segment_size).
    """

    _what = "training wavs"

    def __init__(self, wav_paths: Sequence[str], segment_size: int = 8192,
                 sample_rate: int = 22050, seed: int = 1234,
                 max_cache_bytes: int = 2 << 30, normalize: bool = True):
        if not wav_paths:
            raise ValueError("no wav files given")
        self.paths = list(wav_paths)
        self.segment_size = int(segment_size)
        self.sample_rate = int(sample_rate)
        # upstream jik876 meldataset semantics (from-scratch training):
        # per-FILE peak normalization to 0.95 (librosa.util.normalize * 0.95)
        # so the generator sees one consistent loudness target. Without it,
        # mixed-loudness corpora make the amplitude ambiguous given the mel
        # (measured: 3.5x RMS overshoot + 11% clipping at 4k steps raw vs
        # clean amplitude tracking normalized).
        self.normalize = normalize
        self._init_stream(seed)
        self._cache = {}
        self._cache_bytes = 0
        self._max_cache_bytes = max_cache_bytes

    def _load(self, path: str) -> np.ndarray:
        audio = self._cache.get(path)
        if audio is None:
            audio, sr = read_wav(path)
            if audio.ndim > 1:
                audio = audio.mean(axis=-1)
            if sr != self.sample_rate:
                audio = resample_kaiser(audio, sr, self.sample_rate)
            audio = np.asarray(audio, np.float32)
            if self.normalize:
                audio = audio * (0.95 / max(float(np.abs(audio).max()), 1e-9))
            if self._cache_bytes + audio.nbytes <= self._max_cache_bytes:
                self._cache[path] = audio
                self._cache_bytes += audio.nbytes
        return audio

    def _segment(self, audio: np.ndarray) -> np.ndarray:
        n = self.segment_size
        if audio.shape[0] >= n:
            start = int(self._rng.integers(0, audio.shape[0] - n + 1))
            return audio[start:start + n]
        return np.pad(audio, (0, n - audio.shape[0]))

    def _n_items(self) -> int:
        return len(self.paths)

    def batches(self, batch_size: int,
                num_steps: Optional[int] = None) -> Iterator[np.ndarray]:
        """Yield (batch_size, segment_size) float32 batches; files repeat
        across epochs forever (or for num_steps batches). Raises ValueError
        when there are fewer files than batch_size."""
        self._check_batch(batch_size)
        return (np.stack([self._segment(self._load(self.paths[j])) for j in idx])
                for idx in self._index_batches(batch_size, num_steps))


# log(1e-5): silence in the log-mel convention shared by the TTS features
# and mel_spectrogram_hifigan (both clamp at 1e-5 before the log). Upstream
# meldataset pads fine-tuning mels with literal zeros — an energy burst in
# log space; padding with silence is the evident intent.
_LOG_MEL_SILENCE = -11.512925


class VocoderFineTuneDataset(_ShuffledEpochs):
    """(mel, audio) pairs for vocoder fine-tuning (upstream hifi-gan's
    `--fine_tuning` mode: generator inputs come from .npy mel files — e.g.
    acoustic-model predictions dumped by cli/dump_mels — while the loss mel
    is still computed from the ground-truth audio).

    Mel files follow the preprocessed-corpus naming `{speaker}-mel-{base}.npy`
    (plain `{base}.npy` also accepted); wavs are found recursively under
    wav_dir by `{base}.wav`. Frame i is paired with samples
    [i*hop, (i+1)*hop) — the product alignment upstream uses.
    """

    _what = "(mel, wav) pairs"

    def __init__(self, mel_dir: str, wav_dir: str, segment_size: int = 8192,
                 hop_size: int = 256, sample_rate: int = 22050,
                 seed: int = 1234, max_cache_bytes: int = 2 << 30):
        self.frames = int(segment_size) // int(hop_size)
        self.hop = int(hop_size)
        self.segment_size = self.frames * self.hop
        self.sample_rate = int(sample_rate)
        self._init_stream(seed)
        self._cache = {}
        self._cache_bytes = 0
        self._max_cache_bytes = max_cache_bytes

        wav_by_stem = {}
        for p in list_wavs(wav_dir):
            wav_by_stem[os.path.splitext(os.path.basename(p))[0]] = p
        self.pairs = []
        for name in sorted(os.listdir(mel_dir)):
            if not name.endswith(".npy"):
                continue
            stem = name[: -len(".npy")]
            base = stem.split("-mel-", 1)[1] if "-mel-" in stem else stem
            wav = wav_by_stem.get(base) or wav_by_stem.get(stem)
            if wav is not None:
                self.pairs.append((os.path.join(mel_dir, name), wav))
        if not self.pairs:
            raise ValueError(
                f"no (mel, wav) pairs matched between {mel_dir} and {wav_dir}")

    def _load_wav(self, path: str) -> np.ndarray:
        audio = self._cache.get(path)
        if audio is None:
            audio, sr = read_wav(path)
            if audio.ndim > 1:
                audio = audio.mean(axis=-1)
            if sr != self.sample_rate:
                audio = resample_kaiser(audio, sr, self.sample_rate)
            audio = np.asarray(audio, np.float32)
            if self._cache_bytes + audio.nbytes <= self._max_cache_bytes:
                self._cache[path] = audio
                self._cache_bytes += audio.nbytes
        return audio

    def _segment(self, mel_path: str, wav_path: str):
        mel = np.load(mel_path)  # (T, n_mels)
        audio = self._load_wav(wav_path)
        f, hop = self.frames, self.hop
        n_frames = min(mel.shape[0], audio.shape[0] // hop)
        if n_frames >= f:
            start = int(self._rng.integers(0, n_frames - f + 1))
            return (mel[start:start + f].astype(np.float32),
                    audio[start * hop:(start + f) * hop])
        mel = np.pad(mel[:n_frames], ((0, f - n_frames), (0, 0)),
                     constant_values=_LOG_MEL_SILENCE)
        audio = np.pad(audio[:n_frames * hop], (0, (f - n_frames) * hop))
        return mel.astype(np.float32), audio

    def _n_items(self) -> int:
        return len(self.pairs)

    def batches(self, batch_size: int, num_steps: Optional[int] = None):
        """Yield (mels (B, F, n_mels), audio (B, F*hop)) float32 pairs;
        raises ValueError when there are fewer pairs than batch_size."""
        self._check_batch(batch_size)
        return (self._stack([self._segment(*self.pairs[j]) for j in idx])
                for idx in self._index_batches(batch_size, num_steps))

    @staticmethod
    def _stack(segs):
        return np.stack([m for m, _ in segs]), np.stack([a for _, a in segs])
