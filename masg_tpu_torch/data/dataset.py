# Copied from masg_tpu/data/dataset.py so the port imports nothing of the JAX package.
"""Host-side dataset: preprocessed .npy features -> padded numpy batches.

Reproduces the reference's Dataset / ConcatDataset / TextDataset semantics
(dataset.py:13-275) without torch:

- metadata lines `basename|speaker|{phones}|raw_text`;
- phone strings -> ids via the shared symbol table; accent files -> ids with
  constant 4 when accents are unused;
- sort-by-text-length mega-batches of batch_size*group_size split into
  group_size real batches (collate_fn/reprocess, :175-194);
- ConcatDataset re-normalizes pitch/energy with the GLOBAL stats.json and
  remaps speakers through the global speakers.json (:197-211).

TPU addition: `pad_to_buckets` rounds padded lengths up to bucket boundaries
so jitted step functions compile once per bucket instead of once per batch
shape.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..text import NO_ACCENT_ID, accents_to_ids, phone_string_to_sequence


def pad_1d(inputs: Sequence[np.ndarray], pad_to: Optional[int] = None, value=0) -> np.ndarray:
    max_len = max(len(x) for x in inputs)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    return np.stack([
        np.pad(x, (0, max_len - len(x)), constant_values=value) for x in inputs
    ])


def pad_2d(inputs: Sequence[np.ndarray], pad_to: Optional[int] = None) -> np.ndarray:
    max_len = max(x.shape[0] for x in inputs)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    return np.stack([
        np.pad(x, ((0, max_len - x.shape[0]), (0, 0))) for x in inputs
    ])


def round_up_bucket(n: int, bucket: int) -> int:
    return ((n + bucket - 1) // bucket) * bucket


class Dataset:
    """One corpus worth of preprocessed features."""

    def __init__(
        self,
        filename: str,
        preprocess_config: dict,
        batch_size: int = 16,
        sort: bool = False,
        drop_last: bool = False,
        text_bucket: Optional[int] = None,
        mel_bucket: Optional[int] = None,
    ):
        self.dataset_name = preprocess_config.get("dataset", "")
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.batch_size = batch_size
        self.use_accent = bool(
            preprocess_config.get("accent", {}).get("use_accent", False)
        )
        self.speaker_meta_schema: Dict[str, Dict[str, int]] = preprocess_config[
            "preprocessing"
        ]["speaker_generation"]["metadata"]
        pp = preprocess_config["preprocessing"]
        self.pitch_feature_level = pp.get("pitch", {}).get("feature", "phoneme_level")
        self.energy_feature_level = pp.get("energy", {}).get("feature", "phoneme_level")
        self.sort = sort
        self.drop_last = drop_last
        self.text_bucket = text_bucket
        self.mel_bucket = mel_bucket

        self.basename, self.speaker, self.text, self.raw_text = self._process_meta(
            os.path.join(self.preprocessed_path, filename)
        )
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, idx: int) -> dict:
        basename = self.basename[idx]
        speaker = self.speaker[idx]
        entry = self.speaker_map[speaker]
        speaker_id = entry[0]
        speaker_meta = {
            meta: entry[i + 1] for i, meta in enumerate(self.speaker_meta_schema)
        }
        phone = np.array(phone_string_to_sequence(self.text[idx]))
        if self.use_accent:
            with open(
                os.path.join(self.preprocessed_path, "accent", basename + ".accent")
            ) as f:
                accent = np.array(accents_to_ids(f.read().strip(), len(phone)))
            if len(accent) < len(phone):
                accent = np.pad(accent, (0, len(phone) - len(accent)))
        else:
            accent = np.full(len(phone), NO_ACCENT_ID)

        def load(kind):
            return np.load(
                os.path.join(
                    self.preprocessed_path, kind, f"{speaker}-{kind}-{basename}.npy"
                )
            )

        return {
            "id": basename,
            "speaker": speaker_id,
            "speaker_name": speaker,
            "speaker_meta": speaker_meta,
            "text": phone,
            "raw_text": self.raw_text[idx],
            "mel": load("mel"),
            "pitch": load("pitch"),
            "energy": load("energy"),
            "duration": load("duration"),
            "accent": accent,
        }

    @staticmethod
    def _process_meta(path: str):
        name, speaker, text, raw = [], [], [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                n, s, t, r = line.strip("\n").split("|")
                name.append(n)
                speaker.append(s)
                text.append(t)
                raw.append(r)
        return name, speaker, text, raw

    def _one_hot_meta(self, meta: Dict[str, str]) -> np.ndarray:
        # np.eye concat layout (reference dataset.py:123-126)
        parts = []
        for name, mapping in self.speaker_meta_schema.items():
            parts.append(np.eye(len(mapping))[mapping[meta[name]]])
        return np.concatenate(parts)

    def reprocess(self, data: List[dict], idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        texts = [data[i]["text"] for i in idxs]
        mels = [data[i]["mel"] for i in idxs]
        text_lens = np.array([t.shape[0] for t in texts])
        mel_lens = np.array([m.shape[0] for m in mels])

        text_pad = None
        mel_pad = None
        if self.text_bucket:
            text_pad = round_up_bucket(int(text_lens.max()), self.text_bucket)
        if self.mel_bucket:
            mel_pad = round_up_bucket(int(mel_lens.max()), self.mel_bucket)

        # frame_level pitch/energy targets are per-FRAME arrays and must pad
        # with the mels, not the texts (the frame-level VarianceAdaptor branch
        # adds their embeddings to the expanded sequence)
        mels_padded = pad_2d(mels, mel_pad).astype(np.float32)
        frame_pad = mels_padded.shape[1]
        pitch_pad = text_pad if self.pitch_feature_level == "phoneme_level" else frame_pad
        energy_pad = text_pad if self.energy_feature_level == "phoneme_level" else frame_pad

        batch = {
            "ids": [data[i]["id"] for i in idxs],
            "raw_texts": [data[i]["raw_text"] for i in idxs],
            "speakers": np.array([data[i]["speaker"] for i in idxs], dtype=np.int32),
            "texts": pad_1d(texts, text_pad).astype(np.int32),
            "src_lens": text_lens.astype(np.int32),
            "mels": mels_padded,
            "mel_lens": mel_lens.astype(np.int32),
            "pitches": pad_1d([data[i]["pitch"] for i in idxs], pitch_pad).astype(np.float32),
            "energies": pad_1d([data[i]["energy"] for i in idxs], energy_pad).astype(np.float32),
            "durations": pad_1d([data[i]["duration"] for i in idxs], text_pad).astype(np.int32),
            "speaker_meta": np.stack(
                [self._one_hot_meta(data[i]["speaker_meta"]) for i in idxs]
            ).astype(np.float32),
            "accents": pad_1d([data[i]["accent"] for i in idxs], text_pad).astype(np.int32),
        }
        return batch

    def collate(self, data: List[dict]) -> List[Dict[str, np.ndarray]]:
        """Mega-batch -> group_size real batches (reference collate_fn)."""
        n = len(data)
        if self.sort:
            idx_arr = np.argsort(-np.array([d["text"].shape[0] for d in data]))
        else:
            idx_arr = np.arange(n)
        tail = idx_arr[n - (n % self.batch_size):]
        idx_arr = idx_arr[: n - (n % self.batch_size)]
        groups = idx_arr.reshape(-1, self.batch_size).tolist()
        if not self.drop_last and len(tail) > 0:
            groups.append(tail.tolist())
        return [self.reprocess(data, g) for g in groups]

    def to_reference_tuple(self, batch: Dict[str, np.ndarray]):
        """Emit the reference's positional 14-tuple wire format
        (dataset.py:139-156) at CLI/compat boundaries."""
        return (
            batch["ids"], batch["raw_texts"], batch["speakers"], batch["texts"],
            batch["src_lens"], int(batch["src_lens"].max()), batch["mels"],
            batch["mel_lens"], int(batch["mel_lens"].max()), batch["pitches"],
            batch["energies"], batch["durations"], batch["speaker_meta"],
            batch["accents"],
        )


class ConcatDataset:
    """Multi-corpus concat with GLOBAL stats re-normalization + speaker remap
    (reference dataset.py:197-211; pairs with gather.py + preprocess.py:15-16
    which disable per-corpus normalization)."""

    def __init__(self, config_dir: str, datasets: List[Dataset]):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])
        with open(os.path.join(config_dir, "stats.json")) as f:
            self.stats = json.load(f)
        with open(os.path.join(config_dir, "speakers.json")) as f:
            self.speaker_map = json.load(f)
        # collate via the first dataset's settings (reference :200)
        self._proto = datasets[0]

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx: int) -> dict:
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        sample = self.datasets[d][idx - int(self.offsets[d])]
        sample = dict(sample)
        sample["pitch"] = (sample["pitch"] - self.stats["pitch"][2]) / self.stats["pitch"][3]
        sample["energy"] = (sample["energy"] - self.stats["energy"][2]) / self.stats["energy"][3]
        sample["speaker"] = self.speaker_map[sample["speaker_name"]][0]
        return sample

    def collate(self, data: List[dict]):
        return self._proto.collate(data)


class TextDataset:
    """Inference-time dataset for batch synthesis from a metadata file
    (reference dataset.py:214-275)."""

    def __init__(self, filepath: str, preprocess_config: dict):
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.use_accent = bool(
            preprocess_config.get("accent", {}).get("use_accent", False)
        )
        self.basename, self.speaker, self.text, self.raw_text = Dataset._process_meta(
            filepath
        )
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, idx: int):
        basename = self.basename[idx]
        speaker = self.speaker[idx]
        entry = self.speaker_map[speaker]
        speaker_id = entry[0] if isinstance(entry, list) else entry
        phone = np.array(phone_string_to_sequence(self.text[idx]))
        if self.use_accent:
            with open(
                os.path.join(self.preprocessed_path, "accent", basename + ".accent")
            ) as f:
                accent = np.array(accents_to_ids(f.read().strip(), len(phone)))
        else:
            accent = np.full(len(phone), NO_ACCENT_ID)
        return basename, speaker_id, phone, self.raw_text[idx], accent

    def collate(self, data) -> Dict[str, np.ndarray]:
        texts = [d[2] for d in data]
        text_lens = np.array([t.shape[0] for t in texts], dtype=np.int32)
        return {
            "ids": [d[0] for d in data],
            "raw_texts": [d[3] for d in data],
            "speakers": np.array([d[1] for d in data], dtype=np.int32),
            "texts": pad_1d(texts).astype(np.int32),
            "src_lens": text_lens,
            "accents": pad_1d([d[4] for d in data]).astype(np.int32),
        }
