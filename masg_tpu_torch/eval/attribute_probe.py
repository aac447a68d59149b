"""Objective mid-attribute probe (port of masg_tpu/eval/attribute_probe.py):
does an interpolated/barycenter speaker actually SOUND between the attribute
corners?

This is the objective version of the reference paper's subjective evaluation
(arXiv:2210.09916 §4; the machinery under test is the reference's
model/distributions.py:12-192 + examples_gen_distri.py:128-231, whose
outputs were only ever listened to).

Protocol:
  1. synthesize audio for speakers sampled from each metadata-corner GMM
     (speaker_distribution at each one-hot corner),
  2. embed the synthesized AUDIO with a trained GE2E speaker encoder (the
     same featurization the encoder was trained on: raw-audio log-mels,
     preprocessor/ge2e_preprocess.ge2e_mel),
  3. fit attribute axes from the corner embeddings (gender axis = F centroid
     minus M centroid; language axis likewise),
  4. score interpolated (`interpolate_rate(t)` sweeps) and barycenter
     samples by scalar projection onto those axes: 0 = corner A, 1 = corner
     B. Mid-attribute claims become monotonicity (interpolation) and
     near-midpoint (barycenter) statements about these scores.

The embedder is the port's `SpeechEmbedder` (or any module returning
{"embeddings": ...}), run in eval mode on the device of its parameters.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _device_of(embedder) -> torch.device:
    p = next(iter(embedder.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


@torch.no_grad()
def ge2e_embed_mels(embedder, mels: np.ndarray) -> np.ndarray:
    """(B, 150, n_mels) chunks -> (B, D) L2-normalized float32 embeddings.
    The embedder runs in eval mode (dropout off) and goes back to its mode."""
    was_training = embedder.training
    embedder.eval()
    try:
        x = torch.as_tensor(np.asarray(mels, np.float32), device=_device_of(embedder))
        emb = embedder(x)["embeddings"].float().cpu().numpy()
    finally:
        embedder.train(was_training)
    return emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12)


def _wav_chunks(wav: np.ndarray, sr: int, tisv_frame: int, stride: int,
                hop: int) -> np.ndarray:
    """One wav -> (n_chunks, tisv_frame, n_mels) raw-audio log-mel chunks
    (the GE2E encoder's training featurization, ge2e_preprocess.ge2e_mel)."""
    from ..preprocessor.ge2e_preprocess import ge2e_mel

    mel = ge2e_mel(np.asarray(wav, np.float32), sr=sr, hop=hop).T  # (T, n_mels)
    t = mel.shape[0]
    if t < tisv_frame:
        mel = np.pad(mel, ((0, tisv_frame - t), (0, 0)))
        t = tisv_frame
    starts = list(range(0, t - tisv_frame + 1, stride)) or [0]
    return np.stack([mel[s:s + tisv_frame] for s in starts])


def embed_wavs(embedder, wavs: Sequence[np.ndarray],
               sr: int = 22050, tisv_frame: int = 150, stride: int = 75,
               hop: int = 256) -> np.ndarray:
    """Each wav -> one (D,) speaker embedding: mean over 150-frame chunk
    embeddings, L2-normalized (the GE2E d-vector convention)."""
    out = []
    for wav in wavs:
        chunks = _wav_chunks(np.asarray(wav, np.float32), sr, tisv_frame,
                             stride, hop)
        emb = ge2e_embed_mels(embedder, chunks).mean(axis=0)
        out.append(emb / (np.linalg.norm(emb) + 1e-12))
    return np.stack(out)


class AttributeAxes:
    """Attribute-scoring axes fit from corner-speaker embeddings.

    corner_embs keys: "{gender}_{language}" e.g. "M_ja"; each value is an
    (K, D) array of embeddings of synthesized speakers from that corner's
    GMM. Scores are scalar projections between the attribute centroids:
    gender_score 0 = M centroid, 1 = F centroid; language_score 0 = ja,
    1 = en.
    """

    def __init__(self, corner_embs: Dict[str, np.ndarray]):
        self.corner_embs = {k: np.asarray(v) for k, v in corner_embs.items()}

        def centroid(pred):
            rows = [v for k, v in self.corner_embs.items() if pred(k)]
            return np.concatenate(rows).mean(axis=0)

        self.c_m = centroid(lambda k: k.startswith("M_"))
        self.c_f = centroid(lambda k: k.startswith("F_"))
        self.c_ja = centroid(lambda k: k.endswith("_ja"))
        self.c_en = centroid(lambda k: k.endswith("_en"))

    @staticmethod
    def _project(emb: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        axis = b - a
        denom = float(axis @ axis) + 1e-12
        return (np.asarray(emb) - a) @ axis / denom

    def gender_score(self, emb: np.ndarray) -> np.ndarray:
        return self._project(emb, self.c_m, self.c_f)

    def language_score(self, emb: np.ndarray) -> np.ndarray:
        return self._project(emb, self.c_ja, self.c_en)

    def separation_of(self, corner_embs: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Probe validity on INDEPENDENT samples (pass embeddings that did
        NOT fit the axes — scoring the fitting set is circular: its margins
        are 1.0 by construction). margin = mean(1-side) - mean(0-side)."""
        def col(pred, score):
            return np.concatenate([score(v) for k, v in corner_embs.items()
                                   if pred(k)])

        g0 = col(lambda k: k.startswith("M_"), self.gender_score)
        g1 = col(lambda k: k.startswith("F_"), self.gender_score)
        l0 = col(lambda k: k.endswith("_ja"), self.language_score)
        l1 = col(lambda k: k.endswith("_en"), self.language_score)
        return {
            "gender_margin": float(g1.mean() - g0.mean()),
            "language_margin": float(l1.mean() - l0.mean()),
            "gender_std": float(np.concatenate([g0, g1]).std()),
            "language_std": float(np.concatenate([l0, l1]).std()),
        }

    def separation(self) -> Dict[str, float]:
        """In-sample spread diagnostic (the margins of the FITTING set are
        1.0 by construction — use separation_of for a non-circular check;
        the stds here still measure within-corner scatter)."""
        return self.separation_of(self.corner_embs)


def mean_voiced_f0(wav: np.ndarray, sr: int = 22050) -> float:
    """Mean F0 over voiced frames (DIO+StoneMask, audio/f0.py) — the direct
    acoustic gender cue, independent of any learned embedder."""
    from ..audio.f0 import extract_f0

    f0 = extract_f0(np.asarray(wav, np.float64), sr,
                    frame_period=256 / sr * 1000)
    voiced = f0[f0 > 0]
    return float(voiced.mean()) if voiced.size else 0.0
