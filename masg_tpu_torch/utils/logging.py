# Copied from masg_tpu/utils/logging.py (all but plot_alignment) so the port imports nothing of the JAX package.
"""Observability: TensorBoard + plain-text logging, mel/pitch/energy figures.

Reference: utils/tools.py:128-152 (log), :277-326 (plot_mel), train.py:104-105,
218-221 (SummaryWriter pair + log.txt mirror). TensorBoard comes via
torch.utils.tensorboard when present; scalars always go to a JSONL file too,
so headless training still has a record.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


class Logger:
    """SummaryWriter-compatible scalar/figure/audio logger with JSONL fallback."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, step: Optional[int] = None):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": step,
                                      "time": time.time()}) + "\n")
        self._jsonl.flush()

    def add_figure(self, tag: str, fig, step: Optional[int] = None):
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)

    def add_audio(self, tag: str, audio: np.ndarray, step: Optional[int] = None,
                  sample_rate: int = 22050):
        if self._tb is not None:
            import torch

            self._tb.add_audio(tag, torch.from_numpy(np.asarray(audio, np.float32))[None, :],
                               step, sample_rate=sample_rate)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


def log_losses(logger: Logger, step: int, losses, eloss=None, dloss=None,
               fig=None, audio=None, sampling_rate=22050, tag=""):
    """Reference utils/tools.py:128-152 semantics (6 scalar losses + optional
    speaker-enc/discriminator losses + figure/audio)."""
    if losses is not None:
        logger.add_scalar("Loss/total_loss", losses[0], step)
        logger.add_scalar("Loss/mel_loss", losses[1], step)
        logger.add_scalar("Loss/mel_postnet_loss", losses[2], step)
        logger.add_scalar("Loss/pitch_loss", losses[3], step)
        logger.add_scalar("Loss/energy_loss", losses[4], step)
        logger.add_scalar("Loss/duration_loss", losses[5], step)
    if eloss is not None:
        logger.add_scalar("Loss/speaker_enc_loss", eloss, step)
    if dloss is not None:
        logger.add_scalar("Loss/language_classification_loss", dloss, step)
    if fig is not None:
        logger.add_figure(tag, fig, step)
    if audio is not None:
        audio = np.asarray(audio, np.float32)
        logger.add_audio(tag, audio / max(1e-9, np.abs(audio).max()), step, sampling_rate)


def plot_mel(data, stats, titles):
    """Prediction-vs-GT mel figure with pitch/energy overlays
    (reference utils/tools.py:277-326)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, axes = plt.subplots(len(data), 1, squeeze=False)
    if titles is None:
        titles = [None] * len(data)
    pitch_min, pitch_max, pitch_mean, pitch_std, energy_min, energy_max = stats
    pitch_min = pitch_min * pitch_std + pitch_mean
    pitch_max = pitch_max * pitch_std + pitch_mean

    def add_axis(fig, old_ax):
        ax = fig.add_axes(old_ax.get_position(), anchor="W")
        ax.set_facecolor("None")
        return ax

    for i, (mel, pitch, energy) in enumerate(data):
        pitch = pitch * pitch_std + pitch_mean
        axes[i][0].imshow(mel, origin="lower")
        axes[i][0].set_aspect(2.5, adjustable="box")
        axes[i][0].set_ylim(0, mel.shape[0])
        axes[i][0].set_title(titles[i], fontsize="medium")
        axes[i][0].tick_params(labelsize="x-small", left=False, labelleft=False)
        axes[i][0].set_anchor("W")

        ax1 = add_axis(fig, axes[i][0])
        ax1.plot(pitch, color="tomato")
        ax1.set_xlim(0, mel.shape[1])
        ax1.set_ylim(0, pitch_max)
        ax1.set_ylabel("F0", color="tomato")
        ax1.tick_params(labelsize="x-small", colors="tomato", bottom=False, labelbottom=False)

        ax2 = add_axis(fig, axes[i][0])
        ax2.plot(energy, color="darkviolet")
        ax2.set_xlim(0, mel.shape[1])
        ax2.set_ylim(energy_min, energy_max)
        ax2.set_ylabel("Energy", color="darkviolet")
        ax2.yaxis.set_label_position("right")
        ax2.tick_params(
            labelsize="x-small", colors="darkviolet", bottom=False,
            labelbottom=False, left=False, labelleft=False, right=True, labelright=True,
        )
    return fig
