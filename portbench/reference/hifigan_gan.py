"""HiFi-GAN's adversarial training step in plain PyTorch, written from
jik876/hifi-gan: `models.py` (Generator, DiscriminatorP,
MultiPeriodDiscriminator, DiscriminatorS, MultiScaleDiscriminator and the
losses), `meldataset.py` (`mel_spectrogram`) and `train.py:113-167` (the
step). It imports nothing of the program under test, and runs float32 with
TF32 off unless told otherwise.

One step from audio y (B, T):
- the generator's input mel from y (fmax 8000) and its loss mel (fmax
  `fmax_for_loss`, the full band when null); y_hat = G(mel);
- the discriminators (5 period discriminators, 3 scale discriminators with
  AvgPool1d(4, 2, 2) between scales) on y and y_hat.detach(); LSGAN loss;
  backward; AdamW on the discriminators;
- the UPDATED discriminators on y and y_hat; the generator's LSGAN loss +
  2 x feature matching (L1 over every feature map) + 45 x mel L1; backward
  into the generator; AdamW on the generator.

Every conv is weight-normed (w = g v / ||v||, the norm over every dim but
0: a conv's output channel, a transposed conv's INPUT channel, as torch's
`weight_norm` on upstream's ConvTranspose1d), except the full-rate scale
discriminator's, which are spectral-normed with one power iteration at
every forward (v = N(W^T u), u = N(W v), sigma = u . W v, u and v held
constant in the backward): two forwards in each loss, four a step.

Departures from upstream:
- the state (weights, AdamW moments and step counts, the power
  iteration's u) is handed in, captured from a run; nothing is initialised;
- the mels are computed from the batch's audio at each step (upstream's
  data loader computes the same two from the same crop on the host);
- the rate is upstream's ExponentialLR stepped once per epoch, written as
  lr x lr_decay ** (updates // steps_per_epoch);
- AdamW is written out (torch's, which upstream uses: decoupled decay
  p x (1 - lr wd), bias-corrected moments, eps added to sqrt(v_hat));
- TF32 is off: upstream's PyTorch would run cuDNN's convolutions in TF32 on
  an Ampere or later card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import hifigan as ref_hifigan

P = Dict[str, torch.Tensor]
SLOPE = 0.1


# --- the mel of GAN training (meldataset.mel_spectrogram) -------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale: linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    step = 200.0 / 3
    mel = f / step
    log_from = 1000.0 / step
    above = f >= 1000.0
    mel[above] = log_from + np.log(f[above] / 1000.0) / (np.log(6.4) / 27.0)
    return mel


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    step = 200.0 / 3
    f = m * step
    log_from = 1000.0 / step
    above = m >= log_from
    f[above] = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m[above] - log_from))
    return f


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]
              ) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with its defaults
    (slaney scale and area norm): (n_mels, n_fft // 2 + 1) float32."""
    fmax = sr / 2.0 if fmax is None else float(fmax)
    fft_f = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(np.array([float(fmin)]))[0],
                                   _hz_to_mel(np.array([fmax]))[0], n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def mel_spectrogram(y: torch.Tensor, h: dict, fmax: Optional[float]) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames) log-mel: a reflect pad of (n_fft - hop) / 2
    each side, torch.stft with center=False and a periodic Hann window,
    sqrt(re^2 + im^2 + 1e-9), the mel basis, log(clamp(x, 1e-5))."""
    n_fft, hop, win = h["n_fft"], h["hop_size"], h["win_size"]
    basis = torch.from_numpy(mel_basis(h["sampling_rate"], n_fft, h["num_mels"], h["fmin"],
                                       fmax)).to(y.device, y.dtype)
    pad = (n_fft - hop) // 2
    x = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=win,
                      window=torch.hann_window(win, device=y.device, dtype=y.dtype),
                      center=False, normalized=False, onesided=True, return_complex=True)
    spec = torch.sqrt(torch.view_as_real(spec).pow(2).sum(-1) + 1e-9)
    return torch.log(torch.clamp(basis @ spec, min=1e-5))


# --- weight norm, spectral norm ----------------------------------------------------


def weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g v / ||v||, the norm over every dim but 0."""
    norm = torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True)
    return v * (g / norm)


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def spectral_norm(w: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma, the new u) after one power iteration from u (in place of
    torch.nn.utils.spectral_norm's buffers, which upstream uses)."""
    mat = w.flatten(1)
    with torch.no_grad():
        v = _normalize(torch.mv(mat.t(), u))
        u = _normalize(torch.mv(mat, v))
    return w / torch.dot(u, torch.mv(mat, v)), u


class Weights:
    """The weights of one forward: each conv's weight made from its
    parameters when it is read (weight norm, or spectral norm, which then
    power-iterates and keeps the new u in `sn_u`)."""

    def __init__(self, params: P, sn_u: P):
        self.p, self.sn_u = params, sn_u

    def __call__(self, conv: str) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.p
        if f"{conv}.weight_orig" in p:
            w, u = spectral_norm(p[f"{conv}.weight_orig"], self.sn_u[f"{conv}.weight_u"])
            self.sn_u[f"{conv}.weight_u"] = u
            return w, p[f"{conv}.bias"]
        return weight_norm(p[f"{conv}.weight_g"], p[f"{conv}.weight_v"]), p[f"{conv}.bias"]


# --- the generator -----------------------------------------------------------------


def generator(weights: Weights, h: dict, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, frames) -> (B, frames x prod(upsample_rates)), through the
    generator equations of `reference/hifigan.py` with this step's weights."""
    folded = {}
    for name in {k.rsplit(".", 1)[0] for k in weights.p if k.startswith("generator.")}:
        w, b = weights(name)
        folded[f"{name[len('generator.'):]}.weight"] = w
        folded[f"{name[len('generator.'):]}.bias"] = b
    return ref_hifigan.generate(folded, h, mel.transpose(1, 2))


# --- the discriminators ----------------------------------------------------------


def period_discriminator(weights: Weights, pre: str, x: torch.Tensor, period: int, d: dict
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """DiscriminatorP: a reflect pad to a multiple of the period, the audio
    as (B, 1, T / p, p), (k, 1) convs of stride (s, 1) but the last (stride
    1, padding 2), leaky ReLU 0.1, conv_post (3, 1)."""
    b, t = x.shape
    if t % period:
        x = F.pad(x[:, None], (0, period - t % period), mode="reflect")[:, 0]
        t = x.shape[1]
    x = x.view(b, 1, t // period, period)
    k, s, n = d["period_kernel_size"], d["period_stride"], len(d["period_channels"])
    fmap = []
    for j in range(n + 1):
        w, bias = weights(f"{pre}.convs.{j}")
        x = F.leaky_relu(F.conv2d(x, w, bias, (s if j < n else 1, 1),
                                  ((k - 1) // 2 if j < n else 2, 0)), SLOPE)
        fmap.append(x)
    w, bias = weights(f"{pre}.conv_post")
    x = F.conv2d(x, w, bias, 1, (1, 0))
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


def scale_discriminator(weights: Weights, pre: str, x: torch.Tensor, d: dict
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """DiscriminatorS: grouped 1D convs (out, k, stride, groups), padding
    (k - 1) / 2, leaky ReLU 0.1, conv_post (k 3)."""
    x = x[:, None]
    fmap = []
    for j, (_, k, s, groups) in enumerate(d["scale_layers"]):
        w, bias = weights(f"{pre}.convs.{j}")
        x = F.leaky_relu(F.conv1d(x, w, bias, s, (k - 1) // 2, groups=groups), SLOPE)
        fmap.append(x)
    w, bias = weights(f"{pre}.conv_post")
    x = F.conv1d(x, w, bias, 1, 1)
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


def discriminators(weights: Weights, d: dict, y: torch.Tensor, y_hat: torch.Tensor):
    """(real logits, generated logits, real maps, generated maps) of the MPD
    then the MSD; each discriminator sees y, then y_hat."""
    out = ([], [], [], [])

    def keep(real, fake):
        for acc, x in zip(out, (real[0], fake[0], real[1], fake[1])):
            acc.append(x)

    for i, p in enumerate(d["periods"]):
        pre = f"mpd.discriminators.{i}"
        keep(period_discriminator(weights, pre, y, p, d),
             period_discriminator(weights, pre, y_hat, p, d))
    k, s, pad = d["scale_pool"]
    for i in range(d["scales"]):
        if i:
            y = F.avg_pool1d(y[:, None], k, s, pad)[:, 0]
            y_hat = F.avg_pool1d(y_hat[:, None], k, s, pad)[:, 0]
        pre = f"msd.discriminators.{i}"
        keep(scale_discriminator(weights, pre, y, d), scale_discriminator(weights, pre, y_hat, d))
    return out


# --- the losses (models.py) ----------------------------------------------------------


def discriminator_loss(real: Sequence[torch.Tensor], fake: Sequence[torch.Tensor]):
    return sum(torch.mean((1 - dr) ** 2) + torch.mean(dg ** 2) for dr, dg in zip(real, fake))


def generator_loss(fake: Sequence[torch.Tensor]):
    return sum(torch.mean((1 - dg) ** 2) for dg in fake)


def feature_loss(real_maps, fake_maps):
    """The sum of L1 means over every feature map (upstream doubles it)."""
    return sum(torch.mean(torch.abs(rl - gl))
               for dr, dg in zip(real_maps, fake_maps) for rl, gl in zip(dr, dg))


# --- the step --------------------------------------------------------------------------


class Trajectory:
    """Follows a run's steps from a captured state. `params`: every parameter
    under upstream's names, prefixed `generator.`, `mpd.` or `msd.`
    (`<conv>.weight_g`, `.weight_v`, `.bias`; spectral-normed convs
    `.weight_orig`); `sn_u`: `msd.<conv>.weight_u` of each spectral-normed
    conv; `moments`: AdamW's (exp_avg, exp_avg_sq, updates taken) of each
    parameter; `count`: the updates the run has taken (the rate's epoch
    count). `step(y)` returns (d_loss, g_loss); `grads[i]` holds step i's
    gradients by name, `params` and `sn_u` the state now."""

    def __init__(self, params: P, sn_u: P,
                 moments: Dict[str, Tuple[torch.Tensor, torch.Tensor, int]], count: int,
                 config: dict, steps_per_epoch: int, allow_tf32: bool = False):
        self.h, self.d = config["hifigan"], config["discriminators"]
        self.loss = config["train_step"]
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.sn_u = {k: v.detach().clone() for k, v in sn_u.items()}
        self.m = {k: moments[k][0].detach().clone() for k in params}
        self.v = {k: moments[k][1].detach().clone() for k in params}
        self.t = {k: int(moments[k][2]) for k in params}
        self.count, self.steps_per_epoch, self.allow_tf32 = count, steps_per_epoch, allow_tf32
        self.grads: List[P] = []

    def _adamw(self, names: List[str], grads: Sequence[torch.Tensor], lr: float) -> None:
        h = self.h
        b1, b2 = h["adam_b1"], h["adam_b2"]
        wd, eps = self.loss["adamw_weight_decay"], self.loss["adamw_eps"]
        with torch.no_grad():
            for k, g in zip(names, grads):
                self.t[k] += 1
                t = self.t[k]
                p = self.params[k]
                p.mul_(1 - lr * wd)
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** t))

    def step(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.allow_tf32
        try:
            return self._step(y)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def _step(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, d = self.h, self.d
        lr = h["learning_rate"] * h["lr_decay"] ** (self.count // self.steps_per_epoch)
        mel_in = mel_spectrogram(y, h, h["fmax"])
        y_mel = mel_spectrogram(y, h, h["fmax_for_loss"])
        y_hat = generator(Weights(self.params, self.sn_u), h, mel_in)

        gen = [k for k in self.params if k.startswith("generator.")]
        disc = [k for k in self.params if not k.startswith("generator.")]
        r, g, _, _ = discriminators(Weights(self.params, self.sn_u), d, y, y_hat.detach())
        d_loss = discriminator_loss(r, g)
        d_grads = torch.autograd.grad(d_loss, [self.params[k] for k in disc])
        self._adamw(disc, d_grads, lr)

        r, g, fr, fg = discriminators(Weights(self.params, self.sn_u), d, y, y_hat)
        mel_l1 = F.l1_loss(y_mel, mel_spectrogram(y_hat, h, h["fmax_for_loss"]))
        g_loss = (generator_loss(g) + self.loss["lambda_fm"] * feature_loss(fr, fg)
                  + self.loss["lambda_mel"] * mel_l1)
        g_grads = torch.autograd.grad(g_loss, [self.params[k] for k in gen])
        self._adamw(gen, g_grads, lr)
        self.count += 1
        self.grads.append({**dict(zip(disc, d_grads)), **dict(zip(gen, g_grads))})
        return d_loss.detach(), g_loss.detach()
