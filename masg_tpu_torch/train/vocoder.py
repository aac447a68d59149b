"""HiFi-GAN vocoder training: the GAN step, its losses and parametrizations
(port of masg_tpu/train/vocoder.py).

Upstream jik876/hifi-gan's train.py:113-167 semantics, as masg_tpu has them:

- one generator forward per step, `y_hat = G(mel)`; the discriminators'
  AdamW update on `y_hat.detach()` first, then the generator's against the
  UPDATED discriminators, backpropagated through the same `y_hat`; the
  generator loss is LSGAN adversarial + feature matching + 45 x mel L1;
- the mels are computed from the audio segments on the device inside the
  step (`mel_spectrogram_hifigan`); with `from_mels` (fine-tuning) the
  generator takes the given mels and only the loss mel comes from the audio;
- weight norm on every conv (`torch.nn.utils.parametrizations.weight_norm`,
  torch's dim 0: the output channel of a conv, the INPUT channel of the
  generator's transposed convs `ups.i`), spectral norm on the MSD's
  full-rate scale (`SpectralNorm`, registered as a parametrization);
- AdamW (betas (0.8, 0.99), weight decay 0.01, eps 1e-8) under a per-epoch
  `lr_decay ** (step // steps_per_epoch)`, upstream's ExponentialLR.
"""

from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize
from torch.nn.utils.parametrizations import weight_norm

from ..audio.stft import hann_window, mel_filterbank
from ..infer.vocoder import build_generator
from ..models.hifigan import HiFiGANGenerator
from ..models.hifigan_disc import (SPECTRAL_NORM_SCALE, MultiPeriodDiscriminator,
                                   MultiScaleDiscriminator, build_discriminators,
                                   init_random_weights)

# ---------------------------------------------------------------------------
# the mel of GAN training: upstream meldataset.mel_spectrogram (a manual
# reflect pad of (n_fft - hop) / 2, center=False, |STFT| with +1e-9 under the
# sqrt, slaney mel, log(clamp 1e-5)); its edges differ from the TTS features'
# center=True STFT (audio/stft.py), so a vocoder trains on its own convention
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _mel_consts(n_fft: int, win_length: int, n_mels: int, sample_rate: int, f_min: float,
                f_max: float, dtype: torch.dtype, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window padded to n_fft, mel basis (n_fft // 2 + 1, n_mels)) on `device`."""
    window = torch.as_tensor(hann_window(win_length)).to(device, dtype)
    lpad = (n_fft - win_length) // 2
    window = F.pad(window, (lpad, n_fft - win_length - lpad))
    fb = torch.as_tensor(mel_filterbank(n_mels, n_fft, sample_rate, f_min, f_max))
    return window, fb.to(device, dtype)


def mel_spectrogram_hifigan(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                            win_length: int = 1024, n_mels: int = 80,
                            sample_rate: int = 22050, f_min: float = 0.0,
                            f_max: Optional[float] = 8000.0) -> torch.Tensor:
    """(B, T) audio -> (B, n_frames, n_mels) log-mel, channel-last.

    f_max None (the config's `fmax_for_loss: null`) takes the full band.
    n_frames = T // hop when hop divides T, so G(mel) has T samples again.
    """
    window, fb = _mel_consts(n_fft, win_length, n_mels, sample_rate, float(f_min),
                             float(f_max if f_max is not None else sample_rate / 2.0),
                             audio.dtype, audio.device)
    pad = (n_fft - hop_length) // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length) * window  # (B, n_frames, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


# ---------------------------------------------------------------------------
# weight norm and spectral norm
# ---------------------------------------------------------------------------


class SpectralNorm(nn.Module):
    """weight / sigma, sigma = u . (W v) with W the weight as (out, fan_in)
    (fan_in in torch's (in, k...) order), as a parametrization of a conv's
    `weight` whose state is the buffers `_u` and `_v`.

    In train mode every access of the weight first runs one power iteration
    in upstream's order, v = N(W^T u) then u = N(W v) (the order of
    `torch.nn.utils.spectral_norm`, which jik876/hifi-gan uses, and of
    masg_tpu). `torch.nn.utils.parametrizations.spectral_norm` updates u
    before v, which gives another sigma every step, so it is not used here.
    N divides by max(norm, 1e-12) where masg_tpu divides by norm + 1e-12: a
    difference of ~1e-12 relative.
    """

    def __init__(self, u: torch.Tensor, v: torch.Tensor, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.register_buffer("_u", u)
        self.register_buffer("_v", v)

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        mat = weight.flatten(1)
        if self.training:
            with torch.no_grad():
                self._v.copy_(F.normalize(torch.mv(mat.t(), self._u), dim=0, eps=self.eps))
                self._u.copy_(F.normalize(torch.mv(mat, self._v), dim=0, eps=self.eps))
        # clones: a second forward must not change what the first one's
        # backward reads
        sigma = torch.dot(self._u.clone(), torch.mv(mat, self._v.clone()))
        return weight / sigma


def sn_init_vectors(weight: torch.Tensor, key: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """masg_tpu's deterministic (u, v) for the spectral-norm kernel at masg_tpu
    path `key` (e.g. "disc_0/convs_0_kernel"): u normal from numpy's
    default_rng(crc32(key)), normalised; v = N(W^T u)."""
    mat = weight.detach().flatten(1).cpu().numpy().astype(np.float32)
    rng = np.random.default_rng(zlib.crc32(key.encode()) & 0x7FFFFFFF)
    u = rng.normal(size=mat.shape[0]).astype(np.float32)
    u /= np.linalg.norm(u) + 1e-12
    v = mat.T @ u
    v /= np.linalg.norm(v) + 1e-12
    return (torch.from_numpy(u).to(weight.dtype), torch.from_numpy(v).to(weight.dtype))


def _convs(module: nn.Module) -> List[Tuple[str, nn.Module]]:
    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d))]


def add_weight_norm(module: nn.Module) -> nn.Module:
    """Weight norm (dim 0) on every conv of `module`: v = w and g = ||w|| per
    channel, so the weight is unchanged."""
    for _, m in _convs(module):
        weight_norm(m, dim=0)
    return module


def add_spectral_norm(scale: nn.Module, scope: str = f"disc_{SPECTRAL_NORM_SCALE}") -> nn.Module:
    """`SpectralNorm` on every conv of one scale discriminator, (u, v) from
    `sn_init_vectors` under masg_tpu's path names (`{scope}/convs_{j}_kernel`,
    `{scope}/conv_post_kernel`)."""
    for name, m in _convs(scale):
        key = f"{scope}/{name.replace('.', '_')}_kernel"
        u, v = sn_init_vectors(m.weight, key)
        # unsafe: the safe path evaluates the parametrization once, which in
        # train mode would take a power iteration
        parametrize.register_parametrization(m, "weight", SpectralNorm(u, v), unsafe=True)
    return scale


def parametrize_vocoder(generator: HiFiGANGenerator, mpd: MultiPeriodDiscriminator,
                        msd: MultiScaleDiscriminator) -> None:
    """Upstream's parametrizations: weight norm everywhere, spectral norm on
    the MSD's full-rate scale."""
    add_weight_norm(generator)
    add_weight_norm(mpd)
    for i, d in enumerate(msd.discriminators):
        if i == SPECTRAL_NORM_SCALE:
            add_spectral_norm(d)
        else:
            add_weight_norm(d)


# ---------------------------------------------------------------------------
# GAN losses (upstream train.py)
# ---------------------------------------------------------------------------


def discriminator_loss(real_logits: Sequence[torch.Tensor],
                       fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN: the sum over discriminators of mean((1 - dr)^2) + mean(dg^2)."""
    return sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
               for dr, dg in zip(real_logits, fake_logits))


def generator_adv_loss(fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - dg) ** 2) for dg in fake_logits)


def feature_loss(real_fmaps, fake_fmaps) -> torch.Tensor:
    """2 x the sum of L1 means over every feature map of every discriminator."""
    return 2.0 * sum(torch.mean(torch.abs(rl - gl))
                     for dr, dg in zip(real_fmaps, fake_fmaps) for rl, gl in zip(dr, dg))


# ---------------------------------------------------------------------------
# train state and step
# ---------------------------------------------------------------------------


class VocoderMetrics(NamedTuple):
    disc_loss: torch.Tensor
    gen_loss: torch.Tensor  # adversarial + feature matching + 45 x mel L1
    gen_adv: torch.Tensor
    fm: torch.Tensor
    mel_l1: torch.Tensor  # unscaled L1 (upstream logs loss_mel / 45)


def make_lr_schedule(learning_rate: float, lr_decay: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Upstream ExponentialLR(gamma=lr_decay), stepped once per epoch: the
    learning rate of update `count` (0-based)."""
    return lambda count: learning_rate * lr_decay ** (count // max(1, steps_per_epoch))


def make_optimizers(cfg: Dict, gen_params, disc_params
                    ) -> Tuple[torch.optim.AdamW, torch.optim.AdamW]:
    """The AdamW pair of the reference config.json (betas (0.8, 0.99), torch
    AdamW's weight decay 0.01 and eps 1e-8); the step sets their rates."""
    betas = (cfg.get("adam_b1", 0.8), cfg.get("adam_b2", 0.99))
    lr = cfg.get("learning_rate", 2e-4)
    return (torch.optim.AdamW(gen_params, lr, betas=betas, weight_decay=0.01, eps=1e-8),
            torch.optim.AdamW(disc_params, lr, betas=betas, weight_decay=0.01, eps=1e-8))


@dataclass
class VocoderTrainState:
    generator: HiFiGANGenerator  # weight-normed, fused_mrf off
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator  # spectral norm on scale 0
    gen_opt: torch.optim.AdamW
    disc_opt: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0  # updates taken

    def disc_params(self) -> List[nn.Parameter]:
        return list(self.mpd.parameters()) + list(self.msd.parameters())

    def state_dict(self) -> dict:
        """The whole GAN state (a `vocoder_{step}.pth.tar`)."""
        return {"generator": self.generator.state_dict(), "mpd": self.mpd.state_dict(),
                "msd": self.msd.state_dict(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "step": self.step}

    def load_state_dict(self, payload: dict) -> None:
        for name in ("generator", "mpd", "msd"):
            getattr(self, name).load_state_dict(payload[name], strict=True)
        self.gen_opt.load_state_dict(payload["gen_opt"])
        self.disc_opt.load_state_dict(payload["disc_opt"])
        self.step = int(payload["step"])


def init_generator_weights(gen: HiFiGANGenerator, generator: torch.Generator) -> None:
    """Upstream's (and masg_tpu's) generator init from a seeded generator:
    conv weights normal(0, 0.01), biases 0."""
    with torch.no_grad():
        for _, m in _convs(gen):
            m.weight.copy_(0.01 * torch.randn(m.weight.shape, generator=generator,
                                              dtype=torch.float64))
            m.bias.zero_()


def init_vocoder_train_state(cfg: Dict, steps_per_epoch: int, seed: int = 1234,
                             gen_state_dict: Optional[dict] = None,
                             device: Union[str, torch.device] = "cpu",
                             dtype: torch.dtype = torch.float32) -> VocoderTrainState:
    """Seeded random weights (or the generator warm-started from a plain
    `gen_state_dict`), parametrized, with fresh optimizers. The generator
    runs the plain MRF (`fused_mrf=False`): kernel K4 has no backward."""
    gen = build_generator(cfg, fused_mrf=False)
    mpd, msd = build_discriminators(cfg)
    rng = torch.Generator().manual_seed(seed)
    if gen_state_dict is None:
        init_generator_weights(gen, rng)
    else:
        gen.load_state_dict(gen_state_dict, strict=True)
    init_random_weights(mpd, rng)
    init_random_weights(msd, rng)
    for m in (gen, mpd, msd):
        m.to(dtype)
    parametrize_vocoder(gen, mpd, msd)
    for m in (gen, mpd, msd):
        m.to(device, dtype).train()
    gen_opt, disc_opt = make_optimizers(cfg, list(gen.parameters()),
                                        list(mpd.parameters()) + list(msd.parameters()))
    schedule = make_lr_schedule(cfg.get("learning_rate", 2e-4), cfg.get("lr_decay", 0.999),
                                steps_per_epoch)
    return VocoderTrainState(gen, mpd, msd, gen_opt, disc_opt, schedule)


def mel_kwargs(cfg: Dict) -> dict:
    return dict(n_fft=int(cfg.get("n_fft", 1024)), hop_length=int(cfg.get("hop_size", 256)),
                win_length=int(cfg.get("win_size", 1024)), n_mels=int(cfg.get("num_mels", 80)),
                sample_rate=int(cfg.get("sampling_rate", 22050)),
                f_min=float(cfg.get("fmin", 0) or 0.0))


def make_vocoder_train_step(cfg: Dict, from_mels: bool = False, mesh=None
                            ) -> Callable[[VocoderTrainState, object],
                                          Tuple[VocoderTrainState, VocoderMetrics]]:
    """The GAN step: (state, batch) -> (state, metrics), updating the state in
    place. The batch is (B, segment) audio, or with `from_mels` a (mels
    (B, F, n_mels), audio (B, F * hop)) pair, as tensors on the state's device.

    The discriminators run in train mode, so the MSD's spectral-norm scale
    power-iterates once on y and once on y_hat in each of the two losses:
    four iterations a step, upstream's and masg_tpu's cadence.

    `mesh` (`parallel.mesh.DataMesh`): the batch is this rank's equal share
    of the global one. Every loss is a mean over equal shards, so the mean
    of the ranks' gradients is the one-device gradient: each backward is
    followed by an averaging all-reduce, and the metrics are the ranks'
    means. The spectral norm's power iteration reads only the weight, which
    the ranks share, so (u, v) stay equal too.
    """
    kw = mel_kwargs(cfg)
    f_max_in = cfg.get("fmax", 8000)
    f_max_loss = cfg.get("fmax_for_loss", None)

    def discriminate(state: VocoderTrainState, y, y_hat):
        r_p, g_p, fr_p, fg_p = state.mpd(y, y_hat)
        r_s, g_s, fr_s, fg_s = state.msd(y, y_hat)
        return r_p + r_s, g_p + g_s, fr_p + fr_s, fg_p + fg_s

    def train_step(state: VocoderTrainState, batch):
        for m in (state.generator, state.mpd, state.msd):
            m.train()
        if from_mels:
            mel_in, y = batch
        else:
            y = batch
            mel_in = mel_spectrogram_hifigan(y, f_max=f_max_in, **kw)
        y_mel = mel_spectrogram_hifigan(y, f_max=f_max_loss, **kw)
        lr = state.schedule(state.step)
        for opt in (state.gen_opt, state.disc_opt):
            for group in opt.param_groups:
                group["lr"] = lr

        y_hat = state.generator(mel_in)

        # the discriminators' update, on the generator output detached
        state.disc_opt.zero_grad(set_to_none=True)
        r, g, _, _ = discriminate(state, y, y_hat.detach())
        d_loss = discriminator_loss(r, g)
        d_loss.backward()
        if mesh is not None:
            mesh.reduce_grads(state.disc_params(), average=True)
        state.disc_opt.step()

        # the generator's, against the UPDATED discriminators; its loss
        # reaches the generator's parameters only (`inputs`), so no gradient
        # of it is left on the discriminators for their next update
        state.gen_opt.zero_grad(set_to_none=True)
        r, g, fr, fg = discriminate(state, y, y_hat)
        adv = generator_adv_loss(g)
        fm = feature_loss(fr, fg)
        mel_l1 = torch.mean(torch.abs(y_mel - mel_spectrogram_hifigan(y_hat, f_max=f_max_loss,
                                                                       **kw)))
        g_loss = adv + fm + 45.0 * mel_l1
        torch.autograd.backward(g_loss, inputs=list(state.generator.parameters()))
        if mesh is not None:
            mesh.reduce_grads(state.generator.parameters(), average=True)
        state.gen_opt.step()
        state.step += 1
        metrics = torch.stack([x.detach() for x in (d_loss, g_loss, adv, fm, mel_l1)])
        if mesh is not None and mesh.parts > 1:
            metrics = mesh.sum(metrics) / mesh.parts
        return state, VocoderMetrics(*metrics.unbind())

    return train_step


@torch.no_grad()
def export_generator_state_dict(generator: HiFiGANGenerator) -> Dict[str, torch.Tensor]:
    """The generator's weights with weight norm folded, under upstream names
    (`conv_pre.weight`, `ups.i.weight`, ...), f32 on the CPU: what the port's
    `HiFiGANGenerator` strict-loads and `{"generator": ...}` files hold."""
    out = {}
    for name, m in _convs(generator):
        out[f"{name}.weight"] = m.weight.detach().to("cpu", torch.float32).clone()
        out[f"{name}.bias"] = m.bias.detach().to("cpu", torch.float32).clone()
    return out


def load_upstream_discriminators(state: VocoderTrainState, mpd_sd: dict, msd_sd: dict) -> None:
    """Upstream `do_*` discriminator state dicts (`weight_g`/`weight_v`; on the
    MSD's scale 0 `weight_orig`/`weight_u`/`weight_v`) into the state's
    parametrized discriminators."""
    def renamed(sd: dict, sn_prefix: Optional[str]) -> dict:
        out = {}
        for k, v in sd.items():
            mod, _, leaf = k.rpartition(".")
            pw = f"{mod}.parametrizations.weight"
            if sn_prefix is not None and k.startswith(sn_prefix):
                leaf_map = {"weight_orig": f"{pw}.original", "weight_u": f"{pw}.0._u",
                            "weight_v": f"{pw}.0._v"}
            else:
                leaf_map = {"weight_g": f"{pw}.original0", "weight_v": f"{pw}.original1"}
            out[leaf_map.get(leaf, k)] = v
        return out

    state.mpd.load_state_dict(renamed(mpd_sd, None), strict=True)
    state.msd.load_state_dict(renamed(msd_sd, f"discriminators.{SPECTRAL_NORM_SCALE}."),
                              strict=True)
