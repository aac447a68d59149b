"""FastSpeech2 with the TacoSpawn speaker prior, in plain PyTorch.

Written from the published description (FastSpeech2, arXiv:2006.04558; the
mid-attribute speaker generation recipe of sarulab-speech/Mid-Attribute-
Speaker-Generation, whose `model/` and `transformer/` modules name the
parameters used here) as functions over a dict of tensors. It imports nothing
of the program under test: the benchmark makes the weights, hands the same
dict to both sides, and this module works out everything else again.

The order of the dropout calls and the memory layout of the tensors they draw
on follow the published torch modules, so that a step seeded alike draws the
same masks as any implementation that keeps that order.

Inference follows the discrete choices of the run being judged (durations,
pitch and energy bins) when they are handed in: `follow` takes them, and the
caller judges each choice by its margin against the continuous values this
module returns (`infer`), as a served token is judged against a reference's
logits.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

P = Dict[str, torch.Tensor]
N_ACCENT = 5  # accent ids: 0 (pad) to 3, and 4 for none


def dims(model: dict) -> dict:
    """The sizes this module needs, from a configuration's `model` group."""
    t = model["transformer"]
    return dict(hidden=t["encoder_hidden"], enc_layers=t["encoder_layer"],
                dec_layers=t["decoder_layer"], heads=t["encoder_head"],
                d_inner=t["conv_filter_size"], kernels=tuple(t["conv_kernel_size"]),
                enc_dropout=t["encoder_dropout"], dec_dropout=t["decoder_dropout"],
                vp_filter=model["variance_predictor"]["filter_size"],
                vp_kernel=model["variance_predictor"]["kernel_size"],
                vp_dropout=model["variance_predictor"]["dropout"],
                n_bins=model["variance_embedding"]["n_bins"],
                max_seq_len=model["max_seq_len"],
                mixtures=model["speaker_generation"]["GMM_mixtures"])


def spec(model: dict, n_symbols: int, n_speakers: int, n_mels: int = 80, meta_dim: int = 4
         ) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model's state dict, under
    the recipe's torch names. `kind` says how the benchmark fills it."""
    d = dims(model)
    h, f, k0, k1 = d["hidden"], d["d_inner"], d["kernels"][0], d["kernels"][1]
    out = []

    def lin(name, i, o):
        out.extend([(f"{name}.weight", (o, i), "linear"), (f"{name}.bias", (o,), "bias")])

    def conv(name, i, o, k):
        out.extend([(f"{name}.weight", (o, i, k), "conv"), (f"{name}.bias", (o,), "bias")])

    def ln(name, n):
        out.extend([(f"{name}.weight", (n,), "ones"), (f"{name}.bias", (n,), "bias")])

    def fft(prefix):
        a = f"{prefix}.slf_attn"
        for w in ("w_qs", "w_ks", "w_vs", "fc"):
            lin(f"{a}.{w}", h, h)
        ln(f"{a}.layer_norm", h)
        conv(f"{prefix}.pos_ffn.w_1", h, f, k0)
        conv(f"{prefix}.pos_ffn.w_2", f, h, k1)
        ln(f"{prefix}.pos_ffn.layer_norm", h)

    out.append(("encoder.position_enc", (1, d["max_seq_len"] + 1, h), "sinusoid"))
    out.append(("encoder.src_word_emb.weight", (n_symbols, h), "embedding"))
    out.append(("encoder.src_accent_emb.weight", (N_ACCENT, h), "embedding_small"))
    for i in range(d["enc_layers"]):
        fft(f"encoder.layer_stack.{i}")
    va = "variance_adaptor"
    out.append((f"{va}.pitch_bins", (d["n_bins"] - 1,), "pitch_bins"))
    out.append((f"{va}.energy_bins", (d["n_bins"] - 1,), "energy_bins"))
    for p in ("duration", "pitch", "energy"):
        name = f"{va}.{p}_predictor"
        conv(f"{name}.conv_layer.conv1d_1.conv", h, d["vp_filter"], d["vp_kernel"])
        ln(f"{name}.conv_layer.layer_norm_1", d["vp_filter"])
        conv(f"{name}.conv_layer.conv1d_2.conv", d["vp_filter"], d["vp_filter"], d["vp_kernel"])
        ln(f"{name}.conv_layer.layer_norm_2", d["vp_filter"])
        out.append((f"{name}.linear_layer.weight", (1, d["vp_filter"]),
                    "duration_out" if p == "duration" else "linear"))
        out.append((f"{name}.linear_layer.bias", (1,),
                    "duration_bias" if p == "duration" else "bias"))
    out.append((f"{va}.pitch_embedding.weight", (d["n_bins"], h), "embedding_small"))
    out.append((f"{va}.energy_embedding.weight", (d["n_bins"], h), "embedding_small"))
    out.append(("decoder.position_enc", (1, d["max_seq_len"] + 1, h), "sinusoid"))
    for i in range(d["dec_layers"]):
        fft(f"decoder.layer_stack.{i}")
    lin("mel_linear", h, n_mels)
    chans = [n_mels, 512, 512, 512, 512, n_mels]
    for i in range(5):
        c = f"postnet.convolutions.{i}"
        conv(f"{c}.0.conv", chans[i], chans[i + 1], 5)
        out.extend([(f"{c}.1.weight", (chans[i + 1],), "ones"),
                    (f"{c}.1.bias", (chans[i + 1],), "bias"),
                    (f"{c}.1.running_mean", (chans[i + 1],), "bias"),
                    (f"{c}.1.running_var", (chans[i + 1],), "ones"),
                    (f"{c}.1.num_batches_tracked", (), "count")])
    out.append(("speaker_emb.weight", (n_speakers, h), "embedding_small"))
    lin("speaker_enc.pi_linear.0", meta_dim, d["mixtures"])
    lin("speaker_enc.sigma_linear.0", meta_dim, d["mixtures"] * h)
    lin("speaker_enc.mu_linear", meta_dim, d["mixtures"] * h)
    return out


def sinusoid(n: int, d: int) -> np.ndarray:
    """(n, d) table: pos / 10000^(2 (i // 2) / d), sin at even i, cos at odd."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (i // 2) / d)
    return np.where(np.arange(d) % 2 == 0, np.sin(angle), np.cos(angle)).astype(np.float32)


def bins(lo: float, hi: float, n_bins: int) -> np.ndarray:
    """The n_bins - 1 linear bucket edges between lo and hi."""
    return np.linspace(lo, hi, n_bins - 1).astype(np.float32)


# --- layers -----------------------------------------------------------------


def _pad_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] >= lengths[:, None]


def _embed(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, w).masked_fill((ids <= 0)[..., None], 0.0)


def _attention(p: P, pre: str, x, pad_mask, heads: int, drop: float, train: bool):
    b, t, h = x.shape
    dh = h // heads

    def split(y):
        return y.view(b, t, heads, dh).transpose(1, 2).contiguous()

    q = split(F.linear(x, p[f"{pre}.w_qs.weight"], p[f"{pre}.w_qs.bias"]))
    k = split(F.linear(x, p[f"{pre}.w_ks.weight"], p[f"{pre}.w_ks.bias"]))
    v = split(F.linear(x, p[f"{pre}.w_vs.weight"], p[f"{pre}.w_vs.bias"]))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    s = s.masked_fill(pad_mask[:, None, None, :], torch.finfo(s.dtype).min)
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(1, 2).reshape(b, t, h)
    o = F.linear(o, p[f"{pre}.fc.weight"], p[f"{pre}.fc.bias"])
    return F.layer_norm(F.dropout(o, drop, train) + x, (h,), p[f"{pre}.layer_norm.weight"],
                        p[f"{pre}.layer_norm.bias"], 1e-5)


def _ffn(p: P, pre: str, x, kernels, drop: float, train: bool):
    w1, w2 = p[f"{pre}.w_1.weight"], p[f"{pre}.w_2.weight"]
    y = F.conv1d(x.transpose(1, 2), w1, p[f"{pre}.w_1.bias"], padding=(kernels[0] - 1) // 2)
    y = F.conv1d(F.relu(y), w2, p[f"{pre}.w_2.bias"], padding=(kernels[1] - 1) // 2)
    y = y.transpose(1, 2)
    h = x.shape[-1]
    return F.layer_norm(F.dropout(y, drop, train) + x, (h,), p[f"{pre}.layer_norm.weight"],
                        p[f"{pre}.layer_norm.bias"], 1e-5)


def _stack(p: P, pre: str, n: int, x, pad_mask, d: dict, drop: float, train: bool):
    x = x + torch.from_numpy(sinusoid(x.shape[1], x.shape[2])).to(x)[None]
    for i in range(n):
        layer = f"{pre}.layer_stack.{i}"
        x = _attention(p, f"{layer}.slf_attn", x, pad_mask, d["heads"], drop, train)
        x = x.masked_fill(pad_mask[..., None], 0.0)
        x = _ffn(p, f"{layer}.pos_ffn", x, d["kernels"], drop, train)
        x = x.masked_fill(pad_mask[..., None], 0.0)
    return x


def _predictor(p: P, pre: str, x, pad_mask, d: dict, train: bool):
    k = d["vp_kernel"]
    c = f"{pre}.conv_layer"
    n = d["vp_filter"]
    y = F.relu(F.conv1d(x.transpose(1, 2), p[f"{c}.conv1d_1.conv.weight"],
                        p[f"{c}.conv1d_1.conv.bias"], padding=(k - 1) // 2)).transpose(1, 2)
    y = F.dropout(F.layer_norm(y, (n,), p[f"{c}.layer_norm_1.weight"],
                               p[f"{c}.layer_norm_1.bias"], 1e-5), d["vp_dropout"], train)
    y = F.relu(F.conv1d(y.transpose(1, 2), p[f"{c}.conv1d_2.conv.weight"],
                        p[f"{c}.conv1d_2.conv.bias"], padding=(k - 1) // 2)).transpose(1, 2)
    y = F.dropout(F.layer_norm(y, (n,), p[f"{c}.layer_norm_2.weight"],
                               p[f"{c}.layer_norm_2.bias"], 1e-5), d["vp_dropout"], train)
    out = F.linear(y, p[f"{pre}.linear_layer.weight"], p[f"{pre}.linear_layer.bias"])[..., 0]
    return out.masked_fill(pad_mask, 0.0)


def regulate(x: torch.Tensor, durations: torch.Tensor, t: int):
    """(B, L, H) phone features repeated by integer durations into (B, t, H)
    frames, zero past each row's total; (frames, min(total, t))."""
    b, _, h = x.shape
    out = x.new_zeros(b, t, h)
    total = durations.long().sum(1)
    for i in range(b):
        rows = torch.repeat_interleave(x[i], durations[i].long(), dim=0)[:t]
        out[i, :rows.shape[0]] = rows
    return out, total.clamp(max=t)


def _postnet(p: P, x, train: bool):
    """5 convs of kernel 5 with BatchNorm (batch statistics over every frame
    in training, the running ones in eval), tanh but after the last, dropout
    0.5 after each. x: (B, T, n_mels)."""
    for i in range(5):
        c = f"postnet.convolutions.{i}"
        y = F.conv1d(x.transpose(1, 2), p[f"{c}.0.conv.weight"], p[f"{c}.0.conv.bias"],
                     padding=2).transpose(1, 2)
        if train:
            mean = y.mean(dim=(0, 1))
            var = (y - mean).square().mean(dim=(0, 1))
        else:
            mean, var = p[f"{c}.1.running_mean"], p[f"{c}.1.running_var"]
        y = (y - mean) / torch.sqrt(var + 1e-5) * p[f"{c}.1.weight"] + p[f"{c}.1.bias"]
        if i != 4:
            y = torch.tanh(y)
        x = F.dropout(y, 0.5, train)
    return x


def gmm(p: P, meta: torch.Tensor, mixtures: int):
    """The prior over speaker embeddings for metadata `meta` (B, meta_dim):
    (pi (B, K), mu (B, K, H), sigma (B, K, H))."""
    hidden = p["speaker_emb.weight"].shape[1]
    shape = meta.shape[:-1] + (mixtures, hidden)
    pi = torch.softmax(F.linear(meta, p["speaker_enc.pi_linear.0.weight"],
                                p["speaker_enc.pi_linear.0.bias"]), dim=-1)
    sigma = F.softplus(F.linear(meta, p["speaker_enc.sigma_linear.0.weight"],
                                p["speaker_enc.sigma_linear.0.bias"])).reshape(shape)
    mu = F.linear(meta, p["speaker_enc.mu_linear.weight"],
                  p["speaker_enc.mu_linear.bias"]).reshape(shape)
    return pi, mu, sigma


def gmm_log_prob(pi, mu, sigma, x):
    z = (x[..., None, :] - mu) / sigma
    comp = torch.sum(-0.5 * (z * z + math.log(2 * math.pi)) - torch.log(sigma), dim=-1)
    return torch.logsumexp(torch.log(pi.clamp(min=1e-37)) + comp, dim=-1)


def sample_prior(p: P, metas: np.ndarray, mixtures: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """One embedding drawn from the prior for each row of `metas`: a
    component by pi, then mu + sigma * N(0, 1); in float64 on the host."""
    pd = {k: v.detach().double().cpu() for k, v in p.items() if k.startswith("speaker_")}
    pi, mu, sigma = (t.numpy() for t in gmm(pd, torch.from_numpy(metas).double(), mixtures))
    out = np.empty(mu.shape[::2], np.float64)
    for i in range(len(metas)):
        c = rng.choice(pi.shape[1], p=pi[i] / pi[i].sum())
        out[i] = mu[i, c] + sigma[i, c] * rng.standard_normal(mu.shape[2])
    return out.astype(np.float32)


# --- the model --------------------------------------------------------------


class Inference(NamedTuple):
    log_duration: torch.Tensor  # (B, L)
    duration_real: torch.Tensor  # (B, L) exp(log d) - 1, before rounding, >= 0
    pitch: torch.Tensor  # (B, L) the predictions the bins are chosen from
    energy: torch.Tensor
    duration: torch.Tensor  # (B, L) the durations followed
    mel_len: torch.Tensor
    postnet_mel: torch.Tensor  # (B, T, n_mels)


def _bin_of(edges: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bucketize(v, edges, right=False)


def encode(p: P, model: dict, texts, src_lens, accents, speaker_vec):
    """The encoder with the speaker vector added, in eval mode: (phone
    features (B, L, H), pad mask, predicted log(1 + duration))."""
    d = dims(model)
    pad = _pad_mask(src_lens, texts.shape[1])
    x = _embed(p["encoder.src_word_emb.weight"], texts)
    x = x + _embed(p["encoder.src_accent_emb.weight"], accents)
    x = _stack(p, "encoder", d["enc_layers"], x, pad, d, 0.0, False)
    x = x + speaker_vec[:, None, :]
    return x, pad, _predictor(p, "variance_adaptor.duration_predictor", x, pad, d, False)


def infer(p: P, model: dict, texts, src_lens, accents, speaker_vec, max_mel_len: int,
          follow: Optional[dict] = None) -> Inference:
    """Free-running synthesis (eval mode). `speaker_vec` (B, H) is a table
    row or a sampled embedding. With `follow` ({"duration", "pitch_bin",
    "energy_bin"}: (B, L) integer tensors) the model continues along those
    choices; without it, along its own (rounded durations, bucketized
    predictions)."""
    d = dims(model)
    x, pad, log_d = encode(p, model, texts, src_lens, accents, speaker_vec)
    va = "variance_adaptor"
    pitch = _predictor(p, f"{va}.pitch_predictor", x, pad, d, False)
    pb = follow["pitch_bin"] if follow else _bin_of(p[f"{va}.pitch_bins"], pitch)
    x = x + F.embedding(pb, p[f"{va}.pitch_embedding.weight"])
    energy = _predictor(p, f"{va}.energy_predictor", x, pad, d, False)
    eb = follow["energy_bin"] if follow else _bin_of(p[f"{va}.energy_bins"], energy)
    x = x + F.embedding(eb, p[f"{va}.energy_embedding.weight"])
    real = torch.clamp(torch.exp(log_d) - 1.0, min=0.0)
    dur = follow["duration"] if follow else torch.clamp(torch.round(torch.exp(log_d) - 1.0),
                                                         min=0)
    frames, mel_len = regulate(x, dur, max_mel_len)
    mel_pad = _pad_mask(mel_len, max_mel_len)
    y = _stack(p, "decoder", d["dec_layers"], frames, mel_pad, d, 0.0, False)
    mel = F.linear(y, p["mel_linear.weight"], p["mel_linear.bias"])
    return Inference(log_d, real, pitch, energy, dur, mel_len, _postnet(p, mel, False) + mel)


class Losses(NamedTuple):
    total: torch.Tensor  # what the step minimises
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor
    prior: torch.Tensor  # mean log-likelihood of the table rows under the prior


def _masked_mean(err, valid):
    per = err[0, 0].numel() if err.dim() > 2 else 1
    v = valid.to(err.dtype).reshape(valid.shape + (1,) * (err.dim() - valid.dim()))
    return (err * v).sum() / torch.clamp(valid.to(err.dtype).sum() * per, min=1.0)


def train_losses(p: P, model: dict, batch: Dict[str, torch.Tensor]) -> Losses:
    """The teacher-forced training forward (dropout on, BatchNorm on batch
    statistics) and its losses: masked L1 on the mel before and after the
    PostNet, masked MSE on pitch, energy and log(1 + duration), minus the
    prior's mean log-likelihood of the (detached) table rows."""
    d = dims(model)
    texts, src_lens = batch["texts"], batch["src_lens"]
    t_pad = batch["mels"].shape[1]
    pad = _pad_mask(src_lens, texts.shape[1])
    x = _embed(p["encoder.src_word_emb.weight"], texts)
    x = x + _embed(p["encoder.src_accent_emb.weight"], batch["accents"])
    x = _stack(p, "encoder", d["enc_layers"], x, pad, d, d["enc_dropout"], True)
    spk = F.embedding(batch["speakers"], p["speaker_emb.weight"])
    pi, mu, sigma = gmm(p, batch["speaker_meta"], d["mixtures"])
    x = x + spk[:, None, :]
    va = "variance_adaptor"
    log_d = _predictor(p, f"{va}.duration_predictor", x, pad, d, True)
    pitch = _predictor(p, f"{va}.pitch_predictor", x, pad, d, True)
    x = x + F.embedding(_bin_of(p[f"{va}.pitch_bins"], batch["pitches"]),
                        p[f"{va}.pitch_embedding.weight"])
    energy = _predictor(p, f"{va}.energy_predictor", x, pad, d, True)
    x = x + F.embedding(_bin_of(p[f"{va}.energy_bins"], batch["energies"]),
                        p[f"{va}.energy_embedding.weight"])
    frames, _ = regulate(x, batch["durations"], t_pad)
    mel_pad = _pad_mask(batch["mel_lens"], t_pad)
    t = min(t_pad, d["max_seq_len"])  # the decoder keeps at most max_seq_len frames
    frames, mel_pad = frames[:, :t], mel_pad[:, :t]
    y = _stack(p, "decoder", d["dec_layers"], frames, mel_pad, d, d["dec_dropout"], True)
    mel = F.linear(y, p["mel_linear.weight"], p["mel_linear.bias"])
    post = _postnet(p, mel, True) + mel
    target = batch["mels"][:, :t]
    src_valid, mel_valid = ~pad, ~mel_pad
    log_d_target = torch.log(batch["durations"].double() + 1.0).float()
    losses = dict(
        mel=_masked_mean((mel - target).abs(), mel_valid),
        postnet_mel=_masked_mean((post - target).abs(), mel_valid),
        pitch=_masked_mean((pitch - batch["pitches"]) ** 2, src_valid),
        energy=_masked_mean((energy - batch["energies"]) ** 2, src_valid),
        duration=_masked_mean((log_d - log_d_target) ** 2, src_valid))
    prior = gmm_log_prob(pi, mu, sigma, spk.detach()).mean()
    total = (losses["mel"] + losses["postnet_mel"] + losses["duration"] + losses["pitch"]
             + losses["energy"]) - prior
    return Losses(total=total, prior=prior, **losses)
