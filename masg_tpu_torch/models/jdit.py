"""JDIT: the joint-duration Tacotron2 attention teacher (port of
masg_tpu/models/jdit.py).

Reference: model/jdit.py (Decoder :238-490 with location-sensitive attention
:61-118, Prenet :121-132; JDIT :493-520). A teacher-forced autoregressive
decoder reads the FastSpeech2 encoder outputs and the ground-truth mels and
gives a parallel mel plus soft alignments; `attention_to_duration` turns the
alignments' argmax into per-phoneme durations.

Parameter names are the reference's torch names (`jdit.decoder.prenet.
layers.{0,1}.linear_layer`, `attention_layer.{query,memory}_layer`, `v`,
`location_layer.location_{conv.conv,dense}`, `attention_rnn`, `decoder_rnn`
as `nn.LSTMCell`s with torch's two biases, `linear_projection`,
`gate_layer`), the names masg_tpu's `export_torch_fastspeech2` writes.

masg_tpu scans the frames with `nn.scan`; here a Python loop runs them.
The prenet runs batched over all frames first, as in the reference, and
`memory_layer` once. masg_tpu's two corrections of the reference are kept:
pads (not valid frames) are masked, to float32's lowest value rather than
-inf, so a fully padded row gives uniform weights instead of NaN; and
`attention_to_duration` counts argmax frames per phoneme.

Dropout: the prenet's 0.5 is on even in eval (the reference calls
`F.dropout(training=True)`); the 0.1 after each LSTM cell only in train mode.
Every mask comes from the `torch.Generator` the caller passes, never from
torch's global generator, so an eval forward repeats. Each rate is a module
attribute (`Prenet.p`, `JDITDecoder.p_attention_dropout`,
`p_decoder_dropout`) that parity checks set to 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class _LinearNorm(nn.Module):
    """The reference's Linear wrapper: its weights sit under `.linear_layer`."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class _ConvNorm(nn.Module):
    """The reference's SAME-padded, bias-free Conv1d under `.conv`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, padding=(kernel_size - 1) // 2,
                              bias=False)


def _keep_scaled(shape, p: float, generator: torch.Generator, like: torch.Tensor
                 ) -> Optional[torch.Tensor]:
    """A dropout mask keep / (1 - p) drawn from `generator`, or None at p = 0."""
    if p <= 0.0:
        return None
    keep = torch.rand(shape, generator=generator, device=like.device) >= p
    return keep.to(like.dtype) / (1.0 - p)


class Prenet(nn.Module):
    """Two bias-free Linear + ReLU layers, each followed by dropout `p` that
    stays on in eval (reference jdit.py:121-132)."""

    def __init__(self, in_dim: int, sizes: Tuple[int, int] = (256, 256), p: float = 0.5):
        super().__init__()
        dims = (in_dim,) + tuple(sizes)
        self.layers = nn.ModuleList(_LinearNorm(a, b, bias=False)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        for layer in self.layers:
            x = F.relu(layer(x))
            mask = _keep_scaled(x.shape, self.p, generator, x)
            if mask is not None:
                x = x * mask
        return x


class _LocationLayer(nn.Module):
    def __init__(self, filters: int, kernel: int, attention_dim: int):
        super().__init__()
        self.location_conv = _ConvNorm(2, filters, kernel)
        self.location_dense = _LinearNorm(filters, attention_dim, bias=False)

    def forward(self, att_w_cat: torch.Tensor) -> torch.Tensor:
        """(B, 2, L) [att_w; att_w_cum] -> (B, L, attention_dim)."""
        return self.location_dense(self.location_conv.conv(att_w_cat).transpose(1, 2))


class _Attention(nn.Module):
    """Location-sensitive attention's weights (reference jdit.py:61-118)."""

    def __init__(self, rnn_dim: int, encoder_dim: int, attention_dim: int, filters: int,
                 kernel: int):
        super().__init__()
        self.query_layer = _LinearNorm(rnn_dim, attention_dim, bias=False)
        self.memory_layer = _LinearNorm(encoder_dim, attention_dim, bias=False)
        self.v = _LinearNorm(attention_dim, 1, bias=False)
        self.location_layer = _LocationLayer(filters, kernel, attention_dim)


class JDITDecoder(nn.Module):
    """The teacher-forced location-sensitive-attention decoder (reference
    jdit.py:238-490, masg_tpu's `JDITDecoder` and `_DecoderStep`)."""

    def __init__(self, n_mels: int = 80, encoder_dim: int = 256,
                 attention_rnn_dim: int = 1024, decoder_rnn_dim: int = 1024,
                 prenet_dim: int = 256, attention_dim: int = 128,
                 location_filters: int = 32, location_kernel: int = 31):
        super().__init__()
        self.n_mels = n_mels
        self.encoder_dim = encoder_dim
        self.prenet = Prenet(n_mels, (prenet_dim, prenet_dim))
        self.attention_rnn = nn.LSTMCell(prenet_dim + encoder_dim, attention_rnn_dim)
        self.attention_layer = _Attention(attention_rnn_dim, encoder_dim, attention_dim,
                                          location_filters, location_kernel)
        self.decoder_rnn = nn.LSTMCell(attention_rnn_dim + encoder_dim, decoder_rnn_dim)
        self.linear_projection = _LinearNorm(decoder_rnn_dim + encoder_dim, n_mels)
        self.gate_layer = _LinearNorm(decoder_rnn_dim + encoder_dim, 1)
        self.p_attention_dropout = 0.1
        self.p_decoder_dropout = 0.1

    def forward(self, memory: torch.Tensor, mels: torch.Tensor, memory_pad_mask: torch.Tensor,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """memory (B, L, encoder_dim), teacher mels (B, T, n_mels), pad mask
        (B, L) True at pads -> (mel (B, T, n_mels), gate (B, T), alignments
        (B, T, L))."""
        b, l, _ = memory.shape
        t = mels.shape[1]
        att = self.attention_layer
        mels = mels.to(memory.dtype)
        # the prenet over [go frame; teacher frames[:-1]] (jdit.py:433-436)
        dec_in = torch.cat([mels.new_zeros(b, 1, self.n_mels), mels[:, :-1]], dim=1)
        dec_in = self.prenet(dec_in, generator)
        processed_memory = att.memory_layer(memory)
        neg = torch.finfo(torch.float32).min

        ah = memory.new_zeros(b, self.attention_rnn.hidden_size)
        ac = torch.zeros_like(ah)
        dh = memory.new_zeros(b, self.decoder_rnn.hidden_size)
        dc = torch.zeros_like(dh)
        att_w = memory.new_zeros(b, l)
        att_w_cum = torch.zeros_like(att_w)
        att_ctx = memory.new_zeros(b, self.encoder_dim)
        # the 0.1 dropouts of every frame at once (train mode only)
        a_mask = d_mask = None
        if self.training:
            a_mask = _keep_scaled((t, b, ah.shape[1]), self.p_attention_dropout, generator, ah)
            d_mask = _keep_scaled((t, b, dh.shape[1]), self.p_decoder_dropout, generator, dh)

        mel_out, gate_out, align = [], [], []
        for i in range(t):
            # flax's carry is (c, h), torch's LSTMCell takes and returns (h, c)
            ah, ac = self.attention_rnn(torch.cat([dec_in[:, i], att_ctx], dim=-1), (ah, ac))
            if a_mask is not None:
                ah = ah * a_mask[i]
            loc = att.location_layer(torch.stack([att_w, att_w_cum], dim=1))
            q = att.query_layer(ah)[:, None, :]
            energies = att.v(torch.tanh(q + loc + processed_memory))[..., 0]
            energies = energies.masked_fill(memory_pad_mask, neg)
            att_w = torch.softmax(energies, dim=-1)
            att_ctx = torch.bmm(att_w[:, None, :], memory)[:, 0]
            att_w_cum = att_w_cum + att_w
            dh, dc = self.decoder_rnn(torch.cat([ah, att_ctx], dim=-1), (dh, dc))
            if d_mask is not None:
                dh = dh * d_mask[i]
            hid_ctx = torch.cat([dh, att_ctx], dim=-1)
            mel_out.append(self.linear_projection(hid_ctx))
            gate_out.append(self.gate_layer(hid_ctx)[..., 0])
            align.append(att_w)
        return (torch.stack(mel_out, dim=1), torch.stack(gate_out, dim=1),
                torch.stack(align, dim=1))


class JDIT(nn.Module):
    """Reference jdit.py:493-520. The decoder's widths default to the
    reference's hard-coded Tacotron2 values; `JDITConfig` overrides them."""

    def __init__(self, n_mels: int = 80, encoder_dim: int = 256,
                 attention_rnn_dim: int = 1024, decoder_rnn_dim: int = 1024,
                 prenet_dim: int = 256, attention_dim: int = 128,
                 location_filters: int = 32, location_kernel: int = 31):
        super().__init__()
        self.decoder = JDITDecoder(n_mels, encoder_dim, attention_rnn_dim, decoder_rnn_dim,
                                   prenet_dim, attention_dim, location_filters,
                                   location_kernel)

    def forward(self, encoder_outputs: torch.Tensor, mels: torch.Tensor,
                src_pad_mask: torch.Tensor, generator: torch.Generator):
        return self.decoder(encoder_outputs, mels, src_pad_mask, generator)


def attention_to_duration(alignments: torch.Tensor, src_len: torch.Tensor) -> torch.Tensor:
    """(B, T, L) soft alignments -> (B, L) integer durations: the number of
    frames whose argmax lands on each phoneme, 0 past `src_len`."""
    l = alignments.shape[2]
    onehot = F.one_hot(alignments.argmax(dim=-1), l)  # (B, T, L)
    durations = onehot.sum(dim=1).to(torch.int32)
    valid = torch.arange(l, device=alignments.device)[None, :] < src_len[:, None]
    return torch.where(valid, durations, torch.zeros_like(durations))
