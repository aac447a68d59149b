"""FastSpeech2 with mid-attribute speaker generation (port of
masg_tpu/models/fastspeech2.py).

Encoder -> (+ speaker embedding) -> variance adaptor -> decoder -> mel
linear -> PostNet residual, plus the TacoSpawn SpeakerMetaEncoder GMM prior
over speaker embeddings. Reference: model/fastspeech2.py:15-341.

With `use_jdit` the JDIT teacher (`models/jdit.py`) rides on top: given the
ground-truth mels it reads the raw encoder output, before the speaker vector
is added, and returns a parallel mel and alignments (reference
fastspeech2.py:77-78).

On a model axis (`from_config(..., mesh=)` with n_model > 1) the FFT blocks
and PostNet convs 0-3 hold this rank's shard (`models/layers.py`,
`models/postnet.py`); everything else is replicated.

Parameter names are the reference's torch names, so a reference-format
checkpoint (`{"model": state_dict}`, as `python -m masg_tpu.cli.convert_checkpoint
--to_torch` writes it) loads with `strict=True`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ExperimentConfig, Stats
from ..ops.gmm import DiagGMM
from ..ops.masks import pad_mask_from_lengths
from ..utils import profiling
from .encoder import Decoder, Encoder
from .jdit import JDIT
from .postnet import PostNet
from .variance_adaptor import VarianceAdaptor, make_bins


class SpeakerMetaEncoder(nn.Module):
    """Metadata one-hot -> diagonal GMM over speaker space (TacoSpawn prior;
    reference model/fastspeech2.py:306-341: pi via softmax, sigma via
    softplus, mu linear; K mixtures x D = encoder_hidden)."""

    def __init__(self, meta_dim: int, n_mixtures: int = 3, hidden: int = 256):
        super().__init__()
        self.n_mixtures = n_mixtures
        self.hidden = hidden
        self.pi_linear = nn.Sequential(nn.Linear(meta_dim, n_mixtures))
        self.sigma_linear = nn.Sequential(nn.Linear(meta_dim, n_mixtures * hidden))
        self.mu_linear = nn.Linear(meta_dim, n_mixtures * hidden)

    def forward(self, one_hot: torch.Tensor) -> DiagGMM:
        shape = one_hot.shape[:-1] + (self.n_mixtures, self.hidden)
        pi = torch.softmax(self.pi_linear(one_hot), dim=-1)
        sigma = F.softplus(self.sigma_linear(one_hot)).reshape(shape)
        mu = self.mu_linear(one_hot).reshape(shape)
        return DiagGMM(pi=pi, mu=mu, sigma=sigma)


class FS2Output(NamedTuple):
    """Named equivalent of the reference's 12-tuple (fastspeech2.py:147-161)."""

    mel: torch.Tensor  # (B, T, n_mels) pre-postnet
    postnet_mel: torch.Tensor  # (B, T, n_mels)
    pitch_prediction: torch.Tensor
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor
    duration_rounded: torch.Tensor
    src_pad_mask: torch.Tensor  # (B, L) True at pads
    mel_pad_mask: torch.Tensor  # (B, T)
    src_len: torch.Tensor  # (B,)
    mel_len: torch.Tensor  # (B,)
    speaker_gmm: Optional[DiagGMM] = None  # prior GMM per batch row
    speaker_emb: Optional[torch.Tensor] = None  # (B, H) table embeddings
    mel_jdit: Optional[torch.Tensor] = None  # (B, T, n_mels) JDIT teacher mel
    alignments: Optional[torch.Tensor] = None  # (B, T, L) JDIT soft alignments


class FastSpeech2(nn.Module):
    """See module docstring. Construct via `FastSpeech2.from_config`."""

    def __init__(self, pitch_bins, energy_bins, n_speakers: int = 1,
                 multi_speaker: bool = True, meta_dim: int = 4,
                 encoder_hidden: int = 256, encoder_layer: int = 4, encoder_head: int = 2,
                 decoder_hidden: int = 256, decoder_layer: int = 6, decoder_head: int = 2,
                 conv_filter_size: int = 1024, conv_kernel_size=(9, 1),
                 encoder_dropout: float = 0.2, decoder_dropout: float = 0.2,
                 max_seq_len: int = 1000, n_bins: int = 256, vp_filter_size: int = 256,
                 vp_kernel_size: int = 3, vp_dropout: float = 0.5,
                 pitch_feature_level: str = "phoneme_level",
                 energy_feature_level: str = "phoneme_level", gmm_mixtures: int = 3,
                 n_mel_channels: int = 80, use_flash: bool = True,
                 use_jdit: bool = False, jdit_attention_rnn_dim: int = 1024,
                 jdit_decoder_rnn_dim: int = 1024, jdit_prenet_dim: int = 256,
                 jdit_attention_dim: int = 128, jdit_location_filters: int = 32,
                 jdit_location_kernel: int = 31, model_axis=None):
        super().__init__()
        self.multi_speaker = multi_speaker
        self.model_axis = model_axis  # parallel.tensor.ModelAxis, or None
        self.encoder = Encoder(encoder_hidden, encoder_layer, encoder_head,
                               conv_filter_size, conv_kernel_size, encoder_dropout,
                               max_seq_len, use_flash, model_axis)
        self.variance_adaptor = VarianceAdaptor(
            pitch_bins, energy_bins, n_bins, encoder_hidden, vp_filter_size,
            vp_kernel_size, vp_dropout, pitch_feature_level, energy_feature_level)
        self.decoder = Decoder(decoder_hidden, decoder_layer, decoder_head,
                               conv_filter_size, conv_kernel_size, decoder_dropout,
                               max_seq_len, use_flash, model_axis)
        self.mel_linear = nn.Linear(decoder_hidden, n_mel_channels)
        self.jdit = (JDIT(n_mel_channels, encoder_hidden, jdit_attention_rnn_dim,
                          jdit_decoder_rnn_dim, jdit_prenet_dim, jdit_attention_dim,
                          jdit_location_filters, jdit_location_kernel)
                     if use_jdit else None)
        self.postnet = PostNet(n_mel_channels, model_axis=model_axis)
        if multi_speaker:
            self.speaker_emb = nn.Embedding(n_speakers, encoder_hidden)
            self.speaker_enc = SpeakerMetaEncoder(meta_dim, gmm_mixtures, encoder_hidden)

    @staticmethod
    def from_config(cfg: ExperimentConfig, use_flash: bool = True, mesh=None) -> "FastSpeech2":
        """The model `cfg` describes, with fresh (torch default) weights. On
        the model axis of `mesh` (`parallel.mesh.DataMesh`, n_model > 1):
        the whole model is drawn first, as one device draws it, and this
        rank keeps its shard, so every topology starts from the same
        weights."""
        axis = None if mesh is None else mesh.model_axis
        if axis is None:
            return FastSpeech2.build(cfg, use_flash)
        from ..parallel.mesh import shard_state, sharded_names

        whole = FastSpeech2.build(cfg, use_flash)
        model = FastSpeech2.build(cfg, use_flash, axis)
        model.load_state_dict(shard_state(whole.state_dict(), sharded_names(model), axis))
        return model

    @staticmethod
    def build(cfg: ExperimentConfig, use_flash: bool = True, model_axis=None) -> "FastSpeech2":
        """The model `cfg` describes, its layers split on `model_axis`
        (`parallel.tensor.ModelAxis`), with weights drawn at the split's
        shapes (`from_config` gives the one-device weights' shard)."""
        m, p = cfg.model, cfg.preprocess
        if m.multi_speaker and cfg.speakers is None:
            raise FileNotFoundError(
                f"multi_speaker model but no speakers.json in "
                f"{cfg.config_dir or '<config>'} — run preprocessing/gather "
                f"first or set multi_speaker: False")
        stats = cfg.stats if cfg.stats is not None else Stats()
        ve, tr = m.variance_embedding, m.transformer
        return FastSpeech2(
            pitch_bins=make_bins(stats.pitch[0], stats.pitch[1], ve.n_bins,
                                 ve.pitch_quantization),
            energy_bins=make_bins(stats.energy[0], stats.energy[1], ve.n_bins,
                                  ve.energy_quantization),
            n_speakers=cfg.n_speakers,
            multi_speaker=m.multi_speaker,
            meta_dim=p.speaker_generation.one_hot_dim,
            encoder_hidden=tr.encoder_hidden,
            encoder_layer=tr.encoder_layer,
            encoder_head=tr.encoder_head,
            decoder_hidden=tr.decoder_hidden,
            decoder_layer=tr.decoder_layer,
            decoder_head=tr.decoder_head,
            conv_filter_size=tr.conv_filter_size,
            conv_kernel_size=tr.conv_kernel_size,
            encoder_dropout=tr.encoder_dropout,
            decoder_dropout=tr.decoder_dropout,
            max_seq_len=m.max_seq_len,
            n_bins=ve.n_bins,
            vp_filter_size=m.variance_predictor.filter_size,
            vp_kernel_size=m.variance_predictor.kernel_size,
            vp_dropout=m.variance_predictor.dropout,
            pitch_feature_level=p.pitch.feature,
            energy_feature_level=p.energy.feature,
            gmm_mixtures=m.speaker_generation.GMM_mixtures,
            n_mel_channels=p.mel.n_mel_channels,
            use_flash=use_flash,
            use_jdit=m.jdit.use_jdit,
            jdit_attention_rnn_dim=m.jdit.attention_rnn_dim,
            jdit_decoder_rnn_dim=m.jdit.decoder_rnn_dim,
            jdit_prenet_dim=m.jdit.prenet_hidden,
            jdit_attention_dim=m.jdit.attention_dim,
            jdit_location_filters=m.jdit.location_filters,
            jdit_location_kernel=m.jdit.location_kernel,
            model_axis=model_axis,
        )

    def _synthesis_core(self, texts, src_lens, max_mel_len, speaker_vec,
                        mel_pad_mask_in, p_targets, e_targets, d_targets,
                        p_control, e_control, d_control, accents, mels=None,
                        jdit_generator=None, mesh=None) -> FS2Output:
        src_pad_mask = pad_mask_from_lengths(src_lens, texts.shape[1])
        x = self.encoder(texts, src_pad_mask, accents, src_lens)
        mel_jdit = alignments = None
        if self.jdit is not None and mels is not None:
            # the teacher reads the raw encoder output (fastspeech2.py:77-78)
            mel_jdit, _gate, alignments = self.jdit(x, mels, src_pad_mask, jdit_generator)
        if speaker_vec is not None:
            x = x + speaker_vec[:, None, :].to(x.dtype)
        with profiling.span("fs2.variance_adaptor", stream_time=x):
            va = self.variance_adaptor(x, src_pad_mask, max_mel_len, mel_pad_mask_in,
                                       p_targets, e_targets, d_targets,
                                       p_control, e_control, d_control)
        with profiling.span("fs2.decoder", stream_time=x):
            dec_out, mel_pad_mask = self.decoder(va.x, va.mel_pad_mask, va.mel_len,
                                                 truncate=d_targets is not None)
            mel = self.mel_linear(dec_out)
            postnet_mel = self.postnet(mel, mesh) + mel
        return FS2Output(
            mel=mel,
            postnet_mel=postnet_mel,
            pitch_prediction=va.pitch_prediction,
            energy_prediction=va.energy_prediction,
            log_duration_prediction=va.log_duration_prediction,
            duration_rounded=va.duration_rounded,
            src_pad_mask=src_pad_mask,
            mel_pad_mask=mel_pad_mask,
            src_len=src_lens,
            mel_len=va.mel_len.clamp(max=mel_pad_mask.shape[1]),
            mel_jdit=mel_jdit,
            alignments=alignments,
        )

    def forward(self, speakers: torch.Tensor, texts: torch.Tensor,
                src_lens: torch.Tensor, max_mel_len: int,
                mel_lens: Optional[torch.Tensor] = None,
                p_targets: Optional[torch.Tensor] = None,
                e_targets: Optional[torch.Tensor] = None,
                d_targets: Optional[torch.Tensor] = None,
                p_control: float = 1.0, e_control: float = 1.0, d_control: float = 1.0,
                accents: Optional[torch.Tensor] = None,
                speaker_meta: Optional[torch.Tensor] = None,
                mels: Optional[torch.Tensor] = None,
                jdit_generator: Optional[torch.Generator] = None,
                mesh=None) -> FS2Output:
        """`mels` (B, T, n_mels), the ground truth, runs the JDIT teacher of a
        `use_jdit` model, its dropout masks drawn from `jdit_generator`.
        `mesh` (`parallel.mesh.DataMesh`): the data mesh whose global batch
        PostNet's train-mode BatchNorm takes its statistics over."""
        speaker_vec = speaker_gmm = None
        if self.multi_speaker:
            speaker_vec = self.speaker_emb(speakers)
            if speaker_meta is not None:
                speaker_gmm = self.speaker_enc(speaker_meta)
        mel_pad_mask_in = (pad_mask_from_lengths(mel_lens, max_mel_len)
                           if mel_lens is not None else None)
        out = self._synthesis_core(texts, src_lens, max_mel_len, speaker_vec,
                                   mel_pad_mask_in, p_targets, e_targets, d_targets,
                                   p_control, e_control, d_control, accents, mels,
                                   jdit_generator, mesh)
        return out._replace(speaker_gmm=speaker_gmm, speaker_emb=speaker_vec)

    def synthesize_from_speaker_emb(self, texts: torch.Tensor, src_lens: torch.Tensor,
                                    max_mel_len: int, speaker_emb: torch.Tensor,
                                    p_control: float = 1.0, e_control: float = 1.0,
                                    d_control: float = 1.0,
                                    accents: Optional[torch.Tensor] = None) -> FS2Output:
        """Forward pass bypassing the embedding table
        (reference fastspeech2.py:187-303)."""
        return self._synthesis_core(texts, src_lens, max_mel_len, speaker_emb, None,
                                    None, None, None, p_control, e_control, d_control,
                                    accents)

    def speaker_distribution(self, speaker_meta: torch.Tensor) -> DiagGMM:
        """Metadata one-hot -> prior GMM (reference fastspeech2.py:182-185)."""
        return self.speaker_enc(speaker_meta)
