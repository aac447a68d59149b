"""The reference's parameter order, which keys its optimizer state.

A copy of `reference_param_order` and `ge2e_param_order` from masg_tpu's
compat/torch_fs2.py (with their helpers), and the ganlike layout of its
`export_torch_ganlike_checkpoint`, kept here so the port imports nothing of
masg_tpu.

torch's Adam keys its per-parameter state by position in the list it was
built over. The reference builds it over `model.parameters()`: 131 entries
at the flagship config, the four `requires_grad=False` tables and bins
(`encoder.position_enc`, `variance_adaptor.pitch_bins`,
`variance_adaptor.energy_bins`, `decoder.position_enc`) among them, and each
attention's `layer_norm` before its `fc`. The port's optimizer holds the 127
trainable ones in its own registration order, so `core/checkpoint.py` maps
positions through these names; a checkpoint's optimizer is then the
reference's and masg_tpu's (`import_torch_optimizer` reads it).
"""

from __future__ import annotations

from typing import List, Sequence


def _fft_layer_param_names(prefix: str) -> List[str]:
    names = []
    for m in ("w_qs", "w_ks", "w_vs", "layer_norm", "fc"):
        names += [f"{prefix}.slf_attn.{m}.weight", f"{prefix}.slf_attn.{m}.bias"]
    for m in ("w_1", "w_2", "layer_norm"):
        names += [f"{prefix}.pos_ffn.{m}.weight", f"{prefix}.pos_ffn.{m}.bias"]
    return names


def _predictor_param_names(prefix: str) -> List[str]:
    names = []
    for m in ("conv_layer.conv1d_1.conv", "conv_layer.layer_norm_1",
              "conv_layer.conv1d_2.conv", "conv_layer.layer_norm_2", "linear_layer"):
        names += [f"{prefix}.{m}.weight", f"{prefix}.{m}.bias"]
    return names


def reference_param_order(encoder_layers: int, decoder_layers: int,
                          multi_speaker: bool = True, use_jdit: bool = False,
                          postnet_convs: int = 5) -> List[str]:
    """The reference FastSpeech2's `named_parameters()` order, the grad-less
    tables and bins included: a module's own parameters before its
    children's."""
    names = ["encoder.position_enc", "encoder.src_word_emb.weight",
             "encoder.src_accent_emb.weight"]
    for i in range(encoder_layers):
        names += _fft_layer_param_names(f"encoder.layer_stack.{i}")
    names += ["variance_adaptor.pitch_bins", "variance_adaptor.energy_bins"]
    for vp in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        names += _predictor_param_names(f"variance_adaptor.{vp}")
    names += ["variance_adaptor.pitch_embedding.weight",
              "variance_adaptor.energy_embedding.weight", "decoder.position_enc"]
    for i in range(decoder_layers):
        names += _fft_layer_param_names(f"decoder.layer_stack.{i}")
    names += ["mel_linear.weight", "mel_linear.bias"]
    if use_jdit:
        d = "jdit.decoder"
        names += [f"{d}.prenet.layers.0.linear_layer.weight",
                  f"{d}.prenet.layers.1.linear_layer.weight"]
        names += [f"{d}.attention_rnn.{k}" for k in
                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        names += [f"{d}.attention_layer.query_layer.linear_layer.weight",
                  f"{d}.attention_layer.memory_layer.linear_layer.weight",
                  f"{d}.attention_layer.v.linear_layer.weight",
                  f"{d}.attention_layer.location_layer.location_conv.conv.weight",
                  f"{d}.attention_layer.location_layer.location_dense.linear_layer.weight"]
        names += [f"{d}.decoder_rnn.{k}" for k in
                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        names += [f"{d}.linear_projection.linear_layer.weight",
                  f"{d}.linear_projection.linear_layer.bias",
                  f"{d}.gate_layer.linear_layer.weight",
                  f"{d}.gate_layer.linear_layer.bias"]
    for i in range(postnet_convs):
        names += [f"postnet.convolutions.{i}.0.conv.weight",
                  f"postnet.convolutions.{i}.0.conv.bias",
                  f"postnet.convolutions.{i}.1.weight",
                  f"postnet.convolutions.{i}.1.bias"]
    if multi_speaker:
        names += ["speaker_emb.weight"]
        for m in ("pi_linear.0", "sigma_linear.0", "mu_linear"):
            names += [f"speaker_enc.{m}.weight", f"speaker_enc.{m}.bias"]
    return names


def ge2e_param_order(n_layers: int = 3, use_da: bool = True) -> List[str]:
    """The reference GE2E `SpeechEmbedder`'s `named_parameters()` order:
    LSTM_stack, projection, da_classifier."""
    names = []
    for i in range(n_layers):
        names += [f"LSTM_stack.weight_ih_l{i}", f"LSTM_stack.weight_hh_l{i}",
                  f"LSTM_stack.bias_ih_l{i}", f"LSTM_stack.bias_hh_l{i}"]
    names += ["projection.linear_layer.weight", "projection.linear_layer.bias"]
    if use_da:
        for j in range(3):
            names += [f"da_classifier.classifier.layer.linear_{j}.linear_layer.weight",
                      f"da_classifier.classifier.layer.linear_{j}.linear_layer.bias"]
    return names


def ganlike_param_order(fs2_names: Sequence[str], disc_names: Sequence[str]) -> List[str]:
    """The ganlike optimizer's order: `model.*` then `discriminator.*`
    (the reference's one ScheduledOptim over `GANLike.parameters()`)."""
    return ["model." + n for n in fs2_names] + ["discriminator." + n for n in disc_names]
