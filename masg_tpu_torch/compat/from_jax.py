"""masg_tpu's parameter trees -> this package's `state_dict`s.

The JAX package's weights are nested dicts of numpy arrays (flax params and
batch_stats). These functions map them onto the port's module names, which
are the reference's torch names, so the result loads with `strict=True`:

- `fs2_state_dict_from_jax` is a copy of masg_tpu's `export_torch_fastspeech2`
  + `reference_buffers` (compat/torch_fs2.py), kept here so the port imports
  nothing of masg_tpu. The pitch/energy bins are `make_bins`' values, the
  edges masg_tpu's own forward uses;
- `hifigan_state_dict_from_jax` is the inverse of masg_tpu's
  `convert_torch_state_dict` (models/hifigan.py): a conv kernel goes
  (k, in, out) -> (out, in, k), a transposed conv (k, in, out) -> (in, out, k);
- `adam_state_from_jax` turns masg_tpu's Adam moments into the port's
  `torch.optim.Adam` state under the same mapping;
- `ge2e_state_dict_from_jax` is a copy of masg_tpu's `export_torch_ge2e`
  (GE2E `SpeechEmbedder`), `lang_discriminator_state_dict_from_jax` its
  counterpart for `LangDiscriminator`; both split masg_tpu's folded LSTM
  bias into torch's two;
- `with_duration_bias` is the counterpart of masg_tpu.infer.serving's.

Layouts: torch Linear weight (out, in) <- flax Dense kernel (in, out);
torch Conv1d weight (out, in, k) <- flax Conv kernel (k, in, out).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.config import ExperimentConfig
from ..models.variance_adaptor import make_bins
from ..ops.positional import sinusoid_table

DURATION_BIAS_KEY = "variance_adaptor.duration_predictor.linear_layer.bias"


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _lin(out, prefix, p):
    out[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _conv(out, prefix, p):
    out[prefix + ".weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _ln(out, prefix, p):
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _fft_block(out, prefix, p):
    for k in ("w_qs", "w_ks", "w_vs", "fc"):
        _lin(out, f"{prefix}.slf_attn.{k}", p["slf_attn"][k])
    _ln(out, f"{prefix}.slf_attn.layer_norm", p["slf_attn"]["layer_norm"])
    _conv(out, f"{prefix}.pos_ffn.w_1", p["pos_ffn"]["w_1"])
    _conv(out, f"{prefix}.pos_ffn.w_2", p["pos_ffn"]["w_2"])
    _ln(out, f"{prefix}.pos_ffn.layer_norm", p["pos_ffn"]["layer_norm"])


def _variance_predictor(out, prefix, p):
    _conv(out, f"{prefix}.conv_layer.conv1d_1.conv", p["conv1d_1"])
    _ln(out, f"{prefix}.conv_layer.layer_norm_1", p["layer_norm_1"])
    _conv(out, f"{prefix}.conv_layer.conv1d_2.conv", p["conv1d_2"])
    _ln(out, f"{prefix}.conv_layer.layer_norm_2", p["layer_norm_2"])
    _lin(out, f"{prefix}.linear_layer", p["linear_layer"])


def fs2_state_dict_from_jax(params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]],
                            cfg: ExperimentConfig) -> Dict[str, torch.Tensor]:
    """masg_tpu FastSpeech2 params + batch_stats -> the port's FastSpeech2
    state_dict, derived buffers (position tables, bins, BatchNorm counters)
    included. With `batch_stats` None the BatchNorm statistics are left out
    (a tree shaped like the params, such as an Adam moment)."""
    if "jdit" in params:
        raise NotImplementedError(
            "JDIT weights: the JDIT teacher is not ported yet (ROADMAP.md, port "
            "queue: MelGAN and JDIT)")
    tr, ve = cfg.model.transformer, cfg.model.variance_embedding
    out: Dict[str, torch.Tensor] = {}

    enc = params["encoder"]
    out["encoder.position_enc"] = sinusoid_table(cfg.model.max_seq_len + 1,
                                                 tr.encoder_hidden)[None]
    out["encoder.src_word_emb.weight"] = _t(enc["src_word_emb"]["table"]["embedding"])
    if "src_accent_emb" in enc:
        out["encoder.src_accent_emb.weight"] = _t(
            enc["src_accent_emb"]["table"]["embedding"])
    out["decoder.position_enc"] = sinusoid_table(cfg.model.max_seq_len + 1,
                                                 tr.decoder_hidden)[None]
    for stack in ("encoder", "decoder"):
        for k, v in params[stack].items():
            if k.startswith("layer_"):
                _fft_block(out, f"{stack}.layer_stack.{k[len('layer_'):]}", v)

    va = params["variance_adaptor"]
    stats = cfg.stats
    for key, st, quant in (("pitch", stats.pitch, ve.pitch_quantization),
                           ("energy", stats.energy, ve.energy_quantization)):
        out[f"variance_adaptor.{key}_bins"] = _t(make_bins(st[0], st[1], ve.n_bins, quant))
    for vp in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _variance_predictor(out, f"variance_adaptor.{vp}", va[vp])
    for key in ("pitch_embedding", "energy_embedding"):
        out[f"variance_adaptor.{key}.weight"] = _t(va[key]["embedding"])

    _lin(out, "mel_linear", params["mel_linear"])

    pn = params["postnet"]
    n_convs = sum(1 for k in pn if k.startswith("conv_"))
    for i in range(n_convs):
        pre = f"postnet.convolutions.{i}"
        _conv(out, f"{pre}.0.conv", pn[f"conv_{i}"])
        out[f"{pre}.1.weight"] = _t(pn[f"bn_{i}"]["scale"])
        out[f"{pre}.1.bias"] = _t(pn[f"bn_{i}"]["bias"])
        if batch_stats is not None:
            bs = batch_stats["postnet"][f"bn_{i}"]
            out[f"{pre}.1.running_mean"] = _t(bs["mean"])
            out[f"{pre}.1.running_var"] = _t(bs["var"])
            out[f"{pre}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    if "speaker_emb" in params:
        out["speaker_emb.weight"] = _t(params["speaker_emb"]["embedding"])
        se = params["speaker_enc"]
        _lin(out, "speaker_enc.pi_linear.0", se["pi_linear"])
        _lin(out, "speaker_enc.sigma_linear.0", se["sigma_linear"])
        _lin(out, "speaker_enc.mu_linear", se["mu_linear"])
    return out


def adam_state_from_jax(count, mu: Mapping[str, Any], nu: Mapping[str, Any],
                        model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        cfg: ExperimentConfig) -> Dict[str, Any]:
    """masg_tpu's `ScaleByAdamTorchState` (count, mu, nu; numpy trees shaped
    like the params) -> a `state_dict` for the port's `torch.optim.Adam` over
    `model.parameters()`, under `fs2_state_dict_from_jax`'s name mapping.

    The Adam math is the same on both sides, so a masg_tpu run resumes here
    with its moments; position the schedule at `count` as well
    (`train.optim.set_schedule_count`).
    """
    exp_avg = fs2_state_dict_from_jax(mu, None, cfg)
    exp_avg_sq = fs2_state_dict_from_jax(nu, None, cfg)
    sd = optimizer.state_dict()
    state = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        state[i] = {"step": torch.tensor(float(np.asarray(count))),
                    "exp_avg": exp_avg[name].to(p.dtype),
                    "exp_avg_sq": exp_avg_sq[name].to(p.dtype)}
    return {"state": state, "param_groups": sd["param_groups"]}


def hifigan_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """masg_tpu HiFiGANGenerator params -> the port's HiFiGANGenerator state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def conv(prefix, name):
        out[prefix + ".weight"] = _t(np.transpose(np.asarray(params[name + "_kernel"]),
                                                  (2, 1, 0)))
        out[prefix + ".bias"] = _t(params[name + "_bias"])

    conv("conv_pre", "conv_pre")
    n_up = sum(1 for k in params if k.startswith("ups_") and k.endswith("_kernel"))
    n_res = sum(1 for k in params if k.startswith("resblock_0_"))
    for i in range(n_up):
        out[f"ups.{i}.weight"] = _t(np.transpose(np.asarray(params[f"ups_{i}_kernel"]),
                                                 (1, 2, 0)))
        out[f"ups.{i}.bias"] = _t(params[f"ups_{i}_bias"])
        for j in range(n_res):
            block = params[f"resblock_{i}_{j}"]
            n_dil = sum(1 for k in block if k.startswith("convs1_") and k.endswith("_kernel"))
            for cn in ("convs1", "convs2"):
                for c in range(n_dil):
                    pre = f"resblocks.{i * n_res + j}.{cn}.{c}"
                    out[pre + ".weight"] = _t(np.transpose(
                        np.asarray(block[f"{cn}_{c}_kernel"]), (2, 1, 0)))
                    out[pre + ".bias"] = _t(block[f"{cn}_{c}_bias"])
    conv("conv_post", "conv_post")
    return out


def _lstm_layer(out: Dict[str, torch.Tensor], prefix: str, cell: Mapping[str, Any],
                sfx: str) -> None:
    """One flax `OptimizedLSTMCell` -> torch `nn.LSTM` layer `sfx` (a copy of
    masg_tpu's `_lstm_cell_out`, compat/torch_fs2.py:244-262).

    The gate kernels i{i,f,g,o} / h{i,f,g,o} (in, hidden) stack into
    weight_ih / weight_hh (4 hidden, in) in torch's (i, f, g, o) row order.
    masg_tpu keeps one bias per gate, the sum of torch's two; it is split
    evenly, bias_ih = bias_hh = B / 2. That is the condition under which
    masg_tpu's two-bias compat (train/optim.py:168-222: the folded bias's
    doubled Adam update, half weight decay, double-counted clip norm) is
    exact, and both halves then stay equal for the whole trajectory.
    """
    gates = ("i", "f", "g", "o")
    wi = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates], axis=0)
    wh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates], axis=0)
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates], axis=0) / 2.0
    out[f"{prefix}.weight_ih{sfx}"] = _t(wi)
    out[f"{prefix}.weight_hh{sfx}"] = _t(wh)
    out[f"{prefix}.bias_ih{sfx}"] = _t(b)
    out[f"{prefix}.bias_hh{sfx}"] = _t(b.copy())


def ge2e_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """masg_tpu `SpeechEmbedder` params -> the port's `SpeechEmbedder`
    state_dict (the reference GE2E names, masg_tpu's `export_torch_ge2e`,
    compat/torch_fs2.py:624-657). See `_lstm_layer` for the bias split."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"OptimizedLSTMCell_{i}" in params:
        _lstm_layer(out, "LSTM_stack", params[f"OptimizedLSTMCell_{i}"], f"_l{i}")
        i += 1
    _lin(out, "projection.linear_layer", params["projection"])
    head = "da_classifier.classifier.layer"
    for j, name in enumerate(("da_linear_0", "da_linear_1", "da_linear_out")):
        if name in params:
            _lin(out, f"{head}.linear_{j}.linear_layer", params[name])
    return out


def lang_discriminator_state_dict_from_jax(params: Mapping[str, Any]
                                           ) -> Dict[str, torch.Tensor]:
    """masg_tpu `LangDiscriminator` params -> the port's `LangDiscriminator`."""
    out: Dict[str, torch.Tensor] = {}
    _lstm_layer(out, "lstm", params["OptimizedLSTMCell_0"], "_l0")
    _lin(out, "linear", params["linear"])
    return out


def with_duration_bias(state_dict: Mapping[str, torch.Tensor],
                       value: float) -> Dict[str, torch.Tensor]:
    """`state_dict` with the duration predictor's output bias shifted by
    `value` (log-duration space). An untrained model predicts
    round(exp(0)-1) = 0 durations and free-runs to zero frames; value = ln(5)
    (~4 frames/phone after rounding) drives the trained-model path at a
    realistic speech rate."""
    out = dict(state_dict)
    out[DURATION_BIAS_KEY] = state_dict[DURATION_BIAS_KEY] + value
    return out
