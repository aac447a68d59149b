"""masg_tpu's parameter trees -> this package's `state_dict`s.

The JAX package's weights are nested dicts of numpy arrays (flax params and
batch_stats). These functions map them onto the port's module names, which
are the reference's torch names, so the result loads with `strict=True`:

- `fs2_state_dict_from_jax` is a copy of masg_tpu's `export_torch_fastspeech2`
  + `reference_buffers` (compat/torch_fs2.py), kept here so the port imports
  nothing of masg_tpu. The pitch/energy bins are `make_bins`' values, the
  edges masg_tpu's own forward uses. A JDIT teacher's tree maps too
  (`jdit_state_dict_from_jax`), its two `OptimizedLSTMCell`s as
  `_lstm_layer` splits them;
- `melgan_state_dict_from_jax` maps masg_tpu's `MelGANGenerator` params
  onto the port's `MelGANGenerator`;
- `hifigan_state_dict_from_jax` is the inverse of masg_tpu's
  `convert_torch_state_dict` (models/hifigan.py): a conv kernel goes
  (k, in, out) -> (out, in, k), a transposed conv (k, in, out) -> (in, out, k);
  `hifigan_disc_state_dict_from_jax` does the same for the MPD's
  (k, 1, in, out) -> (out, in, k, 1) and the MSD's (k, in/groups, out);
- `adam_state_from_jax` turns masg_tpu's Adam moments into the port's
  `torch.optim.Adam` state under the same mapping;
- `vocoder_train_state_from_jax` carries a masg_tpu `VocoderTrainState`
  (weight norm's (v, g), spectral norm's (u, v), both AdamW states) into the
  port's;
- `ge2e_state_dict_from_jax` is a copy of masg_tpu's `export_torch_ge2e`
  (GE2E `SpeechEmbedder`), `lang_discriminator_state_dict_from_jax` its
  counterpart for `LangDiscriminator`; both split masg_tpu's folded LSTM
  bias into torch's two;
- `with_duration_bias` is the counterpart of masg_tpu.infer.serving's.

Layouts: torch Linear weight (out, in) <- flax Dense kernel (in, out);
torch Conv1d weight (out, in, k) <- flax Conv kernel (k, in, out).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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


def jdit_state_dict_from_jax(params: Mapping[str, Any], halve_bias: bool = True
                             ) -> Dict[str, torch.Tensor]:
    """masg_tpu `JDIT` params (`{"decoder": ...}`) -> the port's `JDIT`
    state_dict (masg_tpu's `export_torch_fastspeech2`, compat/torch_fs2.py:
    311-332, without its `jdit.` prefix). See `_lstm_layer` for the bias."""
    out: Dict[str, torch.Tensor] = {}
    p = params["decoder"]
    _lin(out, "decoder.prenet.layers.0.linear_layer", p["prenet"]["linear_0"])
    _lin(out, "decoder.prenet.layers.1.linear_layer", p["prenet"]["linear_1"])
    _lin(out, "decoder.attention_layer.memory_layer.linear_layer", p["memory_layer"])
    st = p["step"]
    for rnn in ("attention_rnn", "decoder_rnn"):
        _lstm_layer(out, f"decoder.{rnn}", st[rnn], "", halve_bias)
    att = "decoder.attention_layer"
    _lin(out, f"{att}.query_layer.linear_layer", st["query_layer"])
    _lin(out, f"{att}.v.linear_layer", st["v"])
    _conv(out, f"{att}.location_layer.location_conv.conv", st["location_conv"])
    _lin(out, f"{att}.location_layer.location_dense.linear_layer", st["location_dense"])
    _lin(out, "decoder.linear_projection.linear_layer", st["linear_projection"])
    _lin(out, "decoder.gate_layer.linear_layer", st["gate_layer"])
    return out


def fs2_state_dict_from_jax(params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]],
                            cfg: ExperimentConfig, lstm_halve_bias: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """masg_tpu FastSpeech2 params + batch_stats -> the port's FastSpeech2
    state_dict, derived buffers (position tables, bins, BatchNorm counters)
    included. With `batch_stats` None the BatchNorm statistics are left out
    (a tree shaped like the params, such as an Adam moment). A JDIT
    teacher's folded LSTM biases split in half (`_lstm_layer`); for an Adam
    moment (`lstm_halve_bias=False`) each of torch's two biases carries the
    folded bias's moment as it is, since each sees the folded gradient."""
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
    if "jdit" in params:
        out.update({f"jdit.{k}": v for k, v in
                    jdit_state_dict_from_jax(params["jdit"], lstm_halve_bias).items()})

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
    return _adam_state(count, fs2_state_dict_from_jax(mu, None, cfg, lstm_halve_bias=False),
                       fs2_state_dict_from_jax(nu, None, cfg, lstm_halve_bias=False),
                       model.named_parameters(), optimizer)


def _adam_state(count, exp_avg: Mapping[str, torch.Tensor],
                exp_avg_sq: Mapping[str, torch.Tensor], named_params,
                optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """An Adam/AdamW `state_dict` for `optimizer`, whose parameters are
    `named_params` in order, from the moments by parameter name."""
    state = {}
    for i, (name, p) in enumerate(named_params):
        state[i] = {"step": torch.tensor(float(np.asarray(count))),
                    "exp_avg": exp_avg[name].to(p.dtype),
                    "exp_avg_sq": exp_avg_sq[name].to(p.dtype)}
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


# masg_tpu leaf suffix -> the port's tensor name under a conv module: plain
# weights, weight norm's (v, g) (torch's `original1`, `original0`), biases
_CONV_LEAVES = {"kernel": "weight", "kernel_v": "parametrizations.weight.original1",
                "kernel_g": "parametrizations.weight.original0", "bias": "bias"}
_SN_KERNEL = "parametrizations.weight.original"  # a spectral-norm kernel


def _conv_leaves(out: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any], name: str,
                 perm, sn: bool = False) -> None:
    """The leaves of masg_tpu conv `name` in `p` (a kernel, or weight norm's
    v and g, each `perm`-transposed to torch's layout, and a bias) ->
    `out[prefix + ...]`; with `sn` the kernel is a spectral-norm original."""
    for kind, leaf in _CONV_LEAVES.items():
        x = p.get(f"{name}_{kind}")
        if x is None:
            continue
        if kind == "kernel" and sn:
            leaf = _SN_KERNEL
        x = np.asarray(x)
        out[f"{prefix}.{leaf}"] = _t(x if kind == "bias" else np.transpose(x, perm))


def _n_convs(p: Mapping[str, Any], stem: str) -> int:
    """How many `{stem}_{i}` convs `p` holds (plain or weight-normed)."""
    return len({k[len(stem) + 1:].split("_")[0] for k in p
                if k.startswith(stem + "_") and k[len(stem) + 1:].split("_")[0].isdigit()})


def hifigan_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """masg_tpu HiFiGANGenerator params -> the port's HiFiGANGenerator
    state_dict. A weight-normed tree (masg_tpu's trainer's `kernel_v` /
    `kernel_g`) gives the names of the port's weight-normed generator."""
    out: Dict[str, torch.Tensor] = {}
    conv = (2, 1, 0)
    _conv_leaves(out, "conv_pre", params, "conv_pre", conv)
    n_res = sum(1 for k in params if k.startswith("resblock_0_"))
    for i in range(_n_convs(params, "ups")):
        _conv_leaves(out, f"ups.{i}", params, f"ups_{i}", (1, 2, 0))
        for j in range(n_res):
            block = params[f"resblock_{i}_{j}"]
            for cn in ("convs1", "convs2"):
                for c in range(_n_convs(block, cn)):
                    _conv_leaves(out, f"resblocks.{i * n_res + j}.{cn}.{c}", block,
                                 f"{cn}_{c}", conv)
    _conv_leaves(out, "conv_post", params, "conv_post", conv)
    return out


def hifigan_disc_state_dict_from_jax(mpd_params: Mapping[str, Any], msd_params: Mapping[str, Any],
                                     sn_state: Optional[Mapping[str, Any]] = None
                                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """masg_tpu MultiPeriodDiscriminator and MultiScaleDiscriminator params
    -> the port's (MPD, MSD) state_dicts. MPD kernels (k, 1, in, out) go to
    Conv2d's (out, in, k, 1), its `disc_{p}` to `discriminators.{i}` in
    ascending period order; MSD kernels (k, in/groups, out) to Conv1d's
    (out, in/groups, k). Weight-normed trees give the parametrized names;
    `sn_state` (masg_tpu's spectral-norm (u, v) by kernel path) marks the
    spectral-norm kernels and gives their `_u` / `_v` buffers."""
    sn_state = sn_state or {}
    mpd: Dict[str, torch.Tensor] = {}
    periods = sorted(int(k[len("disc_"):]) for k in mpd_params)
    for i, period in enumerate(periods):
        p = mpd_params[f"disc_{period}"]
        for j in range(_n_convs(p, "convs")):
            _conv_leaves(mpd, f"discriminators.{i}.convs.{j}", p, f"convs_{j}", (3, 2, 0, 1))
        _conv_leaves(mpd, f"discriminators.{i}.conv_post", p, "conv_post", (3, 2, 0, 1))
    msd: Dict[str, torch.Tensor] = {}
    for i in range(len(msd_params)):
        scope = f"disc_{i}"
        p = msd_params[scope]
        names = [(f"convs.{j}", f"convs_{j}") for j in range(_n_convs(p, "convs"))]
        for mod, name in names + [("conv_post", "conv_post")]:
            prefix = f"discriminators.{i}.{mod}"
            sn = sn_state.get(f"{scope}/{name}_kernel")
            _conv_leaves(msd, prefix, p, name, (2, 1, 0), sn=sn is not None)
            if sn is not None:
                msd[f"{prefix}.parametrizations.weight.0._u"] = _t(sn["u"])
                msd[f"{prefix}.parametrizations.weight.0._v"] = _t(sn["v"])
    return mpd, msd


def _adam_moments(opt_state) -> Tuple[Any, Any, Any]:
    """(count, mu, nu) of the scale_by_adam state inside an optax chain state."""
    for part in opt_state:
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return part.count, part.mu, part.nu
    raise ValueError("no Adam moments in this optax state")


def vocoder_train_state_from_jax(state, target):
    """A masg_tpu `train.vocoder.VocoderTrainState` (numpy leaves, e.g. from
    `jax.device_get`) -> `target`, the port's `train.vocoder.
    VocoderTrainState` of the same config, loaded in place and returned:

    - weight norm's `kernel_v` / `kernel_g` become `original1` / `original0` in
      torch layout (the `ups.i` kernels' g is per input channel, torch's dim 0
      of a transposed conv);
    - spectral norm's (u, v) become the `_u` / `_v` buffers as they are
      (masg_tpu's `_sn_matrix` flattens fan_in in torch's (in, k) order);
    - both AdamW states' moments and step counts; the step.
    """
    disc = state.disc_params
    gen_sd = hifigan_state_dict_from_jax(state.gen_params)
    mpd_sd, msd_sd = hifigan_disc_state_dict_from_jax(disc["mpd"], disc["msd"], state.sn_state)
    target.generator.load_state_dict(gen_sd, strict=True)
    target.mpd.load_state_dict(mpd_sd, strict=True)
    target.msd.load_state_dict(msd_sd, strict=True)

    count, mu, nu = _adam_moments(state.gen_opt)
    target.gen_opt.load_state_dict(_adam_state(
        count, hifigan_state_dict_from_jax(mu), hifigan_state_dict_from_jax(nu),
        target.generator.named_parameters(), target.gen_opt))

    def disc_moments(tree):
        # the SN kernels' moments sit at the spectral-norm original's name
        mpd, msd = hifigan_disc_state_dict_from_jax(tree["mpd"], tree["msd"], state.sn_state)
        out = {f"mpd.{k}": v for k, v in mpd.items()}
        out.update({f"msd.{k}": v for k, v in msd.items()})
        return out

    count, mu, nu = _adam_moments(state.disc_opt)
    named = [(f"mpd.{n}", p) for n, p in target.mpd.named_parameters()]
    named += [(f"msd.{n}", p) for n, p in target.msd.named_parameters()]
    target.disc_opt.load_state_dict(_adam_state(count, disc_moments(mu), disc_moments(nu),
                                                named, target.disc_opt))
    target.step = int(np.asarray(state.step))
    return target


def melgan_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """masg_tpu `MelGANGenerator` params (flat `<name>_kernel` (k, in, out)
    and `<name>_bias`) -> the port's `MelGANGenerator` state_dict: conv
    kernels to (out, in, k), the `ups_i` transposed-conv kernels to
    (in, out, k); `res_i_j_conv1` becomes `res.i.j.conv1`."""
    out: Dict[str, torch.Tensor] = {}
    for key, x in params.items():
        name, leaf = key.rsplit("_", 1)
        parts = name.split("_")
        if parts[0] == "ups":
            mod, perm = f"ups.{parts[1]}", (1, 2, 0)
        elif parts[0] == "res":
            mod, perm = f"res.{parts[1]}.{parts[2]}.{parts[3]}", (2, 1, 0)
        else:
            mod, perm = name, (2, 1, 0)
        x = np.asarray(x)
        out[f"{mod}.{'weight' if leaf == 'kernel' else 'bias'}"] = _t(
            np.transpose(x, perm) if leaf == "kernel" else x)
    return out


def _lstm_layer(out: Dict[str, torch.Tensor], prefix: str, cell: Mapping[str, Any],
                sfx: str, halve_bias: bool = True) -> None:
    """One flax `OptimizedLSTMCell` -> torch `nn.LSTM` layer `sfx`, or an
    `nn.LSTMCell` with `sfx` "" (a copy of masg_tpu's `_lstm_cell_out`,
    compat/torch_fs2.py:244-262).

    The gate kernels i{i,f,g,o} / h{i,f,g,o} (in, hidden) stack into
    weight_ih / weight_hh (4 hidden, in) in torch's (i, f, g, o) row order.
    masg_tpu keeps one bias per gate, the sum of torch's two; it is split
    evenly, bias_ih = bias_hh = B / 2. That is the condition under which
    masg_tpu's two-bias compat (train/optim.py:168-222: the folded bias's
    doubled Adam update, half weight decay, double-counted clip norm) is
    exact, and both halves then stay equal for the whole trajectory.
    `halve_bias=False` (an Adam moment) copies the folded value to both.
    """
    gates = ("i", "f", "g", "o")
    wi = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates], axis=0)
    wh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates], axis=0)
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates], axis=0)
    if halve_bias:
        b = b / 2.0
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
