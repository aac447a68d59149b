"""Vocoder loading + batched mel->wav inference (port of
masg_tpu/infer/vocoder.py).

Reference: utils/model.py:42-92. Honours the HiFi-GAN config.json schema,
the upstream torch checkpoint format (`{'generator': state_dict}`, weight
norm folded at load) and masg_tpu's flax `.msgpack` generator files, and
builds descript's MelGAN (`models/melgan.py`) from seeded random weights or a
local descript checkpoint, fed log10 mels (`Vocoder.mel_scale`). Streams the
vocoder in receptive-field-exact windows (`vocode_streaming`).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import melgan
from ..models.hifigan import HiFiGANGenerator, fold_weight_norm, init_random_weights
from ..utils import profiling

# `vocoder_infer`'s cut is a multiple of this many frames, which bounds the
# shapes that cuDNN and K4 see
CUT_MULTIPLE = 16

DEFAULT_HIFIGAN_CONFIG = {
    # hifigan/config.json (universal V1)
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "num_mels": 80,
}


class Vocoder:
    """A generator (HiFi-GAN or MelGAN) in eval mode plus the wav scaling the
    CLIs apply. `mel_scale` multiplies the natural-log mel on the way in:
    1/ln 10 for MelGAN, whose checkpoints were trained on log10 mels
    (reference utils/model.py:76-78)."""

    def __init__(self, generator: torch.nn.Module, hop_length: int = 256,
                 max_wav_value: float = 32768.0, mel_scale: float = 1.0):
        self.generator = generator.eval()
        self.hop_length = hop_length
        self.max_wav_value = max_wav_value
        self.mel_scale = mel_scale

    def to(self, device: torch.device, dtype: torch.dtype) -> "Vocoder":
        """A copy of this vocoder on `device` in `dtype`."""
        return Vocoder(copy.deepcopy(self.generator).to(device, dtype), self.hop_length,
                       self.max_wav_value, self.mel_scale)

    @property
    def dtype(self) -> torch.dtype:
        return self.generator.conv_pre.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.generator.conv_pre.weight.device

    @property
    def n_mels(self) -> int:
        return self.generator.conv_pre.in_channels

    @torch.inference_mode()
    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) channel-last log-mel -> (B, T*hop) float wav."""
        mel = torch.as_tensor(mel)
        if self.mel_scale != 1.0:  # in the caller's dtype, as masg_tpu scales
            mel = mel * self.mel_scale
        return self.generator(mel.to(self.device, self.dtype))


def hifigan_config(config_dir: Optional[str] = None) -> dict:
    """The universal V1 config, updated from `<config_dir>/hifigan_config.json`
    when that file exists."""
    cfg = dict(DEFAULT_HIFIGAN_CONFIG)
    path = os.path.join(config_dir or "", "hifigan_config.json")
    if config_dir and os.path.exists(path):
        with open(path) as f:
            cfg.update(json.load(f))
    return cfg


def build_generator(cfg: dict, fused_mrf: bool = True) -> HiFiGANGenerator:
    return HiFiGANGenerator(
        n_mels=cfg.get("num_mels", 80),
        upsample_rates=tuple(cfg["upsample_rates"]),
        upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
        upsample_initial_channel=cfg["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in cfg["resblock_dilation_sizes"]),
        fused_mrf=fused_mrf,
    )


def get_vocoder(model_config, config_dir: Optional[str] = None,
                checkpoint: Optional[str] = None, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32, fused_mrf: bool = True,
                seed: int = 0) -> Vocoder:
    """Build the vocoder named by model_config.vocoder
    (reference get_vocoder, utils/model.py:42-71) on `device` (the card when
    None). Without a checkpoint the generator gets seeded random weights.

    HiFi-GAN: see `load_generator_checkpoint`. MelGAN: descript's generator
    at its defaults; a checkpoint is a descript torch file whose state_dict
    sits under `model_g`, `generator`, `netG` or `state_dict` (or at the
    top); `fused_mrf` does not apply (MelGAN has no MRF)."""
    dev = resolve_device(device)
    name = model_config.vocoder.model
    if name not in ("HiFi-GAN", "MelGAN"):
        raise ValueError(f"unknown vocoder {name!r}")
    if checkpoint and not os.path.exists(checkpoint):
        # a requested-but-missing checkpoint must not silently random-init
        raise FileNotFoundError(f"vocoder checkpoint not found: {checkpoint}")
    if name == "MelGAN":
        gen = melgan.MelGANGenerator()
        if checkpoint:
            ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
            for key in ("model_g", "generator", "netG", "state_dict"):
                if isinstance(ckpt, dict) and key in ckpt:
                    ckpt = ckpt[key]
            gen.load_state_dict(melgan.convert_descript_state_dict(ckpt), strict=True)
        else:
            melgan.init_random_weights(gen, torch.Generator().manual_seed(seed))
        return Vocoder(gen.to(dev, dtype), mel_scale=1.0 / float(np.log(10.0)))

    cfg = hifigan_config(config_dir)
    gen = build_generator(cfg, fused_mrf)
    if checkpoint:
        gen.load_state_dict(load_generator_checkpoint(checkpoint, cfg), strict=True)
    else:
        init_random_weights(gen, torch.Generator().manual_seed(seed))
    return Vocoder(gen.to(dev, dtype))


def load_generator_checkpoint(path: str, cfg: dict) -> dict:
    """Generator state_dict from either checkpoint format: an upstream torch
    `{'generator': state_dict}` file, weight norm folded (weight_g/weight_v ->
    weight), or a flax `.msgpack` of masg_tpu's generator params (what
    `masg_tpu.cli.train_vocoder` writes), whatever the file's suffix. The
    format is read from the file's header, as masg_tpu does: a torch file
    starts with `PK` (zip) or `\x80` (pickle)."""
    with open(path, "rb") as f:
        head = f.read(2)
    if not (head.startswith(b"PK") or head.startswith(b"\x80")):
        from ..compat.from_jax import hifigan_state_dict_from_jax

        with open(path, "rb") as f:
            tree = read_flax_msgpack(f.read())
        return hifigan_state_dict_from_jax(tree)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("generator", ckpt)
    n_res = len(cfg["resblock_kernel_sizes"])
    prefixes = ["conv_pre", "conv_post"]
    for i in range(len(cfg["upsample_rates"])):
        prefixes.append(f"ups.{i}")
        for j in range(n_res):
            n_dil = len(cfg["resblock_dilation_sizes"][j])
            for cn in ("convs1", "convs2"):
                prefixes += [f"resblocks.{i * n_res + j}.{cn}.{c}" for c in range(n_dil)]
    out = {}
    for p in prefixes:
        out[p + ".weight"] = fold_weight_norm(sd, p)
        out[p + ".bias"] = sd[p + ".bias"]
    return out


def read_flax_msgpack(data: bytes) -> dict:
    """A tree of numpy arrays from the bytes of `flax.serialization.to_bytes`:
    msgpack maps, with each array as ext type 1 holding msgpack's (shape,
    dtype name, raw bytes) and each numpy scalar as ext type 3 in the same
    form. Flax's chunked form of arrays over 1 GiB raises: a generator never
    has one."""
    import msgpack

    def ndarray(payload: bytes) -> np.ndarray:
        shape, name, buf = msgpack.unpackb(payload, raw=True)
        name = name.decode()
        if name == "bfloat16":
            raise ValueError("bfloat16 arrays in a .msgpack generator file are not read; "
                             "save the generator's params as float32")
        return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()

    def ext_hook(code: int, payload: bytes):
        if code == 1:
            return ndarray(payload)
        if code == 3:
            return ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code} in a flax checkpoint")

    tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("flax's chunked-array form (arrays over 1 GiB) is not "
                                 "read: a HiFi-GAN generator has no such array")
            for v in node.values():
                check(v)

    if not isinstance(tree, dict):
        raise ValueError("a flax .msgpack checkpoint holds a tree of dicts")
    check(tree)
    return tree


def to_int16(wav: np.ndarray, max_wav_value: float) -> np.ndarray:
    """Float wav in [-1, 1] -> int16 samples; clipped before the cast, since
    loud samples would integer-wrap otherwise."""
    return np.clip(wav * max_wav_value, -32768, 32767).astype(np.int16)


def trim_to_int16(wav: torch.Tensor, max_wav_value: float,
                  lengths: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, List[int]]:
    """(B, T) float wav -> (the rows' kept samples as one flat int16 tensor on
    wav's device, each row's count): `to_int16` and `vocoder_infer`'s trim in
    torch, bit for bit. Row b keeps its prefix of `lengths[b]` samples, with
    Python's slice rule (at most T); all of it when `lengths` is None. The
    rows are put together before the conversion, so it touches only the
    kept samples, and their counts come from the slices' shapes, with no
    wait for the device. The multiply is one f32 product (exact for 32768)
    and the cast truncates toward zero, as numpy's does."""
    rows = list(wav) if lengths is None else [w[: int(n)] for w, n in zip(wav, lengths)]
    sizes = [r.shape[0] for r in rows]
    if not rows:
        return wav.new_empty(0, dtype=torch.int16), sizes
    flat = torch.cat(rows).float() * max_wav_value
    return flat.clamp_(-32768, 32767).to(torch.int16), sizes


@torch.inference_mode()
def _int16_rows_to_host(wav: torch.Tensor, max_wav_value: float,
                        lengths: Optional[Sequence[int]]) -> List[np.ndarray]:
    """`trim_to_int16` on the card, then one copy of the kept samples into
    page-locked memory from torch's caching host allocator. The rows are
    views of that buffer, and their numpy base holds it, so the allocator
    takes the block back only once every row of the call is gone."""
    flat, sizes = trim_to_int16(wav, max_wav_value, lengths)
    host = torch.empty(flat.shape, dtype=torch.int16, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    flat_np = host.numpy()
    ends = itertools.accumulate(sizes)
    return [flat_np[end - n: end] for n, end in zip(sizes, ends)]


def cut_frames(vocoder: Vocoder, frames: int,
               lengths: Optional[Sequence[int]] = None) -> int:
    """The mel frames `vocoder_infer` runs the generator over:
    T_cut = min(T, round_up(ceil(max(lengths) / hop) + R, CUT_MULTIPLE)),
    R the generator's `right_context_frames`. T itself without `lengths`,
    with a negative length (Python's slice rule then keeps samples counted
    from the end), or for a generator with no such bound (MelGAN)."""
    gen = vocoder.generator
    if lengths is None or len(lengths) == 0 or not hasattr(gen, "right_context_frames"):
        return frames
    n = [int(x) for x in lengths]
    if min(n) < 0:
        return frames
    hop = math.prod(gen.upsample_rates)
    need = -(-max(n) // hop) + gen.right_context_frames()
    return min(frames, -(-need // CUT_MULTIPLE) * CUT_MULTIPLE)


def vocoder_infer(mels: torch.Tensor, vocoder: Vocoder,
                  lengths: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """(B, T, n_mels) -> list of int16 wavs, truncated to `lengths` samples
    (reference vocoder_infer, utils/model.py:74-92).

    With `lengths`, the generator runs over the mel's first `cut_frames`
    frames only, in one call: every kept sample reads the same frames as
    in a run over all T, so the rows are those of the whole mel trimmed.
    A wav made on the card is converted and trimmed there
    (`trim_to_int16`) and only the kept samples come to the host; a wav on
    the CPU goes through numpy's `to_int16`. Both give the same samples."""
    t = mels.shape[1]
    t_cut = cut_frames(vocoder, t, lengths)
    wav = vocoder(mels[:, :t_cut])
    with profiling.span("vocoder.to_int16"):
        if wav.is_cuda:
            out = _int16_rows_to_host(wav, vocoder.max_wav_value, lengths)
        else:
            out = list(to_int16(wav.float().cpu().numpy(), vocoder.max_wav_value))
            if lengths is not None:
                out = [w[: int(n)] for w, n in zip(out, lengths)]
    if profiling.enabled():
        profiling.count("vocoder.samples", wav.numel())
        if t_cut < t:
            profiling.count("vocoder.cut_frames", len(out) * (t - t_cut))
        profiling.count("vocoder.useful_samples", sum(len(w) for w in out))
        if wav.is_cuda:
            profiling.count("vocoder.device_int16", len(out))
    return out


def measure_receptive_field_frames(vocoder: Vocoder, probe_frames: int = 257,
                                   lock=None) -> int:
    """Mel-frame receptive-field radius of the loaded generator, measured
    empirically (the support of an impulse's response), so streaming context
    adapts to any convolutional vocoder instead of assuming the stock V1
    architecture (~15 frames). Cached per Vocoder (`_rf_frames`). `lock`, when
    given, is held around each vocoder run."""
    cached = getattr(vocoder, "_rf_frames", None)
    if cached is not None:
        return cached
    h = vocoder.hop_length
    center = probe_frames // 2
    base = torch.zeros((1, probe_frames, vocoder.n_mels), dtype=torch.float32)
    probe = base.clone()
    probe[0, center, :] = 1.0
    with lock or contextlib.nullcontext():
        d = (vocoder(probe)[0].float() - vocoder(base)[0].float()).abs().cpu().numpy()
    nz = np.nonzero(d > 1e-12)[0]
    if nz.size == 0:
        rf = 1  # degenerate (e.g. zero weights)
    else:
        lo, hi = int(nz[0]), int(nz[-1])
        if lo == 0 or hi == d.size - 1:
            raise ValueError(
                f"vocoder receptive field exceeds the {probe_frames}-frame "
                "probe: pass context_frames explicitly")
        rf = max((center * h - lo + h - 1) // h, (hi - center * h) // h + 1)
    vocoder._rf_frames = int(rf)
    return vocoder._rf_frames


def vocode_streaming(vocoder: Vocoder, mel, chunk_frames: int = 192,
                     context_frames: Optional[int] = None,
                     lock=None) -> Iterator[np.ndarray]:
    """Stream the vocoder: yield int16 wav chunks whose concatenation equals
    `vocoder_infer` on the full mel (masg_tpu's window scheme).

    The generator is fully convolutional, so an interior output sample depends
    only on the mel frames within its receptive field; `context_frames`
    defaults to the measured field + 2 (`measure_receptive_field_frames`).
    Windows: the first chunk K + C frames (the true left edge), interior
    chunks K + 2C, the final one right-aligned at the true end with the same
    K + 2C shape; an input of 2C < t <= K + 2C frames goes as two edge-aligned
    zero-padded K + 2C windows, and one of t <= 2C at its own length. So the
    generator's own edge padding applies exactly as in the full run, and only
    two window shapes occur whatever the input length.

    mel: (1, T, n_mels) log-mel, numpy or tensor. `lock`, when given, is held
    around each window's vocoder run (requests interleave between windows).
    Yields np.int16 arrays; nothing for an empty mel.
    """
    mel = torch.as_tensor(mel)
    if mel.dim() != 3 or mel.shape[0] != 1:
        raise ValueError("vocode_streaming expects a single utterance (1, T, n_mels)")
    if context_frames is None:
        context_frames = measure_receptive_field_frames(vocoder, lock=lock) + 2
    if chunk_frames < 1 or context_frames < 0:
        raise ValueError(
            f"chunk_frames must be >= 1 and context_frames >= 0 "
            f"(got {chunk_frames}, {context_frames})")
    t = mel.shape[1]
    k, c = chunk_frames, context_frames
    h = vocoder.hop_length
    s = k + 2 * c  # the interior window shape
    mel = mel.float()

    def run(window: torch.Tensor) -> np.ndarray:
        with lock or contextlib.nullcontext():
            wav = vocoder(window)[0].float().cpu().numpy()
        return to_int16(wav, vocoder.max_wav_value)

    if t == 0:
        return
    if t <= 2 * c:
        # too short to split exactly: vocode at its own length
        yield run(mel)
        return

    if t <= s:
        # one-chunk inputs still take the interior shape: two edge-aligned
        # zero-padded windows whose kept regions stay >= c frames away from
        # the padded side, so each true edge sees the generator's own padding
        left = torch.nn.functional.pad(mel, (0, 0, 0, s - t))
        yield run(left)[: (t - c) * h]
        right = torch.nn.functional.pad(mel, (0, 0, s - t, 0))
        yield run(right)[(s - c) * h:]
        return

    # first chunk: the true left edge, C frames of right context (K + C)
    yield run(mel[:, : k + c])[: k * h]
    pos = k
    # interior chunks: C real frames of context on each side (K + 2C)
    while pos + k + c <= t:
        yield run(mel[:, pos - c: pos + k + c])[c * h: (c + k) * h]
        pos += k
    remaining = t - pos
    if remaining > 0:
        # final chunk right-aligned at the true end (the interior shape):
        # keeps >= C frames of left context since remaining <= K + C
        yield run(mel[:, t - s:])[(s - remaining) * h:]
