#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`masg_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. header: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the three CUDA kernel libraries from `masg_tpu_torch/csrc/` with nvcc
   (sm_90a), all at once, print ptxas' register / shared-memory / spill report
   (0 spill bytes required of the f32 K1 and K3 at Dh = 128, of every f32 K2
   entry (Dh 16/32/64/128, 32- and 64-row tiles) and of the f32 K4), and count
   the tensor-core instructions (HMMA, HGMMA) of every kernel entry point in
   the SASS (`cuobjdump -sass`): every bf16 entry of K1, K2, K3 (one per Dh in
   16/32/64/128) and K4 (C = 32, 64), and the 3xTF32 f32 K4 (C = 32, 64),
   must have some;
3. K1 (flash-attention forward) against its plain PyTorch version:
   B=16, H=2, Dh=128, T in {128, 640, 1000}, ragged lengths including 0 and
   1, float32 and bfloat16; times of the kernel, the plain version, masked
   `scaled_dot_product_attention` (a yardstick the port never calls) and the
   least time the card could take (bound), the kernel's and SDPA's also as
   device time from a torch.profiler window;
4. K4 (fused MRF stage) against its plain version at the HiFi-GAN V1 stage
   shapes of the main path (C=64 at T=81920, C=32 at T=163840, B=16), and
   a run that starts 1037 rows later, which must give the same bits at every
   row more than 64 rows past the cut (float32 and bfloat16); the float32
   bound is given at the 3xTF32 rate (the TF32 tensor-core rate / 3) beside
   the CUDA cores' f32 rate;
5. K2/K3 (flash-attention dQ and dK/dV) against their plain versions at the
   K1 shapes, with the cotangent zero at padded query rows, and the same
   bits from two launches of K2; times of the
   kernels, the plain versions, the backward of masked SDPA (K2 + K3
   together, a yardstick the port never calls) and the bound, by CUDA events
   and, for the kernels and SDPA's backward, as device time from a
   torch.profiler window (events time the host at these sizes);
6. the inference path: flagship FastSpeech2 (~35M parameters, seeded random
   weights, duration bias ln 5) + HiFi-GAN V1 through `synthesize_batch` ->
   `vocoder_infer` at B=16, L=128, T_mel=640, in bfloat16 and in float32,
   with the launch counters reset just before and read just after; the
   float32 kernel path against the plain path; text->wav real-time factors;
   one speaker_distribution -> GMM sample -> synthesize_from_speaker_emb run;
   then a torch.profiler window over one bfloat16 kernel-path text->wav: the
   device's idle share, K1's and K4's device time, the vocoder's device time
   outside K4 and its host-only time;
7. the train path: the plain FastSpeech2 train step (`train.step`) at the
   flagship width and B=16, L=128, T_mel=640: float32 kernel vs plain path
   (loss, every gradient, BatchNorm statistics; dropout off), launch counts
   per step, steps/s in float32 and bf16 autocast on both paths, and 20
   bf16-autocast steps against float32;
8. a torch.profiler window over 3 kernel-path train steps per dtype: the
   device's idle share, K1's, K2's, K3's and the optimizer's device time;
9. the trainer: `cli.train` on a random 32-utterance corpus at the flagship
   width, 4 steps, a run resumed at step 2 that must repeat steps 3 and 4,
   and `cli.evaluate` on the saved step;
10. one `{"kernels": [...]}` line: K1-K4 once each, at the bfloat16 path's
   inputs, with the float32 figures as fields (`float32_forward`: K1 and K4
   per float32 forward; `float32_train_step`: K1, K2, K3 per float32 train
   step);
11. the `{"ok": true, ...}` line, last.

Tolerances (kernel vs plain, on the card, TF32 off everywhere):
- K1 float32: |o| within 2e-5 (masg_tpu's flash bar), LSE within 1e-4;
  bfloat16: atol = rtol = 1e-2 (both sides round a float32 result to
  bfloat16; the kernel also rounds p to bfloat16 for the tensor-core p.v
  product, 2^-9 relative per term: one to two bfloat16 ulps apart), LSE
  within 1e-4 (the kernel sums the unrounded float32 p);
  rows with no valid key: o == 0 and LSE == -inf on both sides.
- K4 float32: 2e-5 (18 chained convolutions summed in another order than
  cuDNN's, outputs up to ~8); bfloat16: 0.125 (each conv output is rounded
  to bfloat16 on both sides; a rounding flip early in the chain carries on:
  4 ulps at magnitudes 4-8); a run from a later row: bit for bit.
- K2/K3 float32: dQ (at valid rows), dK, dV within 5e-3 (masg_tpu's flash-
  gradient bar; sums in another order give ~1e-6); bfloat16: atol = rtol =
  1e-2 (both sides round float32 sums to bfloat16, one ulp at |grad| up to
  4; the kernels also round p and ds to bfloat16 as the operands of the
  tensor-core products, 2^-9 relative per term, which
  tests/test_torch_port_flash_bwd.py holds to the same bar on the CPU); dK
  and dV exactly 0 at keys >= len; no NaN.
- main path float32: duration_rounded and mel_len identical, postnet_mel
  within 2e-4 (masg_tpu's flash-vs-XLA model bar), int16 wavs within 2 LSB.
- train step float32: losses within 1e-5 relative, every gradient within
  2e-3 (masg_tpu's model-gradient-with-flash bar), BatchNorm statistics
  within 1e-5; 20 bf16-autocast steps within 25 % of float32's last loss
  (tests/test_train_step.py); resumed losses within 1e-5 relative.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# SIMT f32; dense bf16 tensor cores; f32 work as 3 TF32 products (495 / 3)
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float32_3xtf32": 495e12 / 3}
SAMPLE_RATE, HOP = 22050, 256
B, L, T_MEL, H, DH = 16, 128, 640, 2, 128
DEVICE = "cuda"


def example_inputs(B=2, L=64, T=256, n_speakers=16, meta_dim=4, seed=0):
    """Numpy copy of `__graft_entry__._example_inputs` (the repo's headline batch)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    texts = rng.integers(1, 100, size=(B, L)).astype(np.int32)
    src_lens = np.full(B, L, np.int32)
    src_lens[1::2] = L - 5
    for i in range(B):
        texts[i, src_lens[i]:] = 0
    accents = rng.integers(0, 5, size=(B, L)).astype(np.int32)
    durations = np.maximum(rng.integers(0, 2 * T // L, size=(B, L)), 0).astype(np.int32)
    for i in range(B):
        durations[i, src_lens[i]:] = 0
        # clamp total durations into the T frame budget
        while durations[i].sum() > T:
            durations[i] = np.maximum(durations[i] - 1, 0)
    mel_lens = durations.sum(1).astype(np.int32)
    mels = rng.normal(size=(B, T, 80)).astype(np.float32)
    pitches = rng.normal(size=(B, L)).astype(np.float32)
    energies = rng.normal(size=(B, L)).astype(np.float32)
    speakers = (np.arange(B) % n_speakers).astype(np.int32)
    meta = np.zeros((B, meta_dim), np.float32)
    meta[:, rng.integers(0, 2)] = 1.0
    meta[:, 2 + rng.integers(0, 2)] = 1.0
    return dict(
        speakers=speakers, texts=texts, src_lens=src_lens, mels=mels,
        mel_lens=mel_lens, pitches=pitches, energies=energies,
        durations=durations, accents=accents, speaker_meta=meta,
    )


def cuda_ms(fn, iters, warmup=1):
    """Mean device time of fn() in ms, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters, match=None):
    """Mean device time of fn() in ms, from a torch.profiler window over
    `iters` calls after one warm-up: the summed durations of the device
    kernels whose name contains `match` (every kernel when None), so the
    host's time between launches is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and (match is None or match in e.name)]
    assert kern, f"the profiler saw no device kernel matching {match!r}"
    return sum(e.time_range.end - e.time_range.start for e in kern) / iters / 1e3


def bound(ops, nbytes, dtype_name):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and ops / peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(lengths, t, elem_bytes):
    """Operations and bytes one K1 call needs for these key lengths: every
    query row against its valid keys (q.k and p.v, 2 flops a MAC); q read,
    valid k/v rows read, o and the f32 LSE written."""
    valid = [min(int(n), t) for n in lengths]
    ops = sum(4 * H * t * n * DH for n in valid)
    nbytes = (len(valid) * H * t * DH * elem_bytes * 2  # q read, o written
              + sum(2 * H * n * DH * elem_bytes for n in valid)  # k, v rows read
              + len(valid) * H * t * 4 + len(valid) * 4)  # LSE written, lengths read
    return ops, nbytes


def mrf_work(b, t, c, kernel_sizes, n_dil, elem_bytes):
    """Operations and bytes of one K4 call: 2 convs per dilation unit, k taps
    of a C x C product per row each; x read, out written, weights read once."""
    taps = sum(2 * n_dil * k for k in kernel_sizes)
    ops = 2 * b * t * c * c * taps
    nbytes = 2 * b * t * c * elem_bytes + (taps * c * c + 2 * n_dil * len(kernel_sizes) * c) * 4
    return ops, nbytes


def header():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"device 0 = {torch.cuda.get_device_name(0)}")
    return smi


def build_kernels():
    from masg_tpu_torch.ops import _build

    t0 = time.time()
    paths = _build.build()
    print(f"[build] {len(_build.KERNELS)} kernel libraries built in {time.time() - t0:.1f} s")
    report = {}
    for name, log in _build.PTXAS_LOG.items():
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "smem" in line):
                print(f"[build] {name}: {line.strip()}")
        report.update(ptxas_report(log))
    # the f32 K1 and K3 must not spill at the main path's Dh, the f32 K2 at
    # any Dh or tile, the f32 K4 at either width
    f32_entries = ["flash_fwd_kernel<128,2>", "flash_fwd_kernel<128,4>", "flash_dkv_kernel<128>",
                   *(f"flash_dq_kernel<{dh},{ri}>" for dh in (16, 32, 64, 128) for ri in (2, 4)),
                   "mrf_kernel<32>", "mrf_kernel<64>"]
    for entry in f32_entries:
        regs, spill = report[entry]
        print(f"[build] {entry}: {regs} registers, {spill} spill bytes (stores + loads)")
        assert spill == 0, (entry, spill)
    sass_mma_counts(_build.nvcc_path(), dict(zip(_build.KERNELS, paths)))


def ptxas_report(log):
    """{kernel<template ints>: (registers, spill store + load bytes)} from a
    `-Xptxas -v` log."""
    import re

    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = f"{_kernel_name(m.group(1))}<{_template_int(m.group(1))}>"
            spill = 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), spill)
            entry = None
    return out


def _kernel_name(mangled):
    """The kernel's identifier in an Itanium-mangled name: a length-prefixed
    identifier that starts with flash_ or mrf_ and ends with kernel (the
    digits before it may also end a hash, so every suffix is tried)."""
    import re

    for m in re.finditer(r"(\d+)((?:flash|mrf)_\w+)", mangled):
        digits, rest = m.groups()
        for i in range(len(digits)):
            n = int(digits[i:])
            if n <= len(rest) and rest[:n].endswith("kernel"):
                return rest[:n]
    return mangled


def _template_int(mangled):
    """The kernel's integer template arguments, comma-separated."""
    import re

    m = re.search(r"kernelI((?:Li\d+E)+)", mangled)
    return ",".join(re.findall(r"Li(\d+)E", m.group(1))) if m else "?"


def sass_mma_counts(nvcc, libs):
    """Count the tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) per
    kernel entry point in each built library's SASS (`cuobjdump -sass`, which
    lies beside nvcc); fail unless every bf16 entry of K1-K4 and every f32
    entry of K4 (3xTF32) has some."""
    import re

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({cuobjdump})")
    counts = {}
    for lib, path in libs.items():
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              check=True).stdout
        entry = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                entry = f"{_kernel_name(m.group(1))}<{_template_int(m.group(1))}>"
                counts[(lib, entry)] = [0, 0]
            elif entry is not None and "HGMMA" in line:
                counts[(lib, entry)][1] += 1
            elif entry is not None and "HMMA" in line:
                counts[(lib, entry)][0] += 1
    for (lib, entry), (hmma, hgmma) in sorted(counts.items()):
        print(f"[build] {lib}: {entry}: {hmma} HMMA, {hgmma} HGMMA")
    for base, want in (("flash_fwd_bf16_kernel", 4), ("flash_dq_bf16_kernel", 4),
                       ("flash_dkv_bf16_kernel", 4), ("mrf_bf16_kernel", 2),
                       ("mrf_kernel", 2)):
        found = [(e, sum(c)) for (_, e), c in counts.items() if e.startswith(base + "<")]
        assert len(found) == want, (base, found)
        assert all(n > 0 for _, n in found), f"no tensor-core instruction in {found}"
    return counts


def check_flash():
    """Phase 3. Returns per-dtype {T: row} with errors and times."""
    import torch

    from masg_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    gen = torch.Generator().manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for t in (128, 640, 1000):
            q, k, v = (torch.randn(B, H, t, DH, generator=gen).to(DEVICE, dtype)
                       for _ in range(3))
            lens = torch.randint(1, t + 1, (B,), generator=gen)
            lens[0], lens[1], lens[2] = 0, 1, t
            lens = lens.to(DEVICE)
            o, lse = flash_attention(q, k, v, lens, return_lse=True)
            torch.cuda.synchronize()
            o_ref, lse_ref = flash_attention_plain(q, k, v, lens)
            empty = torch.isinf(lse_ref)
            assert torch.equal(torch.isinf(lse), empty), "LSE -inf rows differ"
            assert not torch.isnan(o).any(), "NaN in K1 output"
            assert (o[empty.unsqueeze(-1).expand_as(o)] == 0).all(), "empty rows not 0"
            err = (o.float() - o_ref.float()).abs().max().item()
            lse_err = (lse[~empty] - lse_ref[~empty]).abs().max().item()
            if dtype == torch.float32:
                assert err <= 2e-5 and lse_err <= 1e-4, (t, err, lse_err)
            else:
                torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
                assert lse_err <= 1e-4, (t, lse_err)
            row = {"err": err, "lse_err": lse_err, **k1_times(q, k, v, lens, t)}
            row["bound_ms"], row["bound_by"] = bound(
                *flash_work(lens.tolist(), t, q.element_size()), dname)
            out.setdefault(dname, {})[t] = row
            print(f"[K1] {dname} T={t}: max|o err| {err:.3g} max|lse err| {lse_err:.3g} "
                  f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
                  f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms (device "
                  f"{row['library_device_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})")
    return out


def k1_times(q, k, v, lens, t):
    """K1's times at these inputs: CUDA events (kernel, plain version, masked
    SDPA forward: a yardstick the port never calls) and device time from
    profiler windows (kernel, SDPA forward), in ms per call."""
    import torch

    from masg_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    mask = (torch.arange(t, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    return {"ms": cuda_ms(lambda: flash_attention(q, k, v, lens), 20),
            "device_ms": device_ms(lambda: flash_attention(q, k, v, lens), 20, "flash_fwd"),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, lens), 5),
            "library_ms": cuda_ms(sdpa, 20), "library_device_ms": device_ms(sdpa, 20)}


def random_mrf_params(c, kernel_sizes, n_dil, gen, dtype):
    import torch

    blocks = []
    for k in kernel_sizes:
        bp = {}
        for i in range(n_dil):
            for cn in ("convs1", "convs2"):
                bp[f"{cn}_{i}_kernel"] = (torch.randn(k, c, c, generator=gen)
                                          / math.sqrt(c * k)).to(DEVICE, dtype)
                bp[f"{cn}_{i}_bias"] = (0.1 * torch.randn(c, generator=gen)).to(DEVICE, dtype)
        blocks.append(bp)
    return blocks


def check_mrf():
    """Phase 4 at the V1 main-path stage shapes. Returns {dtype: {C: row}}."""
    import torch

    from masg_tpu_torch.ops.fused_mrf import (fused_mrf_stage, fused_mrf_stage_plain,
                                              pack_stage_weights)

    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for c, t in ((64, T_MEL * 128), (32, T_MEL * 256)):
            x = torch.randn(B, t, c, generator=gen).to(DEVICE, dtype)
            bps = random_mrf_params(c, ks, 3, gen, dtype)
            packed = pack_stage_weights(bps, ks, 3, dtype, DEVICE)
            y = fused_mrf_stage(x, bps, ks, ds)
            torch.cuda.synchronize()
            y_ref = fused_mrf_stage_plain(x, bps, ks, ds)
            err = (y.float() - y_ref.float()).abs().max().item()
            tol = 2e-5 if dtype == torch.float32 else 0.125
            assert err <= tol, (dname, c, err, tol)
            # tile position: a run that starts s rows later (s not a multiple
            # of the tile) gives the same bits at every row > 64 past the cut
            s0 = 1000 + 37
            y_cut = fused_mrf_stage(x[:2, s0:].contiguous(), bps, ks, ds)
            same = torch.equal(y_cut[:, 65:], y[:2, s0 + 65:])
            print(f"[K4] {dname} C={c}: run from row {s0} equals the full run bit for bit "
                  f"at rows > 64 past the cut: {same}")
            assert same, (dname, c)
            row = {"err": err,
                   "ms": cuda_ms(lambda: fused_mrf_stage(x, bps, ks, ds, packed), 3),
                   "plain_ms": cuda_ms(lambda: fused_mrf_stage_plain(x, bps, ks, ds), 2),
                   "library_ms": None}
            work = mrf_work(B, t, c, ks, 3, x.element_size())
            row["bound_ms"], row["bound_by"] = bound(
                *work, "float32_3xtf32" if dtype == torch.float32 else dname)
            if dtype == torch.float32:
                row["bound_f32_ms"] = bound(*work, dname)[0]
                rate = f"3xTF32 rate; {row['bound_f32_ms']:.3f} ms at the CUDA cores' f32 rate"
            else:
                rate = "bf16 rate"
            out.setdefault(dname, {})[c] = row
            print(f"[K4] {dname} C={c} T={t}: max err {err:.3g} (max |ref| "
                  f"{y_ref.float().abs().max().item():.3g}), kernel {row['ms']:.3f} ms, "
                  f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']}, {rate})")
    return out


def flagship_config():
    from masg_tpu_torch.core.config import (ExperimentConfig, ModelConfig,
                                            PreprocessConfig, Stats, TrainConfig)

    return ExperimentConfig(preprocess=PreprocessConfig(), model=ModelConfig(),
                            train=TrainConfig(), stats=Stats(),
                            speakers={f"spk{i}": [i, "M", "ja"] for i in range(16)})


def build_path(cfg, dtype, kernels):
    """(FastSpeech2, Vocoder) on the card; `kernels` selects K1/K4 or the plain ops."""
    from masg_tpu_torch.compat.from_jax import with_duration_bias
    from masg_tpu_torch.infer.synthesis import load_model
    from masg_tpu_torch.infer.vocoder import get_vocoder

    model = load_model(cfg, device=DEVICE, use_flash=kernels, seed=0)
    model.load_state_dict(with_duration_bias(model.state_dict(), math.log(5.0)))
    model.to(dtype)
    vocoder = get_vocoder(cfg.model, device=DEVICE, dtype=dtype, fused_mrf=kernels, seed=1)
    return model, vocoder


def text_to_wav(model, vocoder, batch):
    from masg_tpu_torch.infer.synthesis import synthesize_batch
    from masg_tpu_torch.infer.vocoder import vocoder_infer

    out = synthesize_batch(model, batch, max_mel_len=T_MEL)
    wavs = vocoder_infer(out.postnet_mel, vocoder)
    return out, wavs


def _wrappers():
    """The kernel wrappers, K1-K4, each counting its launches."""
    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dq)
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage

    return {"K1": flash_attention, "K2": flash_attention_dq, "K3": flash_attention_dkv,
            "K4": fused_mrf_stage}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    """{kernel: launches since the last reset}."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def main_path(smi):
    """Phase 5. Returns (launches per forward, main-path kernel inputs)."""
    import numpy as np
    import torch

    from masg_tpu_torch.ops.gmm import sample as gmm_sample

    cfg = flagship_config()
    batch = example_inputs(B=B, L=L, T=T_MEL)
    results, paths = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for kernels in (True, False):
            paths[(dname, kernels)] = build_path(cfg, dtype, kernels)

        model, vocoder = paths[(dname, True)]
        n_params = sum(p.numel() for p in model.parameters())
        reset_counts()
        out, wavs = text_to_wav(model, vocoder, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        mel_len = out.mel_len.cpu().numpy()
        print(f"[main] {dname}: FastSpeech2 {n_params / 1e6:.1f}M params, launches "
              f"{counts}, mel_len min/max {mel_len.min()}/"
              f"{mel_len.max()}, wav {len(wavs)} x {wavs[0].shape[0]} samples")
        assert counts == {"K1": 10, "K2": 0, "K3": 0, "K4": 2}, counts
        assert (mel_len > 0).all(), mel_len
        assert torch.isfinite(out.postnet_mel.float()).all()
        wav_f = vocoder(out.postnet_mel)
        assert torch.isfinite(wav_f.float()).all()
        assert wav_f.shape == (B, T_MEL * HOP), wav_f.shape
        results[dname] = {"launches": counts, "src_lens": batch["src_lens"],
                          "mel_len": mel_len, "out": out, "wavs": wavs}

    # float32: kernel path against plain path on the same inputs and weights
    k_out, k_wavs = results["float32"]["out"], results["float32"]["wavs"]
    p_out, p_wavs = text_to_wav(*paths[("float32", False)], batch)
    assert torch.equal(k_out.duration_rounded, p_out.duration_rounded), "durations differ"
    assert torch.equal(k_out.mel_len, p_out.mel_len), "mel_len differs"
    mel_err = (k_out.postnet_mel - p_out.postnet_mel).abs().max().item()
    wav_err = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
                  for a, b in zip(k_wavs, p_wavs))
    print(f"[main] float32 kernel vs plain path: durations and mel_len identical, "
          f"max|postnet_mel err| {mel_err:.3g} (tol 2e-4), max|wav err| {wav_err} LSB "
          f"(tol 2)")
    assert mel_err <= 2e-4 and wav_err <= 2, (mel_err, wav_err)

    # text->wav real-time factor: audio seconds per wall second, bench.py's
    # definition, kernel and plain paths in turns (k, p, p, k, ...); the
    # text->mel part (synthesize_batch) and the vocoder part are timed apart
    from masg_tpu_torch.infer.synthesis import synthesize_batch
    from masg_tpu_torch.infer.vocoder import vocoder_infer

    for dname in ("bfloat16", "float32"):
        frames = int(results[dname]["mel_len"].sum())
        audio_s = frames * HOP / SAMPLE_RATE
        walls = {True: [], False: []}
        for kernels in (True, False):  # warm-up: the bfloat16 plain path has not run yet
            text_to_wav(*paths[(dname, kernels)], batch)
        for kernels in (True, False, False, True, True, False):
            model, vocoder = paths[(dname, kernels)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = synthesize_batch(model, batch, max_mel_len=T_MEL)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vocoder_infer(out.postnet_mel, vocoder)
            torch.cuda.synchronize()
            walls[kernels].append((time.perf_counter() - t0, t1 - t0))
        for kernels in (True, False):
            w = statistics.median(x[0] for x in walls[kernels])
            w_mel = statistics.median(x[1] for x in walls[kernels])
            print(f"[rtf] {dname} {'kernel' if kernels else 'plain'} path: "
                  f"{audio_s / w:.1f}x real time ({audio_s:.1f} s audio in {w * 1e3:.1f} ms "
                  f"median of 3; walls {[round(x[0] * 1e3, 1) for x in walls[kernels]]} ms); "
                  f"text->mel {frames / w_mel:.0f} frames/s ({w_mel * 1e3:.1f} ms), vocoder "
                  f"{(w - w_mel) * 1e3:.1f} ms (medians) on {smi}")

    # speaker generation: prior GMM -> sample -> synthesis from the embedding
    model, vocoder = paths[("float32", True)]
    with torch.inference_mode():
        gmm = model.speaker_distribution(torch.as_tensor(batch["speaker_meta"][:1],
                                                         device=DEVICE))
        emb = gmm_sample(gmm, torch.Generator().manual_seed(0)).cpu().numpy()
    one = {k: v[:1] for k, v in batch.items()}
    out = synthesize_batch(model, one, max_mel_len=T_MEL, speaker_emb=emb)
    assert torch.isfinite(out.postnet_mel).all() and int(out.mel_len[0]) > 0
    print(f"[main] speaker_distribution -> GMM sample -> synthesize_from_speaker_emb: "
          f"mel_len {int(out.mel_len[0])}, finite")
    results["bfloat16"]["path"] = paths[("bfloat16", True)]
    results["batch"] = batch
    return results


def profile_inference(results, smi):
    """Phase: a torch.profiler window over one bf16 kernel-path text->wav
    (`synthesize_batch` -> `vocoder_infer`, after the warm-ups of `[rtf]`):
    the device's busy time and idle share of the window, device ops, K1's and
    K4's device time, and for text->mel and the vocoder apart (each ends in a
    synchronize) the wall time, the device busy time and, in the vocoder, the
    device time outside K4; then the six heaviest device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from masg_tpu_torch.infer.synthesis import synthesize_batch
    from masg_tpu_torch.infer.vocoder import vocoder_infer

    model, vocoder = results["bfloat16"]["path"]
    batch = results["batch"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("masg::text_to_mel"):
            out = synthesize_batch(model, batch, max_mel_len=T_MEL)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_function("masg::vocoder"):
            vocoder_infer(out.postnet_mel, vocoder)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    walls = {"text_to_mel": (t1 - t0) * 1e6, "vocoder": (t2 - t1) * 1e6}
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in evs if not getattr(e, "is_user_annotation", False)]
    assert kern, "the profiler saw no device work on the inference path"
    iv = [(e.time_range.start, e.time_range.end) for e in kern]
    busy = _union_us(iv)
    wall = walls["text_to_mel"] + walls["vocoder"]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    k1 = sum(t for name, t in by_name.items() if "flash_fwd" in name)
    k4 = sum(t for name, t in by_name.items() if "mrf_" in name)
    print(f"[profile] bfloat16 inference, kernel path, one text->wav of B={B}: wall "
          f"{wall / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms ({100 * (1 - busy / wall):.1f} "
          f"% idle), {len(kern)} device ops; K1 {k1 / 1e3:.3f} ms, K4 {k4 / 1e3:.3f} ms "
          f"(device time); on {smi}")
    for part in ("text_to_mel", "vocoder"):
        spans = [(e.time_range.start, e.time_range.end) for e in evs
                 if getattr(e, "is_user_annotation", False) and e.name == f"masg::{part}"]
        inside = [(max(s, a), min(e, b)) for a, b in spans for s, e in iv if s < b and e > a]
        part_busy = _union_us(inside)
        k4_part = sum(e.time_range.end - e.time_range.start for e in kern if "mrf_" in e.name
                      and any(e.time_range.start < b and e.time_range.end > a for a, b in spans))
        extra = (f", of which K4 {k4_part / 1e3:.1f} ms and other device work "
                 f"{(part_busy - k4_part) / 1e3:.1f} ms" if part == "vocoder" else "")
        print(f"[profile]   {part}: wall {walls[part] / 1e3:.1f} ms, device busy "
              f"{part_busy / 1e3:.1f} ms{extra}, host-only {(walls[part] - part_busy) / 1e3:.1f} ms")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
        print(f"[profile]   {t / 1e3:8.3f} ms  {name[:100]}")


def main_path_kernel_times(results, mrf):
    """K1/K4 at the exact inputs the bfloat16 main path gave them: per
    forward, 4 encoder calls (T=L, src lengths) + 6 decoder calls (T=T_mel,
    mel lengths) and the 2 MRF stages; the float32 K4 per forward from the
    `[K4]` phase's rows (`mrf`, the same stage shapes). Returns the
    kernels-line entries."""
    import torch

    from masg_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    from masg_tpu_torch.ops.fused_mrf import (fused_mrf_stage, fused_mrf_stage_plain,
                                              pack_stage_weights)

    gen = torch.Generator().manual_seed(2)
    k1s = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        res = results[dname]
        k1 = {key: 0.0 for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                   "library_device_ms", "err", "ops", "bytes")}
        for t, lens, n_calls in ((L, res["src_lens"], 4), (T_MEL, res["mel_len"], 6)):
            q, k, v = (torch.randn(B, H, t, DH, generator=gen).to(DEVICE, dtype)
                       for _ in range(3))
            lens_t = torch.as_tensor(lens, device=DEVICE)
            o = flash_attention(q, k, v, lens_t)
            o_ref, _ = flash_attention_plain(q, k, v, lens_t)
            err = (o.float() - o_ref.float()).abs().max().item()
            if dtype == torch.float32:
                assert err <= 2e-5, err
            else:
                torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
            k1["err"] = max(k1["err"], err)
            for key, x in k1_times(q, k, v, lens_t, t).items():
                k1[key] += n_calls * x
            ops, nbytes = flash_work(list(lens), t, q.element_size())
            k1["ops"] += n_calls * ops
            k1["bytes"] += n_calls * nbytes
        k1["bound_ms"], k1["bound_by"] = bound(k1["ops"], k1["bytes"], dname)
        k1["launches"] = res["launches"]["K1"]
        k1s[dname] = k1
    dtype, dname = torch.bfloat16, "bfloat16"
    k1, k1_f32 = k1s["bfloat16"], k1s["float32"]

    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    k4 = {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "ops": 0.0, "bytes": 0.0}
    for c, t in ((64, T_MEL * 128), (32, T_MEL * 256)):
        x = torch.randn(B, t, c, generator=gen).to(DEVICE, dtype)
        bps = random_mrf_params(c, ks, 3, gen, dtype)
        packed = pack_stage_weights(bps, ks, 3, dtype, DEVICE)  # as the generator caches it
        y = fused_mrf_stage(x, bps, ks, ds, packed)
        y_ref = fused_mrf_stage_plain(x, bps, ks, ds)
        err = (y.float() - y_ref.float()).abs().max().item()
        assert err <= 0.125, err
        k4["err"] = max(k4["err"], err)
        k4["ms"] += cuda_ms(lambda: fused_mrf_stage(x, bps, ks, ds, packed), 3)
        k4["plain_ms"] += cuda_ms(lambda: fused_mrf_stage_plain(x, bps, ks, ds), 2)
        ops, nbytes = mrf_work(B, t, c, ks, 3, x.element_size())
        k4["ops"] += ops
        k4["bytes"] += nbytes
    k4["bound_ms"], k4["bound_by"] = bound(k4["ops"], k4["bytes"], dname)

    entries = [
        {"name": "flash_attention_fwd (K1)", "route": "cuda",
         "source": "masg_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "masg_tpu/ops/attention.py:62", "launches": k1["launches"],
         "max_abs_err": k1["err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "device_ms": k1["device_ms"],
         "library_device_ms": k1["library_device_ms"],
         "float32_forward": path_fields(k1_f32)},
        {"name": "fused_mrf_stage (K4)", "route": "cuda",
         "source": "masg_tpu_torch/csrc/fused_mrf.cu",
         "replaces": "masg_tpu/ops/fused_mrf.py:82",
         "launches": results["bfloat16"]["launches"]["K4"],
         "max_abs_err": k4["err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None,
         "float32_forward": k4_f32_fields(mrf["float32"],
                                          results["float32"]["launches"]["K4"])},
    ]
    for e in entries:
        print(f"[kernels] {e['name']}: per bfloat16 main-path forward ({e['launches']} "
              f"launches) kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, "
              f"library {e['library_ms']}, bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
    print_path_fields("flash_attention_fwd (K1)", "float32 main-path forward",
                      entries[0]["float32_forward"], "masked SDPA forward")
    f = entries[1]["float32_forward"]
    print(f"[kernels] fused_mrf_stage (K4): per float32 main-path forward ({f['launches']} "
          f"launches) kernel {f['ms']:.3f} ms, plain {f['plain_ms']:.3f} ms, library None, "
          f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}, 3xTF32 rate; "
          f"{f['bound_f32_ms']:.4f} ms at the f32 rate), max abs err {f['max_abs_err']:.3g}")
    return entries


def k4_f32_fields(rows, launches):
    """The float32 K4's figures per forward: the sum of the `[K4]` rows of
    the forward's two stages (C = 64 and 32)."""
    f = {key: sum(r[key] for r in rows.values())
         for key in ("ms", "plain_ms", "bound_ms", "bound_f32_ms")}
    return f | {"launches": launches, "library_ms": None,
                "bound_by": next(iter(rows.values()))["bound_by"],
                "max_abs_err": max(r["err"] for r in rows.values())}


def path_fields(acc):
    """A kernel's per-path figures as a kernels-line field."""
    return {key: acc[key] for key in ("launches", "ms", "device_ms", "plain_ms",
                                      "library_ms", "library_device_ms", "bound_ms",
                                      "bound_by")} | {"max_abs_err": acc["err"]}


def print_path_fields(name, path, f, library):
    print(f"[kernels] {name}: per {path} ({f['launches']} launches) kernel {f['ms']:.3f} ms "
          f"(device {f['device_ms']:.3f} ms), plain {f['plain_ms']:.3f} ms, library "
          f"({library}) {f['library_ms']:.3f} ms (device {f['library_device_ms']:.3f} ms), "
          f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}), max abs err "
          f"{f['max_abs_err']:.3g}")


def flash_bwd_work(lengths, t, elem_bytes):
    """((ops, bytes) of K2, (ops, bytes) of K3) for one call at these key
    lengths. Per (b, h) with n = len: 3 (K2: s, dp, ds.k) and 4 (K3: s, dp,
    p^T.do, ds^T.q) products of 2 n^2 Dh flops. K2 reads q, do, LSE and delta
    at every row and k, v at the valid rows, and writes dq; K3 reads all six
    at the valid rows and writes dk, dv at every row."""
    valid = [min(int(n), t) for n in lengths]
    nb, row = len(valid), DH * elem_bytes
    sq = sum(n * n for n in valid)
    kv = sum(2 * H * n * row for n in valid) + nb * 4  # valid k, v rows; lengths
    k2 = (3 * 2 * H * sq * DH, nb * H * t * (3 * row + 8) + kv)
    k3 = (4 * 2 * H * sq * DH, sum(H * n * (2 * row + 8) for n in valid) + kv
          + nb * H * t * 2 * row)
    return k2, k3


def bwd_inputs(t, dtype, lens, gen):
    """q, k, v, do (zero at query rows >= len), K1's lse, delta, and the
    (B, 1, T, 1) valid-row mask."""
    import torch

    from masg_tpu_torch.ops.attention import flash_attention

    q, k, v = (torch.randn(B, H, t, DH, generator=gen).to(DEVICE, dtype) for _ in range(3))
    valid = (torch.arange(t, device=DEVICE)[None, :] < lens[:, None])[:, None, :, None]
    do = (torch.randn(B, H, t, DH, generator=gen).to(DEVICE) * valid).to(dtype)
    o, lse = flash_attention(q, k, v, lens, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta, valid


def sdpa_bwd_ms(q, k, v, do, lens, t):
    """The library yardstick of K2 + K3 (the port never calls it): the
    backward of masked scaled_dot_product_attention, as (CUDA events: forward
    plus torch.autograd.grad minus the forward alone; device time of the
    backward alone, from a profiler window of torch.autograd.grad calls on
    one retained forward)."""
    import torch

    mask = (torch.arange(t, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, kr, vr), do)

    out = fwd()
    dev = device_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True), 10)
    return cuda_ms(fwd_bwd, 10) - cuda_ms(fwd, 10), dev


def bwd_errors(q, k, v, do, lse, delta, lens, valid, dtype):
    """K2 and K3 against their plain versions: (dq err at valid rows, dk err,
    dv err); asserts exact zeros of dk/dv past the length, no NaN, and the bar."""
    import torch

    from masg_tpu_torch.ops.attention import (flash_attention_dkv, flash_attention_dkv_plain,
                                              flash_attention_dq, flash_attention_dq_plain)

    dq = flash_attention_dq(q, k, v, do, lse, delta, lens)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, lens)
    torch.cuda.synchronize()
    dq_ref = flash_attention_dq_plain(q, k, v, do, lse, delta, lens)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, lse, delta, lens)
    for g in (dq, dk, dv):
        assert not torch.isnan(g).any(), "NaN in a K2/K3 output"
    for g in (dk, dv):
        assert (g * ~valid == 0).all(), "dK/dV not exactly 0 at keys >= len"
    errs = ((dq.float() - dq_ref.float()) * valid).abs().max().item(), \
        (dk.float() - dk_ref.float()).abs().max().item(), \
        (dv.float() - dv_ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert max(errs) <= 5e-3, errs
    else:
        for got, want in ((dq * valid, dq_ref * valid), (dk, dk_ref), (dv, dv_ref)):
            torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    return errs


def check_flash_bwd():
    """Phase: K2/K3 against their plain versions at B=16, H=2, Dh=128."""
    import torch

    from masg_tpu_torch.ops.attention import (flash_attention_dkv, flash_attention_dkv_plain,
                                              flash_attention_dq, flash_attention_dq_plain)

    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for t in (128, 640, 1000):
            lens = torch.randint(1, t + 1, (B,), generator=gen)
            lens[0], lens[1], lens[2] = 0, 1, t
            lens = lens.to(DEVICE)
            args = bwd_inputs(t, dtype, lens, gen)
            q, k, v, do, lse, delta, valid = args
            errs = bwd_errors(*args[:6], lens, valid, dtype)
            a = (q, k, v, do, lse, delta, lens)
            same = torch.equal(flash_attention_dq(*a), flash_attention_dq(*a))
            print(f"[K2/K3] {dname} T={t}: two launches of K2 give the same bits: {same}")
            assert same, (dname, t)
            ms = (cuda_ms(lambda: flash_attention_dq(*a), 10),
                  cuda_ms(lambda: flash_attention_dkv(*a), 10))
            dev = (device_ms(lambda: flash_attention_dq(*a), 20, "flash_dq"),
                   device_ms(lambda: flash_attention_dkv(*a), 20, "flash_dkv"))
            plain = (cuda_ms(lambda: flash_attention_dq_plain(*a), 3),
                     cuda_ms(lambda: flash_attention_dkv_plain(*a), 3))
            lib, lib_dev = sdpa_bwd_ms(q, k, v, do, lens, t)
            bounds = [bound(*w, dname) for w in flash_bwd_work(lens.tolist(), t,
                                                               q.element_size())]
            print(f"[K2/K3] {dname} T={t}: max err dQ {errs[0]:.3g} dK {errs[1]:.3g} "
                  f"dV {errs[2]:.3g}, dK/dV exactly 0 past len; K2 {ms[0]:.4f} ms "
                  f"(device {dev[0]:.4f}, plain {plain[0]:.4f}, bound {bounds[0][0]:.4f} "
                  f"{bounds[0][1]}), K3 {ms[1]:.4f} ms (device {dev[1]:.4f}, plain "
                  f"{plain[1]:.4f}, bound {bounds[1][0]:.4f} {bounds[1][1]}), sdpa backward "
                  f"{lib:.4f} ms (device {lib_dev:.4f})")


def train_state(cfg, use_flash, seed=0):
    """A fresh train state on the card, weights from `seed` (the same for
    both paths: `use_flash` changes no parameter)."""
    import torch

    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.train.state import create_train_state

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FastSpeech2.from_config(cfg, use_flash=use_flash)
    model.to(DEVICE)
    return create_train_state(model, cfg.train.optimizer, cfg.model.transformer.encoder_hidden)


def train_path(smi):
    """Phase: the plain train step at full width (B=16, L=128, T_mel=640)."""
    import copy

    import torch

    from masg_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = flagship_config()
    batch = example_inputs(B=B, L=L, T=T_MEL)
    db = batch_to_device(batch, DEVICE, torch.float32)

    # f32, dropout off: one step's loss, gradients and BatchNorm statistics,
    # kernel path against plain path from the same weights on the same batch
    sides = []
    for kernels in (True, False):
        st = train_state(cfg, kernels)
        for m in st.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        total, losses, eloss, _ = make_train_step(st.model).loss_fn(st.model, db)
        total.backward()
        sides.append((st.model, [float(x.detach()) for x in (total, *losses, eloss)]))
    (mk, lk), (mp, lp) = sides
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lk, lp))
    grad_err = max((a.grad - b.grad).abs().max().item()
                   for a, b in zip(mk.parameters(), mp.parameters()))
    bk, bp = mk.state_dict(), mp.state_dict()
    bn_err = max((bk[n] - bp[n]).abs().max().item() for n in bk if "running_" in n)
    print(f"[train] float32 kernel vs plain path, dropout off: max relative loss err "
          f"{loss_err:.3g} (tol 1e-5), max|grad err| {grad_err:.3g} over "
          f"{sum(1 for _ in mk.parameters())} tensors (tol 2e-3), max|BatchNorm "
          f"statistics err| {bn_err:.3g} (tol 1e-5)")
    assert loss_err <= 1e-5 and grad_err <= 2e-3 and bn_err <= 1e-5, (loss_err, grad_err,
                                                                       bn_err)
    del sides, mk, mp

    # the main path: train steps through the entry points, counts per step
    paths = {}
    for dname, ac in (("float32", None), ("bfloat16", torch.bfloat16)):
        for kernels in (True, False):
            st = train_state(cfg, kernels)
            paths[(dname, kernels)] = (st, make_train_step(st.model, autocast_dtype=ac))
    counts = {}
    for dname in ("float32", "bfloat16"):
        st, step = paths[(dname, True)]
        reset_counts()
        st, m = step(st, db, 0)
        torch.cuda.synchronize()
        counts[dname] = read_counts()
        assert counts[dname] == {"K1": 10, "K2": 10, "K3": 10, "K4": 0}, counts
        assert torch.isfinite(m.total) and torch.isfinite(m.grad_norm)
    print(f"[train] launches per train step (float32 and bfloat16): {counts['float32']}")

    # steps/s: median of 10 timed steps after 2 warm-ups (bench.py's
    # train_steps_per_s), kernel and plain paths in turns, dropout on
    rates = {}
    for dname in ("float32", "bfloat16"):
        walls = {True: [], False: []}
        for kernels in (True, False):
            st, step = paths[(dname, kernels)]
            for i in range(2):
                step(st, db, i)
        for r in range(10):
            for kernels in ((True, False) if r % 2 == 0 else (False, True)):
                st, step = paths[(dname, kernels)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(st, db, 10 + r)
                torch.cuda.synchronize()
                walls[kernels].append(time.perf_counter() - t0)
        for kernels in (True, False):
            w = statistics.median(walls[kernels])
            rates[(dname, kernels)] = 1.0 / w
            print(f"[train] {dname} {'kernel' if kernels else 'plain'} path: "
                  f"{1.0 / w:.2f} steps/s ({w * 1e3:.1f} ms median of 10; walls "
                  f"{[round(x * 1e3, 1) for x in walls[kernels]]} ms) on {smi}")
    del paths

    # bf16 autocast: 20 steps on one batch stay finite and track float32
    cfg20 = copy.deepcopy(cfg)
    cfg20.train.optimizer.warm_up_step = 400
    last = {}
    for dname, ac in (("float32", None), ("bfloat16", torch.bfloat16)):
        st = train_state(cfg20, True)
        step = make_train_step(st.model, autocast_dtype=ac)
        for i in range(20):
            st, m = step(st, db, i)
            assert torch.isfinite(m.total), (dname, i)
        last[dname] = float(m.total)
        del st
    rel = abs(last["bfloat16"] - last["float32"]) / abs(last["float32"])
    print(f"[train] 20 steps on one batch: last loss float32 {last['float32']:.4f}, "
          f"bfloat16 autocast {last['bfloat16']:.4f} (relative gap {rel:.3g}, tol 0.25)")
    assert rel < 0.25, last
    return {"batch": batch, "counts": counts, "rates": rates}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def profile_train_step(train, smi):
    """Phase: a torch.profiler window of 3 kernel-path train steps (after 2
    warm-ups) per dtype: the device's busy and idle share of the window's wall
    time, device ops per step, K1's, K2's and K3's device time (by kernel
    name), the device time inside the
    optimizer step, and the heaviest device kernels. Then 5 unprofiled steps
    of the same state: the idle share of their median step, taking the busy
    time the profiler saw as the device time of a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masg_tpu_torch.train.step import batch_to_device, make_train_step

    n = 3
    db = batch_to_device(train["batch"], DEVICE, torch.float32)
    for dname, ac in (("float32", None), ("bfloat16", torch.bfloat16)):
        st = train_state(flagship_config(), True)
        step = make_train_step(st.model, autocast_dtype=ac)
        for i in range(2):
            step(st, db, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(st, db, 2 + i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in evs if not getattr(e, "is_user_annotation", False)]
        assert kern, f"{dname}: the profiler saw no device work"
        iv = [(e.time_range.start, e.time_range.end) for e in kern]
        busy = _union_us(iv)
        opt = [(e.time_range.start, e.time_range.end) for e in evs
               if getattr(e, "is_user_annotation", False) and e.name.startswith("Optimizer.step")]
        opt_busy = sum(_union_us([(max(s, a), min(e, b)) for s, e in iv if s < b and e > a])
                       for a, b in opt)
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
        flash = {kn: sum(t for name, t in by_name.items() if match in name) / n / 1e3
                 for kn, match in (("K1", "flash_fwd"), ("K2", "flash_dq"),
                                   ("K3", "flash_dkv"))}
        print(f"[profile] {dname} kernel path: wall {wall_us / n / 1e3:.1f} ms/step, device "
              f"busy {busy / n / 1e3:.1f} ms/step ({100 * (1 - busy / wall_us):.1f} % idle), "
              f"{len(kern) // n} device ops/step; K1 {flash['K1']:.3f}, K2 {flash['K2']:.3f}, "
              f"K3 {flash['K3']:.3f} ms/step; "
              f"optimizer step {opt_busy / n / 1e3:.2f} ms/step busy within "
              f"{sum(b - a for a, b in opt) / n / 1e3:.2f} ms/step; on {smi}")
        for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
            print(f"[profile]   {t / n / 1e3:8.3f} ms/step  {name[:100]}")
        walls = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, db, 2 + n + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6)
        w = statistics.median(walls)
        print(f"[profile] {dname} kernel path unprofiled: median step {w / 1e3:.1f} ms of 5 "
              f"(walls {[round(x / 1e3, 1) for x in walls]} ms); with the profiled busy "
              f"{busy / n / 1e3:.1f} ms/step, {100 * (1 - busy / n / w):.1f} % idle; on {smi}")
        del st


def _total_losses(cfg_dir):
    from masg_tpu_torch.core.config import load_config_dir

    cfg = load_config_dir(cfg_dir)
    with open(os.path.join(cfg.train.path.log_path, "train", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == "Loss/total_loss"]


def trainer_path():
    """Phase: `cli.train` on a random 32-utterance corpus at the flagship
    width, 4 steps, then a run resumed at step 2; then `cli.evaluate`."""
    import shutil
    import tempfile

    import torch

    from masg_tpu_torch.cli.evaluate import main as evaluate_main
    from masg_tpu_torch.cli.train import main as train_main
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        pre = write_preprocessed_corpus(os.path.join(root, "pre"), n_utts=32, n_speakers=4,
                                        n_val=4, phones=(48, 120), frames_per_phone=(1, 5))
        cfg_dir = write_config_dir(os.path.join(root, "cfg"), pre, os.path.join(root, "out"),
                                   step={"save_step": 2, "val_step": 4})
        reset_counts()
        state = train_main(["-c", cfg_dir, "--max_steps", "4"])
        torch.cuda.synchronize()
        counts = read_counts()
        assert state.step == 4 and counts["K4"] == 0 and min(
            counts[k] for k in ("K1", "K2", "K3")) > 0, counts
        first = dict(_total_losses(cfg_dir))
        train_main(["-c", cfg_dir, "--restore_step", "2", "--max_steps", "2"])
        second = _total_losses(cfg_dir)[4:]
        assert [s for s, _ in second] == [3, 4], second
        errs = [abs(v - first[s]) / abs(first[s]) for s, v in second]
        print(f"[trainer] cli.train: 4 steps (launches {counts}), resumed at step 2: "
              f"step 3/4 losses {[round(first[3], 6), round(first[4], 6)]} vs "
              f"{[round(v, 6) for _, v in second]}, max relative err {max(errs):.3g} "
              f"(tol 1e-5)")
        assert max(errs) <= 1e-5, errs
        means = evaluate_main(["-c", cfg_dir, "--restore_step", "4"])
        assert len(means) == 6 and all(math.isfinite(x) for x in means), means
        print(f"[trainer] cli.evaluate on step 4: total loss {means[0]:.4f}")
    finally:
        shutil.rmtree(root)


def train_kernel_times(train, smi):
    """K1-K3 at the exact inputs the train step gave them: per step, 4
    encoder calls (T=L, src lengths) + 6 decoder calls (T=T_mel, mel lengths),
    in float32 and bfloat16; prints their share of a step. Returns the
    kernels-line entries of K2 and K3 (bfloat16, with their device time per
    step beside the CUDA-event time) and the fields of K1, K2 and K3 per
    float32 step."""
    import torch

    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dkv_plain, flash_attention_dq,
                                              flash_attention_dq_plain, flash_attention_plain)

    gen = torch.Generator().manual_seed(4)
    batch = train["batch"]
    per_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        acc = {n: {key: 0.0 for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                         "library_device_ms", "err", "ops", "bytes")}
               for n in ("K1", "K2", "K3")}
        for t, lens, n_calls in ((L, batch["src_lens"], 4), (T_MEL, batch["mel_lens"], 6)):
            lens_t = torch.as_tensor(lens, device=DEVICE)
            args = bwd_inputs(t, dtype, lens_t, gen)
            q, k, v, do, lse, delta, valid = args
            errs = bwd_errors(*args[:6], lens_t, valid, dtype)
            a = (q, k, v, do, lse, delta, lens_t)
            o_ref, _ = flash_attention_plain(q, k, v, lens_t)
            err = (flash_attention(q, k, v, lens_t).float() - o_ref.float()).abs().max().item()
            assert dtype != torch.float32 or err <= 2e-5, err
            acc["K1"]["err"] = max(acc["K1"]["err"], err)
            for key, x in k1_times(q, k, v, lens_t, t).items():
                acc["K1"][key] += n_calls * x
            for name, fn, plain, err, match in (
                    ("K2", flash_attention_dq, flash_attention_dq_plain, errs[0], "flash_dq"),
                    ("K3", flash_attention_dkv, flash_attention_dkv_plain, max(errs[1:]),
                     "flash_dkv")):
                e = acc[name]
                e["err"] = max(e["err"], err)
                e["ms"] += n_calls * cuda_ms(lambda: fn(*a), 10)
                e["device_ms"] += n_calls * device_ms(lambda: fn(*a), 20, match)
                e["plain_ms"] += n_calls * cuda_ms(lambda: plain(*a), 3)
            # one backward of masked SDPA computes dQ, dK and dV: K2 + K3 together
            lib, lib_dev = sdpa_bwd_ms(q, k, v, do, lens_t, t)
            for name in ("K2", "K3"):
                acc[name]["library_ms"] += n_calls * lib
                acc[name]["library_device_ms"] += n_calls * lib_dev
            works = (flash_work(list(lens), t, q.element_size()),
                     *flash_bwd_work(list(lens), t, q.element_size()))
            for name, (ops, nbytes) in zip(("K1", "K2", "K3"), works):
                acc[name]["ops"] += n_calls * ops
                acc[name]["bytes"] += n_calls * nbytes
        for name, e in acc.items():
            e["bound_ms"], e["bound_by"] = bound(e["ops"], e["bytes"], dname)
            e["launches"] = train["counts"][dname][name]
        per_dtype[dname] = acc
        step_ms = 1e3 / train["rates"][(dname, True)]
        total = sum(acc[n]["ms"] for n in ("K1", "K2", "K3"))
        dev = {n: acc[n]["device_ms"] for n in ("K1", "K2", "K3")}
        print(f"[train] {dname} kernel path: K1 {acc['K1']['ms']:.3f} + K2 "
              f"{acc['K2']['ms']:.3f} + K3 {acc['K3']['ms']:.3f} = {total:.3f} ms per step "
              f"(CUDA events), {100 * total / step_ms:.1f} % of the {step_ms:.1f} ms step; "
              f"device time K1 {dev['K1']:.3f} + K2 {dev['K2']:.3f} + K3 {dev['K3']:.3f} = "
              f"{sum(dev.values()):.3f} ms per step against the sdpa forward's "
              f"{acc['K1']['library_device_ms']:.3f} + backward's "
              f"{acc['K2']['library_device_ms']:.3f} ms; sdpa backward by events "
              f"{acc['K2']['library_ms']:.3f} ms; on {smi}")
    bf, f32 = per_dtype["bfloat16"], per_dtype["float32"]
    entries = []
    for name, fname, line in (("K2", "flash_attention_dq (K2)", 171),
                              ("K3", "flash_attention_dkv (K3)", 216)):
        e = bf[name]
        entries.append({
            "name": fname, "route": "cuda", "source": "masg_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"masg_tpu/ops/attention.py:{line}",
            "launches": e["launches"], "max_abs_err": e["err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"], "device_ms": e["device_ms"],
            "library_device_ms": e["library_device_ms"],
            "float32_train_step": path_fields(f32[name])})
    for e in entries:
        print(f"[kernels] {e['name']}: per bfloat16 train step ({e['launches']} launches) "
              f"kernel {e['ms']:.3f} ms (device {e['device_ms']:.3f} ms), plain "
              f"{e['plain_ms']:.3f} ms, library (sdpa backward, K2 + K3) "
              f"{e['library_ms']:.3f} ms (device {e['library_device_ms']:.3f} ms), bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    k1_train = path_fields(f32["K1"])
    print_path_fields("flash_attention_fwd (K1)", "float32 train step", k1_train,
                      "masked SDPA forward")
    for e in entries:
        print_path_fields(e["name"], "float32 train step", e["float32_train_step"],
                          "masked SDPA backward, K2 + K3")
    return entries, k1_train


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import masg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the masg_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    smi = header()
    build_kernels()
    check_flash()
    mrf = check_mrf()
    check_flash_bwd()
    results = main_path(smi)
    profile_inference(results, smi)
    entries = main_path_kernel_times(results, mrf)
    train = train_path(smi)
    profile_train_step(train, smi)
    trainer_path()
    train_entries, k1_train = train_kernel_times(train, smi)
    entries[0]["float32_train_step"] = k1_train
    entries[1:1] = train_entries
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
