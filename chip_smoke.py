#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`masg_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. header: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the three CUDA kernel libraries from `masg_tpu_torch/csrc/` with nvcc
   (sm_90a), all at once, print ptxas' register / shared-memory / spill report
   (0 spill bytes required of the f32 K1 and K3 at Dh = 128, of every f32 K2
   entry (Dh 16/32/64/128, 32- and 64-row tiles), of the f32 K4 (C = 8, 16,
   32, 64) and of the bf16 K4 at C = 8 and 16), and count the tensor-core
   instructions (HMMA, HGMMA) of every kernel entry point in the SASS
   (`cuobjdump -sass`): every bf16 entry of K1, K2, K3 (one per Dh in
   16/32/64/128) and K4 (C = 8, 16, 32, 64), and the 3xTF32 f32 K4 (C = 8,
   16, 32, 64), must have some;
3. K1 (flash-attention forward) against its plain PyTorch version:
   B=16, H=2, Dh=128, T in {128, 640, 1000}, ragged lengths including 0 and
   1, float32 and bfloat16; times of the kernel, the plain version, masked
   `scaled_dot_product_attention` (a yardstick the port never calls) and the
   least time the card could take (bound), the kernel's and SDPA's also as
   device time from a torch.profiler window;
4. K4 (fused MRF stage) against its plain version at the HiFi-GAN V1 stage
   shapes of the main path (C=64 at T=81920, C=32 at T=163840, B=16), at
   V2's narrow stages (C=16 at T=81920, C=8 at T=163840, kernels 3/7/11) and
   at C=16 with the demo vocoder's two resblocks (kernels 3/7), each with a
   run that starts 1037 rows later, which must give the same bits at every
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
7. the serving path ([serve]): the same flagship weights in float32 behind
   `ServingEngine` (text buckets 16/32/64/128, 12 frames per phone, mel caps
   256/384/768/1000) + `DynamicBatcher` (max batch 8, 5 ms window, queue cap
   64) + `cli.serve.make_server` on an ephemeral port: the warm-up of the
   (1, 2, 4, 8) x 4 buckets, GET /health, 32 POST /synthesize from 16 client
   threads (every answer 200 and a RIFF wav, fewer dispatches than requests,
   K1 and K4 launched exactly 10 and 2 times per dispatch), the kernel engine
   against a plain-path engine (one request per bucket) and 8 batched
   requests against their single runs, one POST /synthesize_streaming at
   bucket 128 against the one-shot vocode of its trimmed mel (and the
   measured receptive field), a barycenter voice from `cli.build_distribution`
   served as speaker_emb, a bfloat16 engine; B=1 latency per bucket, req/s
   and p50/p99 latency under the 16 clients, first-audio time, and K1's and
   K4's device time per B=1 request at bucket 128;
8. the train path: the plain FastSpeech2 train step (`train.step`) at the
   flagship width and B=16, L=128, T_mel=640: float32 kernel vs plain path
   (loss, every gradient, BatchNorm statistics; dropout off), launch counts
   per step, steps/s in float32 and bf16 autocast on both paths, and 20
   bf16-autocast steps against float32;
9. a torch.profiler window over 3 kernel-path train steps per dtype: the
   device's idle share, K1's, K2's, K3's and the optimizer's device time;
   `--param_storage bf16|bf16_moments` (bf16 parameters, f32 master, no
   autocast): one step per mode with 10 launches each of K1-K3, all their
   bf16 instantiations (kernel names in a profiler window), the dtypes of
   parameters, master and moments, finite losses, steps/s;
10. the trainer: `cli.train` on a random 32-utterance corpus at the flagship
   width, 4 steps, a run resumed at step 2 that must repeat steps 3 and 4,
   and `cli.evaluate` on the saved step; then [dump_mels]: `cli.dump_mels`
   on its step 4 (train.txt and val.txt, batches of 16): exactly 10 K1
   launches per batch and none of K2-K4, every mel within 2e-4 of the same
   dump on the plain path with identical lengths, K1's device time per
   batch; and [vocoder_finetune]: `cli.train_vocoder --mel_dir` on those
   mels and a sine-plus-noise wav per utterance, universal V1, segment
   8192, batch 16, 4 steps from a seeded V1 generator, a run restored at
   step 2 that must repeat steps 3-4 within 1e-5 relative, and the exported
   `generator_4.pth.tar` through `get_vocoder` with K4 (2 launches) against
   the plain MRF within 2 LSB;
11. [ge2e]: the GE2E trainer at masg_tpu's default width (SpeechEmbedder
   80 -> 3 x 256 -> 64, N = 32 speakers x M = 10 chunks x 150 frames) on
   chunk archives that `build_ge2e_corpus` writes from 32 synthetic
   speakers' wavs: 3 steps on the card against the same 3 on the CPU, ms
   per step, one DA-subroutine epoch and one `evaluate_eer`;
12. [adversarial]: the `--use_clf` step (clf_featurization model and ge2e)
   and the ganlike step at the flagship width and [train]'s batch at 749
   frames that every row fills (rows of both languages, an injected speaker
   shuffle and label jitter), with a GE2E discriminator of [ge2e]'s width as
   the port builds it: kernel vs plain path (losses with
   dloss, every gradient of FastSpeech2 and, in ganlike, of the
   discriminator, BatchNorm statistics; dropout off; the gradient of dloss
   alone against the plain path in float32 and float64), exactly 20 launches
   each of K1, K2 and K3 per step, ms per step on both paths, K1-K3's device
   time per `--use_clf` step; then `cli.train_speech_embedder` (2 epochs),
   `cli.train --use_clf` with its checkpoint and `cli.train_ganlike` (2
   steps each, 40 launches each of K1-K3) on the card;
13. [vocoder_train]: the HiFi-GAN GAN step (`train.vocoder`) at the
   universal V1 width, B = 16 x 8192 samples, f32: 2 warm-ups and 10 timed
   steps (ms per step, steps/s), finite losses, no K4 launch, peak memory,
   a profiler window of 2 steps (idle share, heaviest device ops); 3 steps
   at masg_tpu's tests' tiny width on the card and on the CPU; K4 on a
   tensor that requires grad raises;
14. [preprocess]: `cli.preprocess` on a `make_synthetic_corpus` raw corpus
   (2 speakers x 4 utterances) on the card and with `--device cpu`; then its
   speed on 4 speakers x 48 utterances of ~4 s, each device's ms per
   utterance split into reads, host F0, features, writes and normalization,
   and the card's features at new against repeated frame counts;
15. [jdit]: the `use_jdit` train step (FastSpeech2 at the flagship width +
   the JDIT teacher at the reference dims: two 1024-wide LSTM cells,
   prenet 256, attention 128, location 32 x 31) on [train]'s batch, f32:
   kernel vs plain path with dropout off (losses with the teacher's MSE,
   every gradient, the teacher's included), exactly 10 launches each of
   K1-K3 per step, ms per step on both paths (medians of 4, in turns), a
   profiler window over one step (device ops, idle share, K1-K3 device
   time, heaviest ops) and its peak memory; the tiny width card vs CPU
   after 3 steps; `cli.make_config JSUT --use_jdit` pointed at a synthetic
   corpus, `cli.train` (2 steps, 20 launches each of K1-K3) and
   `cli.evaluate` twice (the same losses) on the card;
16. [melgan]: text->wav at B=16 through the default MelGAN (seeded random
   weights) behind the f32 flagship FastSpeech2: K1 exactly 10 and K4 0
   launches per forward, kernel vs plain path (mel_len identical, wav
   within 2 LSB), RTF and vocoder ms (medians of 3, in turns),
   `vocode_streaming` of one utterance against its one-shot vocode, one
   `ServingEngine` dispatch with the MelGAN vocoder (K1 10, K4 0);
17. [v2]: text->wav at B=16 through upstream's universal V2 generator
   (config_v2.json's values written as a hifigan_config.json, seeded random
   weights) behind the f32 flagship FastSpeech2: K1 exactly 10 and K4 4
   launches per forward (C = 64, 32, 16, 8), kernel vs plain path (mel_len
   identical, wav within 2 LSB), RTF and vocoder ms (medians of 3, in turns),
   K4's device time per stage from a profiler window;
18. [demo]: `masg_tpu_torch.demo.full_pipeline` on the card at masg_tpu's
   defaults but 1000 vocoder steps (`DEMO_VOCODER_STEPS`): its stage times,
   evidence and K1-K4 launches per stage (K1-K3 alike in both FastSpeech2
   trainings, K4 4 per vocoder forward: 16 in copy
   synthesis, 24 in the wavs, none in vocoder training), every evidence
   value finite, masg_tpu's three mechanical checks asserted (the
   discriminator BCE logged finite and positive, the lambda 0 vs 1000 delta
   > 1e-6, the copy-synthesis MCD reported) and its four learning gates
   printed with their values (GE2E loss below 0.7x its first epoch, EER <
   0.35, the wavs' median peak >= 0.1, their median F0 gender score in
   (0.05, 0.95)): a learning gate is the outcome of one seeded run, and
   `python -m masg_tpu_torch.demo.full_pipeline` asserts all seven; then
   `demo.probe`'s copy synthesis of each speaker's ground truth (RMS,
   full-scale share and F0 against the ground truth's);
19. [dp] (inside 10's directory): two spawned gloo ranks sharing the card
   against one: the train variants, GE2E and the V1 GAN; a 2-replica
   serving engine; NCCL at world size 1 (`cli.train --multihost`);
20. [tp]: four spawned gloo ranks sharing the card: rank 0's one-rank
   references, then the flagship train step on a 1 x 2 (data, model) mesh
   (plain with grad_acc_step 2, `--use_clf`, ganlike; 3 steps) and on 2 x 2
   (plain, 2 steps): gathered gradients, losses, launches per rank per
   step, parameters and peak memory per rank, ms and bytes all-reduced per
   step; float64 gradients on the plain path; dropout on (the replicated
   tensors' sha256 on both model ranks); a 1 x 2 checkpoint restored on one
   rank; then K1-K3 at 2 heads and at a rank's 1 head;
21. one `{"kernels": [...]}` line: K1-K4 once each, at the bfloat16 path's
   inputs, with the float32 figures as fields (`float32_forward`: K1 and K4
   per float32 forward; `float32_train_step`: K1, K2, K3 per float32 train
   step; `serve`: K1's and K4's launches under the 32 served requests and
   their device time per B=1 request at bucket 128; `adversarial`: K1's,
   K2's and K3's launches and device time per float32 `--use_clf` step;
   `jdit`: the same per float32 `use_jdit` step; `melgan`: K1's and K4's
   launches per MelGAN text->wav; `dump_mels` on K1: launches, batches and
   device time per batch; `trained_generator` on K4: launches per forward
   of the exported generator; `dp_train`, `dp_serve`, `tp_train`: launches
   per rank and ms per step of [dp] and [tp]; `v2`: K1's and K4's launches
   per V2 text->wav, and on K4 the path's times and K4's device ms per
   stage; `narrow_stages` on K4: the [K4] rows at C = 16 and 8 and the demo
   vocoder's; `demo`: the launches of the demo's training and vocoding
   stages);
22. the `{"ok": true, ...}` line, last.

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
  4 ulps at magnitudes 4-8); a run from a later row: bit for bit. The
  same bars at every width (C = 8 and 16 chain as many convolutions).
- K2/K3 float32: dQ (at valid rows), dK, dV within 5e-3 (masg_tpu's flash-
  gradient bar; sums in another order give ~1e-6); bfloat16: atol = rtol =
  1e-2 (both sides round float32 sums to bfloat16, one ulp at |grad| up to
  4; the kernels also round p and ds to bfloat16 as the operands of the
  tensor-core products, 2^-9 relative per term, which
  tests/test_torch_port_flash_bwd.py holds to the same bar on the CPU); dK
  and dV exactly 0 at keys >= len; no NaN.
- main path float32: duration_rounded and mel_len identical, postnet_mel
  within 2e-4 (masg_tpu's flash-vs-XLA model bar), int16 wavs within 2 LSB.
- serve float32: kernel vs plain engine mel_len identical, wav within 2 LSB
  (the main path's bar); batched vs single requests within 2 LSB (masg_tpu's
  atol=2); streamed PCM within 2 LSB of the one-shot vocode of the trimmed
  mel (window and full-length shapes may take other cuDNN algorithms).
- train step float32: losses within 1e-5 relative, every gradient within
  2e-3 (masg_tpu's model-gradient-with-flash bar), BatchNorm statistics
  within 1e-5; 20 bf16-autocast steps within 25 % of float32's last loss
  (tests/test_train_step.py); resumed losses within 1e-5 relative.
- adversarial steps float32: the train step's bars, dloss included; the
  gradient of dloss alone (at step 0 the schedule weighs it by 2.1e-6 in
  the total), per tensor of FastSpeech2 and, in ganlike, of the
  discriminator, against the plain path in float32 and in float64: max|err|
  within 2e-2 of the tensor's largest |gradient| plus 1e-6 of the part's
  (one f32 ReLU flip moves an FFN conv's gradient by up to 8e-3 of its own;
  gradients that are 0 in exact arithmetic hold to round-off).
- GE2E float32, card vs CPU: (ge2e, da) losses of 3 steps within 1e-4
  relative (cuDNN's LSTM and the CPU's sum in other orders, and 3 Adam
  updates carry the difference on); the vocoder GAN step at the tiny width
  the same bar on its 5 losses.
- dump_mels float32: kernel vs plain mels within 2e-4 (the main path's bar).
- vocoder fine-tuning: resumed losses within 1e-5 relative (cuDNN's
  backward algorithms are not bitwise deterministic); the exported
  generator, K4 vs the plain MRF, within 2 LSB.
- use_jdit step float32: the train step's bars (losses within 1e-5
  relative, every gradient within 2e-3, the teacher's included); the tiny
  width card vs CPU within 1e-5 relative after 3 steps (dropout off).
- MelGAN text->wav float32: mel_len identical, wav within 2 LSB (the main
  path's bar); streamed within 1 LSB of one-shot (masg_tpu's streaming
  bar).
- V2 text->wav float32: mel_len identical, wav within 2 LSB (the main
  path's bar).
- demo: masg_tpu's thresholds as scripts/demo_full_pipeline.py asserts them
  (:171, :196, :240-241, :281, :339-343, :378, :406); [demo] asserts the
  mechanical three (:240-241, :281, :339-343) and prints the learning four.
- tp, 1 x 2 and 2 x 2 vs one rank, float32: losses and grad_norm within
  1e-5 relative; each gathered gradient within 1e-2 of its tensor's largest
  |entry| plus 5e-6 (a gradient counted M times is off by >= 50 %; a ReLU
  whose f32 input rounds across 0 in a 512-channel conv moved a tensor by
  up to 5.5e-3; masg_tpu's dp bar, rtol 1e-4 / atol 5e-6, is printed beside
  it); float64 on the plain path: every gathered gradient within 1e-10 of
  its tensor's largest |entry| plus 1e-15; the dropout-on replicas
  bit-identical; the restored checkpoint's step within 1e-5; K1-K3 at a
  rank's 1 head (B = 16 and both B = 8 halves) at the float32 bars of
  [K1] and [K2/K3] (2e-5; 5e-3) against their plain versions.
- preprocess, card vs CPU: splits, files, duration and pitch identical;
  the mel (linear, exp of the stored log-mel) and energy within 1e-5 of
  each file's peak, the log-mel within 1e-3 (at near-silent bins, log-mel
  ~ -11.4, an f32 FFT is ~2e-4 of the peak off an f64 one, whichever FFT),
  stats.json within 1e-5 relative.
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


def timed(fn):
    """(host-clock seconds of fn() up to the device's end, its result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, r


def device_events(fn, iters, match=None):
    """The device events of a torch.profiler window over `iters` calls of
    fn() after one warm-up. A window in which the profiler recorded no device
    activity at all, or no kernel whose name contains `match`, is taken
    again: CUPTI has delivered no records for a whole window, or (seen once,
    after [tp]'s worker processes) none of the kernel asked for."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(match is None or match in e.name for e in dev):
            return dev
    return []


def device_ms(fn, iters, match=None):
    """Mean device time of fn() in ms, from a torch.profiler window over
    `iters` calls after one warm-up: the summed durations of the device
    kernels whose name contains `match` (every kernel when None), so the
    host's time between launches is left out."""
    kern = [e for e in device_events(fn, iters, match)
            if not getattr(e, "is_user_annotation", False) and (match is None or match in e.name)]
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
                   *(f"mrf_kernel<{c}>" for c in (8, 16, 32, 64)),
                   "mrf_bf16_kernel<8>", "mrf_bf16_kernel<16>"]
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
                       ("flash_dkv_bf16_kernel", 4), ("mrf_bf16_kernel", 4),
                       ("mrf_kernel", 4)):
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


def mrf_row(c, t, ks, dtype, gen):
    """K4 at (B, t, c) with resblock kernels `ks` (dilations 1, 3, 5) against
    its plain version, a run from a later row bit for bit, and its times and
    bound. Returns the row."""
    import torch

    from masg_tpu_torch.ops.fused_mrf import (fused_mrf_stage, fused_mrf_stage_plain,
                                              pack_stage_weights)

    dname = str(dtype).split(".")[-1]
    ds = ((1, 3, 5),) * len(ks)
    x = torch.randn(B, t, c, generator=gen).to(DEVICE, dtype)
    bps = random_mrf_params(c, ks, 3, gen, dtype)
    packed = pack_stage_weights(bps, ks, 3, dtype, DEVICE)
    y = fused_mrf_stage(x, bps, ks, ds)
    torch.cuda.synchronize()
    y_ref = fused_mrf_stage_plain(x, bps, ks, ds)
    err = (y.float() - y_ref.float()).abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else 0.125
    assert err <= tol, (dname, c, ks, err, tol)
    # tile position: a run that starts s rows later (s not a multiple of the
    # tile) gives the same bits at every row > 64 past the cut
    s0 = 1000 + 37
    y_cut = fused_mrf_stage(x[:2, s0:].contiguous(), bps, ks, ds)
    same = torch.equal(y_cut[:, 65:], y[:2, s0 + 65:])
    print(f"[K4] {dname} C={c} kernels {ks}: run from row {s0} equals the full run bit for "
          f"bit at rows > 64 past the cut: {same}")
    assert same, (dname, c, ks)
    row = {"err": err, "ms": cuda_ms(lambda: fused_mrf_stage(x, bps, ks, ds, packed), 3),
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
    print(f"[K4] {dname} C={c} T={t} kernels {ks}: max err {err:.3g} (max |ref| "
          f"{y_ref.float().abs().max().item():.3g}), kernel {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
          f"{rate})")
    return row


def check_mrf():
    """Phase 4 at the V1 main-path stage shapes (C = 64, 32), at V2's narrow
    stages (C = 16, 8 at the same T: V2 has 128 initial channels), and at
    C = 16 with the demo vocoder's two resblocks (3, 7). Returns ({dtype:
    {C: row}} of V1, {dtype: {C: row}} of V2 with the demo's row under
    "demo")."""
    import torch

    gen = torch.Generator().manual_seed(1)
    v1, narrow = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for c, t in ((64, T_MEL * 128), (32, T_MEL * 256)):
            v1.setdefault(dname, {})[c] = mrf_row(c, t, (3, 7, 11), dtype, gen)
        for c, t in ((16, T_MEL * 128), (8, T_MEL * 256)):
            narrow.setdefault(dname, {})[c] = mrf_row(c, t, (3, 7, 11), dtype, gen)
        narrow[dname]["demo"] = mrf_row(16, T_MEL * 128, (3, 7), dtype, gen)
    return v1, narrow


def flagship_config():
    from masg_tpu_torch.core.config import (ExperimentConfig, ModelConfig,
                                            PreprocessConfig, Stats, TrainConfig)

    return ExperimentConfig(preprocess=PreprocessConfig(), model=ModelConfig(),
                            train=TrainConfig(), stats=Stats(),
                            speakers={f"spk{i}": [i, "M", "ja"] for i in range(16)})


def build_path(cfg, dtype, kernels, config_dir=None):
    """(FastSpeech2, Vocoder) on the card; `kernels` selects K1/K4 or the plain
    ops; `config_dir` may hold a hifigan_config.json (default: V1)."""
    from masg_tpu_torch.compat.from_jax import with_duration_bias
    from masg_tpu_torch.infer.synthesis import load_model
    from masg_tpu_torch.infer.vocoder import get_vocoder

    model = load_model(cfg, device=DEVICE, use_flash=kernels, seed=0)
    model.load_state_dict(with_duration_bias(model.state_dict(), math.log(5.0)))
    model.to(dtype)
    vocoder = get_vocoder(cfg.model, config_dir, device=DEVICE, dtype=dtype,
                          fused_mrf=kernels, seed=1)
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


def bwd_inputs(t, dtype, lens, gen, h=H):
    """q, k, v, do (zero at query rows >= len), K1's lse, delta, and the
    (B, 1, T, 1) valid-row mask, with a row per length and `h` heads."""
    import torch

    from masg_tpu_torch.ops.attention import flash_attention

    b = len(lens)
    q, k, v = (torch.randn(b, h, t, DH, generator=gen).to(DEVICE, dtype) for _ in range(3))
    valid = (torch.arange(t, device=DEVICE)[None, :] < lens[:, None])[:, None, :, None]
    do = (torch.randn(b, h, t, DH, generator=gen).to(DEVICE) * valid).to(dtype)
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
        total, losses, eloss, _, _ = make_train_step(st.model).loss_fn(st.model, db)
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


def trainer_path(root):
    """Phase: `cli.train` on a random 32-utterance corpus under `root` at the
    flagship width, 4 steps, then a run resumed at step 2; then
    `cli.evaluate`. Returns the config dir (`[dump_mels]` reads its step 4)."""
    import torch

    from masg_tpu_torch.cli.evaluate import main as evaluate_main
    from masg_tpu_torch.cli.train import main as train_main
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

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
    return cfg_dir


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


def param_storage_path(train, smi):
    """[train], `--param_storage bf16|bf16_moments`: bf16 parameters with an
    f32 master copy, the model computing in bf16 with no autocast. One step
    per mode through the entry point (`train.state.create_train_state` +
    `train.step.make_train_step`): 10 launches each of K1-K3, all of them
    their bf16 instantiations (kernel names in a profiler window); the
    dtypes (parameters bf16, master f32 within rtol 1e-2 of them, moments
    per mode, BatchNorm statistics f32); finite losses; steps/s as [train]
    times them, beside its f32 and bf16-autocast rows."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = flagship_config()
    db = batch_to_device(train["batch"], DEVICE, torch.bfloat16)
    for storage in ("bf16", "bf16_moments"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = FastSpeech2.from_config(cfg, use_flash=True)
        model.to(DEVICE).to(torch.bfloat16)
        st = create_train_state(model, cfg.train.optimizer, cfg.model.transformer.encoder_hidden,
                                storage)
        step = make_train_step(model)
        reset_counts()
        st, m = step(st, db, 0)
        torch.cuda.synchronize()
        counts = read_counts()
        assert counts == {"K1": 10, "K2": 10, "K3": 10, "K4": 0}, (storage, counts)
        assert torch.isfinite(m.total) and torch.isfinite(m.grad_norm), storage
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, m = step(st, db, 1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        names = [e.name for e in kern]
        busy = _union_us([(e.time_range.start, e.time_range.end) for e in kern])
        opt = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if getattr(e, "is_user_annotation", False)
               and e.name.startswith("Optimizer.step")]
        print(f"[profile] --param_storage {storage}, one step: wall {wall_us / 1e3:.1f} ms, "
              f"device busy {busy / 1e3:.1f} ms ({100 * (1 - busy / wall_us):.1f} % idle), "
              f"{len(kern)} device ops, optimizer step {sum(b - a for a, b in opt) / 1e3:.1f} "
              f"ms of the wall; on {smi}")
        for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
            bf16 = sum(1 for n in names if f"{kernel}_bf16_kernel" in n)
            f32 = sum(1 for n in names if f"{kernel}_kernel<" in n)
            assert bf16 == 10 and f32 == 0, (storage, kernel, bf16, f32)
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        assert all(x.dtype == torch.float32 for x in st.master)
        np.testing.assert_allclose(next(model.parameters()).detach().float().cpu().numpy(),
                                   st.master[0].cpu().numpy(), rtol=1e-2)
        moment = st.optimizer.state[st.master[0]]["exp_avg"].dtype
        assert moment == (torch.bfloat16 if storage == "bf16_moments" else torch.float32)
        assert all(b.dtype == torch.float32 and bool(torch.isfinite(b).all())
                   for n, b in model.named_buffers() if "running_" in n)
        for i in range(2):
            step(st, db, 2 + i)
        walls = []
        for r in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, db, 4 + r)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            assert torch.isfinite(m.total), (storage, r)
        w = statistics.median(walls)
        print(f"[train] --param_storage {storage}: launches per step {counts}, all bf16 "
              f"instantiations; parameters bf16, master f32, moments {moment}; "
              f"{1.0 / w:.2f} steps/s ({w * 1e3:.1f} ms median of 10; walls "
              f"{[round(x * 1e3, 1) for x in walls]} ms; last loss {float(m.total):.4f}) "
              f"against float32 {train['rates'][('float32', True)]:.2f} and bfloat16 "
              f"autocast {train['rates'][('bfloat16', True)]:.2f} steps/s, kernel path; on "
              f"{smi}")
        del st, model, step


GE2E_N, GE2E_M = 32, 10  # masg_tpu's N x M (train_speech_embedder defaults)


def ge2e_corpus(root):
    """GE2E chunk archives of 32 synthetic speakers (16 ja, 16 en), written by
    the port's `build_ge2e_corpus` from 6-s wavs: a harmonic tone per speaker
    with a silent gap, so the VAD finds two spans of two 150-frame chunks."""
    import numpy as np

    from masg_tpu_torch.audio.wavio import write_wav
    from masg_tpu_torch.preprocessor.ge2e_preprocess import build_ge2e_corpus

    rng = np.random.default_rng(7)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    n = 6 * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    speakers = {}
    for s in range(GE2E_N):
        f0 = 90.0 + 6.0 * s
        wav = sum(0.3 / h * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.3))
                  for h in (1, 2, 3)) + 0.02 * rng.normal(size=n)
        wav[int(0.45 * n):int(0.55 * n)] = 0.0
        path = os.path.join(wav_dir, f"s{s:02d}.wav")
        write_wav(path, wav.astype(np.float32), SAMPLE_RATE)
        speakers[f"s{s:02d}"] = ([path], "MF"[s % 2], "ja" if s < GE2E_N // 2 else "en")
    chunks = os.path.join(root, "chunks")
    written = build_ge2e_corpus(speakers, chunks, "SYNTH")
    assert len(written) == GE2E_N, written
    return chunks


def ge2e_path(smi, root):
    """Phase [ge2e]: the GE2E trainer at masg_tpu's default width
    (SpeechEmbedder(80, 256, 3, 64), N = 32 x M = 10 chunks of 150 frames) on
    a chunk archive from `build_ge2e_corpus`: 3 steps on the card against the
    same 3 on the CPU (dropout off, TF32 off), ms per step (median of 10
    after 2 warm-ups, dropout on), one DA-subroutine epoch and one
    `evaluate_eer`. Returns the chunk directory."""
    import copy

    import torch

    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.train.ge2e import (SpeakerChunkDataset, evaluate_eer,
                                           make_ge2e_train_step, run_da_subroutine)

    t0 = time.time()
    chunks = ge2e_corpus(root)
    ds = SpeakerChunkDataset(chunks, ["SYNTH"], m_utts=GE2E_M, seed=0)
    batches = [ds.sample_batch(GE2E_N, variable_length=False) for _ in range(3)]
    print(f"[ge2e] {len(ds)} speakers' chunk archives from build_ge2e_corpus in "
          f"{time.time() - t0:.1f} s; batch {batches[0][0].shape}")
    torch.manual_seed(1)
    base = SpeechEmbedder()
    losses = {}
    for dev in (DEVICE, "cpu"):
        emb = copy.deepcopy(base).to(dev)
        for mod in emb.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        init_state, step = make_ge2e_train_step(emb, GE2E_N, GE2E_M)
        st = init_state()
        losses[dev] = []
        for mels, langs in batches:
            st, loss, da = step(st, mels, langs, False)
            losses[dev].append((float(loss), float(da)))
    err = max(abs(a - b) / abs(b) for sa, sb in zip(losses[DEVICE], losses["cpu"])
              for a, b in zip(sa, sb))
    print(f"[ge2e] 3 steps, card vs CPU (dropout off): (ge2e, da) losses "
          f"{[tuple(round(x, 5) for x in s) for s in losses[DEVICE]]} vs "
          f"{[tuple(round(x, 5) for x in s) for s in losses['cpu']]}, max relative err "
          f"{err:.3g} (tol 1e-4)")
    assert err <= 1e-4, losses

    emb = copy.deepcopy(base).to(DEVICE)
    init_state, step = make_ge2e_train_step(emb, GE2E_N, GE2E_M)
    st = init_state()
    for i in range(2):
        step(st, *batches[i % 3], False)
    walls = []
    for r in range(10):
        mels, langs = batches[r % 3]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, loss, da = step(st, mels, langs, False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    w = statistics.median(walls)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(3):
            st, loss, da = step(st, *batches[i], False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6 / 3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kern]) / 3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 3
    top = sorted(by_name.items(), key=lambda x: -x[1])[:3]
    print(f"[profile] GE2E step: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * (1 - busy / wall_us):.1f} % idle), {len(kern) // 3} device ops; heaviest "
          + "; ".join(f"{t / 1e3:.2f} ms {n[:60]}" for n, t in top) + f"; on {smi}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = run_da_subroutine(st, ds, GE2E_N, batches=2, max_epochs=1)
    torch.cuda.synchronize()
    t_da = time.perf_counter() - t1
    t1 = time.perf_counter()
    eer, thr = evaluate_eer(emb, ds, n_speakers=GE2E_N, m_utts=GE2E_M, epochs=1)
    t_eer = time.perf_counter() - t1
    assert math.isfinite(float(loss)) and 0.0 <= eer <= 1.0, (loss, eer)
    print(f"[ge2e] train step {w * 1e3:.1f} ms median of 10 (walls "
          f"{[round(x * 1e3, 1) for x in walls]} ms; N x M = {GE2E_N} x {GE2E_M}, 150 "
          f"frames, dropout on); one DA-subroutine epoch of 2 batches {t_da * 1e3:.1f} ms; "
          f"evaluate_eer (1 batch): EER {eer:.3f} at threshold {thr:.2f} in "
          f"{t_eer * 1e3:.1f} ms; on {smi}")
    return chunks


# [adversarial]'s frames a row: four whole discriminator chunks and 149
# frames of the fifth, which `chunk_mels` closes with one zero frame
ADV_T_MEL = 749


def adversarial_batch(t_mel=T_MEL, fill=False):
    """[train]'s batch at `t_mel` frames with languages and genders that differ
    across rows, a speaker shuffle (`reorder`) and the label jitter of each
    chunk. `fill`: every row's durations sum to `t_mel` (the last phone takes
    the rest), so no row ends in padded frames."""
    import numpy as np

    batch = example_inputs(B=B, L=L, T=t_mel)
    if fill:
        for i, n in enumerate(batch["src_lens"]):
            batch["durations"][i, n - 1] += t_mel - batch["durations"][i].sum()
        batch["mel_lens"] = batch["durations"].sum(1).astype(np.int32)
    rng = np.random.default_rng(11)
    meta = np.zeros((B, 4), np.float32)
    meta[np.arange(B), np.arange(B) % 2] = 1.0
    meta[np.arange(B), 2 + (np.arange(B) // 2) % 2] = 1.0
    batch["speaker_meta"] = meta
    batch["reorder"] = rng.permutation(B).astype(np.int32)
    batch["lang_jitter"] = rng.uniform(size=B * (t_mel // 150 + 1)).astype(np.float32)
    return batch


def adversarial_state(cfg, variant, kernels, disc, dtype=None):
    """(train state, step) of one adversarial variant on the card, FastSpeech2
    from seed 0 (the same weights on both paths), dropout off; `dtype`
    (float64) casts the model and the discriminator for a reference."""
    import copy

    import torch

    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.models.ganlike import GANLike
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import make_ganlike_train_step, make_train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FastSpeech2.from_config(cfg, use_flash=kernels)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model.to(DEVICE, dtype)
    disc = copy.deepcopy(disc).to(DEVICE, dtype)
    d_model = cfg.model.transformer.encoder_hidden
    total_step = cfg.train.step.total_step
    if variant == "ganlike":
        gl = GANLike(model, disc)
        st = create_train_state(gl, cfg.train.optimizer, d_model)
        return st, make_ganlike_train_step(gl, total_step=total_step)
    st = create_train_state(model, cfg.train.optimizer, d_model)
    return st, make_train_step(model, use_clf=True, discriminator=disc, total_step=total_step,
                               clf_featurization=variant.split("=")[1])


def adversarial_branch_grads(st, step, db):
    """{parameter name: gradient of dloss alone} on another forward pair. At
    step 0 the schedule weighs dloss by tanh(10 / (2 total_step)) lambd / n
    (2.1e-6 at 30000 steps and 80 chunks), so the gradient of the total
    cannot show the adversarial branch: K1 in the speaker-shuffled forward,
    its K2/K3 and, in ganlike, the whole of the discriminator's gradient."""
    import torch

    st.model.zero_grad(set_to_none=True)
    dloss = step.loss_fn(st.model, db, 0)[3]
    dloss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for n, p in st.model.named_parameters() if p.requires_grad}
    st.model.zero_grad(set_to_none=True)
    return grads


BRANCH_RTOL = 2e-2


def branch_grad_errs(got, want):
    """`got` against `want`, gradients of the adversarial branch, per part
    (ganlike: "model." and "discriminator."; --use_clf: the FastSpeech2
    alone): the largest |gradient| G, the number of tensors the branch
    reaches, and per tensor e = max|got - want| against the bar
    BRANCH_RTOL max|want| + 1e-6 G. The first term is relative to the
    tensor's own gradient: ReLU makes the gradient of the FFN's first conv
    jump where a unit's input crosses 0, and f32 round-off flips 1-5 units
    a layer between any two f32 paths (and between f32 and f64); one flip
    moves that conv's gradient by up to 8e-3 of its largest entry. The G
    term holds gradients that are 0 in exact arithmetic, such as the
    key-projection biases under softmax, to the round-off of the sums that
    cancel there."""
    ganlike = any(n.startswith("discriminator.") for n in want)
    parts = ("model.", "discriminator.") if ganlike else ("",)
    out = {}
    for part in parts:
        names = [n for n in want if n.startswith(part)]
        scale = {n: want[n].abs().max().item() for n in names}
        err = {n: (got[n].to(want[n].dtype) - want[n]).abs().max().item() for n in names}
        g = max(scale.values())
        ratio = {n: err[n] / (BRANCH_RTOL * scale[n] + 1e-6 * g) for n in names}
        worst = sorted(names, key=ratio.get, reverse=True)[:3]
        out[part or "fastspeech2."] = {
            "G": g, "reached": sum(v > 0 for v in scale.values()), "tensors": len(names),
            "max_ratio": ratio[worst[0]],
            "max_rel": max(err[n] / scale[n] for n in names if scale[n] > 1e-3 * g),
            "worst": [(n, err[n], scale[n]) for n in worst]}
    return out


def adversarial_path(smi):
    """Phase [adversarial]: the `--use_clf` step (clf_featurization model and
    ge2e) and the ganlike step at the flagship width and [train]'s batch, a
    GE2E discriminator of [ge2e]'s width as the port builds it (seed 1), f32,
    dropout off, on [train]'s batch at ADV_T_MEL frames that every row fills
    (a chunk of padded frames, which the discriminator's zero biases carry
    to an embedding norm near 0 and gradients of ~1e13, is left out), the
    same injected
    reorder / label jitter: kernel path against plain path (losses with dloss,
    every gradient, BatchNorm statistics), launches per step (K1, K2, K3: 20
    each, two forwards of 10 FFT blocks), ms per step for both paths (median of
    10), K1-K3 device time per `--use_clf` step (profiler window); then
    `cli.train_speech_embedder` (2 epochs), `cli.train --use_clf` with its
    checkpoint (2 steps) and `cli.train_ganlike` (2 steps) on the card.
    Returns {kernel: {launches, device_ms_per_step}} of the `--use_clf` step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masg_tpu_torch.train.step import batch_to_device

    cfg = flagship_config()
    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder

    db = batch_to_device(adversarial_batch(ADV_T_MEL, fill=True), DEVICE, torch.float32)
    db64 = batch_to_device(adversarial_batch(ADV_T_MEL, fill=True), DEVICE, torch.float64)
    torch.manual_seed(1)
    disc = SpeechEmbedder()
    kernel_fields = {}
    for variant in ("use_clf, clf_featurization=model", "use_clf, clf_featurization=ge2e",
                    "ganlike"):
        sides = {}
        for kernels in (True, False):
            st, step = adversarial_state(cfg, variant, kernels, disc)
            total, losses, eloss, dloss, _ = step.loss_fn(st.model, db, 0)
            total.backward()
            torch.cuda.synchronize()
            vals = [float(x.detach()) for x in (total, *losses, eloss, dloss)]
            grads = [p.grad.detach().clone() for p in st.params()]
            bn = {n: b.clone() for n, b in st.model.named_buffers() if "running_" in n}
            branch = adversarial_branch_grads(st, step, db)
            reset_counts()
            step(st, db, 0)
            torch.cuda.synchronize()
            counts = read_counts()
            want = 20 if kernels else 0
            assert counts == {"K1": want, "K2": want, "K3": want, "K4": 0}, (variant, counts)
            sides[kernels] = (st, step, vals, grads, bn, counts, branch)
        (sk, stepk, lk, gk, bk, ck, rk), (sp, stepp, lp, gp, bp, _, rp) = (sides[True],
                                                                        sides[False])
        assert lk[-1] != 0.0, "dloss is 0"
        loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lk, lp))
        grad_err = max((a - b).abs().max().item() for a, b in zip(gk, gp))
        bn_err = max((bk[n] - bp[n]).abs().max().item() for n in bk)
        print(f"[adversarial] {variant}, float32 kernel vs plain path, dropout off: losses "
              f"(total, mel, postnet, pitch, energy, duration, eloss, dloss) "
              f"{[round(x, 5) for x in lk]}, max relative err {loss_err:.3g} (tol 1e-5), "
              f"max|grad err| {grad_err:.3g} over {len(gk)} tensors (tol 2e-3), "
              f"max|BatchNorm statistics err| {bn_err:.3g} (tol 1e-5); launches per step "
              f"{ck}")
        st64, step64 = adversarial_state(cfg, variant, False, disc, torch.float64)
        r64 = adversarial_branch_grads(st64, step64, db64)
        del st64, step64
        branch = {}
        for pair, got, want in (("kernel vs plain", rk, rp), ("kernel vs float64 plain", rk, r64),
                                ("plain vs float64 plain", rp, r64)):
            branch[pair] = branch_grad_errs(got, want)
            for part, b in branch[pair].items():
                print(f"[adversarial] {variant}, gradient of dloss alone, {part}*, {pair}: "
                      f"largest |gradient| G {b['G']:.4g}, {b['reached']} of {b['tensors']} "
                      f"tensors reached; max|err| / max|grad| {b['max_rel']:.3g} over tensors "
                      f"with max|grad| > 1e-3 G; worst max|err| / ({BRANCH_RTOL:g} max|grad| + "
                      f"1e-6 G) {b['max_ratio']:.3g} (tol 1); worst (tensor, max|err|, "
                      f"max|grad|) " + ", ".join(f"({n}, {e:.3g}, {g:.3g})"
                                                 for n, e, g in b["worst"]))
        assert loss_err <= 1e-5 and grad_err <= 2e-3 and bn_err <= 1e-5, (
            variant, loss_err, grad_err, bn_err)
        for pair in ("kernel vs plain", "kernel vs float64 plain"):
            assert all(b["G"] > 0 and b["max_ratio"] <= 1.0 for b in branch[pair].values()), (
                variant, pair, branch[pair])
            assert set(branch[pair]) == ({"model.", "discriminator."} if variant == "ganlike"
                                         else {"fastspeech2."}), sorted(branch[pair])
        walls = {True: [], False: []}
        for kernels in (True, False):
            st, step = sides[kernels][:2]
            for i in range(2):
                step(st, db, 1 + i)
        for r in range(10):
            for kernels in ((True, False) if r % 2 == 0 else (False, True)):
                st, step = sides[kernels][:2]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = step(st, db, 3 + r)
                torch.cuda.synchronize()
                walls[kernels].append(time.perf_counter() - t0)
                assert torch.isfinite(m.total) and torch.isfinite(m.dloss), variant
        med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
        print(f"[adversarial] {variant}: kernel path {med[True]:.1f} ms/step, plain path "
              f"{med[False]:.1f} ms/step (medians of 10, in turns; kernel walls "
              f"{[round(x * 1e3, 1) for x in walls[True]]} ms) on {smi}")
        if variant.endswith("=model"):
            st, step = sides[True][:2]
            n = 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(n):
                    step(st, db, 20 + i)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / n * 1e3
            kern = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)]
            busy = _union_us([(e.time_range.start, e.time_range.end) for e in kern]) / n / 1e3
            for name, match in (("K1", "flash_fwd"), ("K2", "flash_dq"), ("K3", "flash_dkv")):
                dev = sum(e.time_range.end - e.time_range.start for e in kern
                          if match in e.name) / n / 1e3
                kernel_fields[name] = {"step": "--use_clf, clf_featurization=model, float32",
                                       "launches": ck[name], "device_ms_per_step": dev}
            lstm = sum(e.time_range.end - e.time_range.start for e in kern
                       if "RNN" in e.name or "rnn" in e.name or "LSTM" in e.name) / n / 1e3
            print(f"[profile] {variant} kernel path: wall {wall:.1f} ms/step, device busy "
                  f"{busy:.1f} ms/step ({100 * (1 - busy / wall):.1f} % idle), "
                  f"{len(kern) // n} device ops/step; K1 "
                  f"{kernel_fields['K1']['device_ms_per_step']:.3f}, K2 "
                  f"{kernel_fields['K2']['device_ms_per_step']:.3f}, K3 "
                  f"{kernel_fields['K3']['device_ms_per_step']:.3f} ms/step; cuDNN RNN "
                  f"kernels {lstm:.3f} ms/step; on {smi}")
        del sides, sk, sp, stepk, stepp
    return kernel_fields


def adversarial_clis(chunks):
    """`cli.train_speech_embedder` -> its checkpoint as `cli.train --use_clf`'s
    discriminator_path -> `cli.train_ganlike`, all on the card."""
    import tempfile

    import torch

    from masg_tpu_torch.cli.train import main as train_main
    from masg_tpu_torch.cli.train_ganlike import main as ganlike_main
    from masg_tpu_torch.cli.train_speech_embedder import main as embedder_main
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

    root = tempfile.mkdtemp(prefix="adv_", dir=os.path.dirname(chunks))
    t0 = time.time()
    st = embedder_main(["--data_path", chunks, "--datasets", "SYNTH", "--out_dir",
                        os.path.join(root, "ge2e"), "--epochs", "2"])
    ckpt = os.path.join(root, "ge2e", "final_epoch_2.pth")
    assert os.path.exists(ckpt) and next(st.embedder.parameters()).device.type == DEVICE
    t_ge2e = time.time() - t0
    pre = write_preprocessed_corpus(os.path.join(root, "pre"), n_utts=32, n_speakers=4,
                                    n_val=4, phones=(48, 120), frames_per_phone=(1, 5))
    runs = {}
    for name, cli, extra in (("cli.train --use_clf", train_main, ["--use_clf"]),
                             ("cli.train_ganlike", ganlike_main, [])):
        cfg_dir = write_config_dir(os.path.join(root, name.split()[0], "cfg"), pre,
                                   os.path.join(root, name.split()[0], "out"),
                                   step={"save_step": 2, "val_step": 1000},
                                   train={"discriminator_path": ckpt})
        reset_counts()
        t0 = time.time()
        state = cli(["-c", cfg_dir, "--max_steps", "2", *extra])
        torch.cuda.synchronize()
        counts = read_counts()
        losses = dict(_total_losses(cfg_dir))
        assert state.step == 2 and counts == {"K1": 40, "K2": 40, "K3": 40, "K4": 0}, counts
        assert sorted(losses) == [1, 2] and all(math.isfinite(v) for v in losses.values())
        runs[name] = (time.time() - t0, counts, losses)
    print(f"[adversarial] cli.train_speech_embedder: 2 epochs in {t_ge2e:.1f} s -> "
          f"{os.path.basename(ckpt)}; " + "; ".join(
              f"{n}: 2 steps in {t:.1f} s, launches {c}, losses "
              f"{[round(v, 4) for v in ls.values()]}" for n, (t, c, ls) in runs.items()))


SERVE_BUCKETS, SERVE_FPP, SERVE_LADDER = (16, 32, 64, 128), 12, (1, 2, 4, 8)


def _phone_pool():
    """Phone symbols that a '{...}' request string round-trips."""
    from masg_tpu_torch.text import phone_string_to_sequence
    from masg_tpu_torch.text.symbols import symbols

    pool = [s for s in symbols if s.isascii() and s.isalpha()]
    assert phone_string_to_sequence("{" + " ".join(pool) + "}")
    return pool


def _http(url, path, payload=None, timeout=120):
    """(status, headers, body) of a GET (payload None) or JSON POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wav_pcm(body):
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, SAMPLE_RATE)
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _max_lsb(a, b):
    import numpy as np

    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _stream(url, payload):
    """(PCM, seconds to the first audio sample, seconds to the end) of one
    POST /synthesize_streaming."""
    import urllib.request

    import numpy as np

    req = urllib.request.Request(url + "/synthesize_streaming", method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200 and resp.headers["Transfer-Encoding"] == "chunked"
        head = resp.read(46)  # the RIFF header and the first PCM sample
        first = time.perf_counter() - t0
        body = head + resp.read()
    assert body[:4] == b"RIFF" and body[36:40] == b"data"
    return np.frombuffer(body[44:], np.int16), first, time.perf_counter() - t0


def profile_stream(engine, ids, smi):
    """A torch.profiler window over one warm `synthesize_streaming` of `ids`
    (speaker 5), called on the engine without HTTP: the wall time to the
    first chunk and to the end, the device's busy time and idle share, and
    the busy time of the mel-only forward apart from the vocoder windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen = engine.synthesize_streaming(ids, speaker_id=5)
        with record_function("masg::first_chunk"):
            chunks = [next(gen)]
        t1 = time.perf_counter()
        marks = [t1]
        for chunk in gen:
            chunks.append(chunk)
            marks.append(time.perf_counter())
        t2 = time.perf_counter()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in evs if not getattr(e, "is_user_annotation", False)]
    assert kern, "the profiler saw no device work on the streaming path"
    iv = [(e.time_range.start, e.time_range.end) for e in kern]
    busy = _union_us(iv)
    k4 = sum(e.time_range.end - e.time_range.start for e in kern if "mrf_" in e.name)
    k1 = sum(e.time_range.end - e.time_range.start for e in kern if "flash_fwd" in e.name)
    wall = (t2 - t0) * 1e6
    print(f"[serve] profile of one warm stream (engine, no HTTP): {len(chunks)} chunks, first "
          f"chunk {(t1 - t0) * 1e3:.1f} ms, whole stream {wall / 1e3:.1f} ms; device busy "
          f"{busy / 1e3:.1f} ms ({100 * (1 - busy / wall):.1f} % idle), {len(kern)} device "
          f"ops; K1 {k1 / 1e3:.3f} ms, K4 {k4 / 1e3:.3f} ms (device time); windows after "
          f"the first {[round((b - a) * 1e3, 1) for a, b in zip(marks, marks[1:])]} ms; "
          f"on {smi}")
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"[serve]   host {e.self_cpu_time_total / 1e3:8.3f} ms self CPU, {e.count:5d} "
              f"calls  {e.key[:80]}")


def serve_path(smi):
    """Phase [serve]: the flagship FastSpeech2 (seed 0, duration bias ln 5)
    and HiFi-GAN V1 (seed 1) in f32 behind `ServingEngine` (text buckets
    16/32/64/128, 12 frames per phone) + `DynamicBatcher` (max batch 8,
    5 ms window, queue cap 64) + `cli.serve.make_server` on an ephemeral
    port: /health; 32 POST /synthesize from 16 client threads (fusion, K1 and
    K4 launches exactly 10 and 2 per dispatch); the kernel engine against a
    plain-path engine from the same weights; one POST /synthesize_streaming
    against the one-shot vocode of its trimmed mel; a barycenter voice built by
    `cli.build_distribution` served as speaker_emb; a bf16 engine; latencies,
    req/s, first-audio time, and K1's and K4's device time per B = 1 request at
    bucket 128. Returns the kernels-line fields of K1 and K4."""
    import base64
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from masg_tpu_torch.cli.build_distribution import main as build_distribution
    from masg_tpu_torch.cli.examples_gen_distri import load_distribution
    from masg_tpu_torch.cli.serve import make_server, request_to_ids
    from masg_tpu_torch.compat.from_jax import with_duration_bias
    from masg_tpu_torch.distributions.wasserstein import metadata_corners
    from masg_tpu_torch.infer.serving import DynamicBatcher, ServingEngine
    from masg_tpu_torch.infer.synthesis import load_model
    from masg_tpu_torch.infer.vocoder import (get_vocoder, measure_receptive_field_frames,
                                              vocoder_infer)
    from masg_tpu_torch.ops.gmm import sample as gmm_sample

    cfg = flagship_config()
    sd = with_duration_bias(load_model(cfg, device=DEVICE, seed=0).state_dict(),
                            math.log(5.0))

    def make_engine(kernels, dtype=torch.float32, with_vocoder=True):
        vocoder = (get_vocoder(cfg.model, device=DEVICE, fused_mrf=kernels, seed=1)
                   if with_vocoder else None)
        return ServingEngine(cfg, state_dict=sd, vocoder=vocoder, text_buckets=SERVE_BUCKETS,
                             frames_per_phone=SERVE_FPP, dtype=dtype, device=DEVICE,
                             use_flash=kernels)

    def one_shot_of_trimmed_mel(engine, mel_engine, ids, speaker_id=0):
        """The streaming reference: the mel-only engine's trimmed mel (the same
        weights, dtype and kernels as `engine`), vocoded in one shot."""
        r = mel_engine.synthesize(ids, speaker_id=speaker_id)
        mel = torch.from_numpy(r["mel"])[None].to(DEVICE)
        return r["bucket"], r["mel_len"], vocoder_infer(mel, engine.vocoder)[0]

    engine = make_engine(True)
    batcher = DynamicBatcher(engine, max_batch=8, window_ms=5.0, max_queue=64)
    t0 = time.perf_counter()
    warm = engine.warmup(include_speaker_emb=True, batch_sizes=SERVE_LADDER)
    print(f"[serve] warm-up of {len(warm)} (B, L) buckets in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"B={b} L={n} T={engine.mel_caps[n]} {s * 1e3:.1f} ms"
                      for (b, n), s in warm.items()))
    srv = make_server(batcher, "127.0.0.1", 0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=os.path.join(REPO, "build"))
    try:
        code, _, body = _http(url, "/health")
        health = json.loads(body)
        assert code == 200 and health["buckets"] == {"16": 256, "32": 384, "64": 768,
                                                     "128": 1000}, (code, health)
        print(f"[serve] /health: {health}")

        # 16 clients x 2 POST /synthesize, random phones, speakers and controls
        rng = np.random.default_rng(7)
        pool = _phone_pool()
        reqs = []
        for i in range(32):
            payload = {"phones": "{" + " ".join(rng.choice(pool, rng.integers(10, 121))) + "}",
                       "speaker_id": int(rng.integers(0, 16))}
            if i % 3 == 0:
                payload.update(pitch_control=1.2, energy_control=0.9, duration_control=0.9)
            reqs.append(payload)
        out, errors = [None] * 32, []

        def client(k):
            try:
                for i in (2 * k, 2 * k + 1):
                    t = time.perf_counter()
                    code, headers, body = _http(url, "/synthesize", reqs[i])
                    out[i] = (code, headers, body, time.perf_counter() - t)
            except Exception as e:  # re-raised in the main thread below
                errors.append(e)

        n_req0, n_batch0 = engine.n_requests, engine.n_batches
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read_counts()
        if errors:
            raise errors[0]
        assert not any(c.is_alive() for c in clients), "a client thread hung"
        n_req, n_disp = engine.n_requests - n_req0, engine.n_batches - n_batch0
        for i, (code, headers, body, _) in enumerate(out):
            assert code == 200, (i, code, body[:200])
            pcm = _wav_pcm(body)
            assert pcm.size == int(headers["X-Mel-Len"]) * HOP > 0, i
        lat = sorted(x[3] for x in out)
        assert n_req == 32 and n_disp < n_req, (n_req, n_disp)
        assert counts == {"K1": 10 * n_disp, "K2": 0, "K3": 0, "K4": 2 * n_disp}, (counts,
                                                                                 n_disp)
        serve_launches = counts
        print(f"[serve] 32 POST /synthesize from 16 clients: all 200 with RIFF wavs, "
              f"{n_disp} batched dispatches for {n_req} requests, launches {counts} "
              f"(10 K1 and 2 K4 per dispatch); {32 / wall:.2f} req/s ({wall:.2f} s), "
              f"latency p50 {statistics.median(lat) * 1e3:.1f} ms, p99 "
              f"{np.percentile(lat, 99) * 1e3:.1f} ms, max {lat[-1] * 1e3:.1f} ms; on {smi}")

        # the kernel path against the plain path, from the same weights
        plain = make_engine(False)
        ids_by_bucket = {n: request_to_ids({"phones": "{" + " ".join(
            rng.choice(pool, n - 3)) + "}"})[0] for n in SERVE_BUCKETS}
        for n, ids in ids_by_bucket.items():
            k, p = engine.synthesize(ids, speaker_id=3), plain.synthesize(ids, speaker_id=3)
            assert k["bucket"] == n and k["mel_len"] == p["mel_len"] > 0, (n, k["mel_len"],
                                                                          p["mel_len"])
            err = _max_lsb(k["wav"], p["wav"])
            print(f"[serve] bucket {n}: kernel vs plain engine, mel_len {k['mel_len']} "
                  f"identical, max|wav err| {err} LSB (tol 2)")
            assert err <= 2, (n, err)
        many_reqs = [{"ids": request_to_ids({"phones": r["phones"]})[0],
                      "speaker_id": r["speaker_id"]} for r in reqs[:8]]
        many, many_plain = engine.synthesize_many(many_reqs), plain.synthesize_many(many_reqs)
        del plain
        worst = worst_plain = 0
        for r, m, mp in zip(many_reqs, many, many_plain):
            s = engine.synthesize(r["ids"], speaker_id=r["speaker_id"])
            assert s["mel_len"] == m["mel_len"] == mp["mel_len"], (s["mel_len"], m["mel_len"],
                                                                   mp["mel_len"])
            worst = max(worst, _max_lsb(s["wav"], m["wav"]))
            worst_plain = max(worst_plain, _max_lsb(mp["wav"], m["wav"]))
        print(f"[serve] synthesize_many of 8 (B=8 at bucket {many[0]['bucket']}): mel_len "
              f"identical to the plain engine's B=8 dispatch and to the 8 single requests, "
              f"max|wav err| {worst_plain} LSB against the plain dispatch, {worst} LSB against "
              f"the single requests (tol 2)")
        assert worst <= 2 and worst_plain <= 2, (worst, worst_plain)

        # streaming at bucket 128: the first request pays the receptive-field
        # probes and cuDNN's plans for the new window shapes; a second is warm
        payload = {"phones": "{" + " ".join(rng.choice(pool, 110)) + "}", "speaker_id": 5}
        streams = [_stream(url, payload) for _ in range(2)]
        stream = streams[0][0]
        assert np.array_equal(stream, streams[1][0]), "two streams of one request differ"
        ids = request_to_ids(payload)[0]
        mel_engine = make_engine(True, with_vocoder=False)
        bucket, mel_len, full = one_shot_of_trimmed_mel(engine, mel_engine, ids, speaker_id=5)
        del mel_engine
        assert bucket == 128 and stream.shape == full.shape, (bucket, stream.shape, full.shape)
        d = np.abs(stream.astype(np.int32) - full.astype(np.int32))
        rf = measure_receptive_field_frames(engine.vocoder)  # cached by the first stream
        (_, cold_first, cold_wall), (_, first_audio, stream_wall) = streams
        print(f"[serve] POST /synthesize_streaming at bucket 128: {mel_len} frames, "
              f"max|err| {d.max()} LSB against the one-shot vocode of the trimmed mel (tol 2), "
              f"{(d > 0).mean():.4%} of samples differ; measured receptive field {rf} frames "
              f"(context {rf + 2}); first audio {first_audio * 1e3:.1f} ms, whole stream "
              f"{stream_wall * 1e3:.1f} ms (the first stream, with the field's probes and new "
              f"window shapes: {cold_first * 1e3:.1f} / {cold_wall * 1e3:.1f} ms); on {smi}")
        assert d.max() <= 2, d.max()
        profile_stream(engine, ids, smi)

        # a mid-attribute voice: the barycenter of the prior's metadata corners
        cfg_dir = os.path.join(root, "cfg")
        os.makedirs(cfg_dir)
        for name in ("preprocess.yaml", "model.yaml", "train.yaml"):
            with open(os.path.join(cfg_dir, name), "w") as f:
                f.write("{}\n")
        cfg.stats.dump(os.path.join(cfg_dir, "stats.json"))
        with open(os.path.join(cfg_dir, "speakers.json"), "w") as f:
            json.dump(cfg.speakers, f)
        ckpt = os.path.join(root, "model.pth.tar")
        torch.save({"model": {k: v.cpu() for k, v in sd.items()}}, ckpt)
        npz = os.path.join(root, "neutral.npz")
        gmm = build_distribution(["-c", cfg_dir, "--checkpoint", ckpt, "--device", DEVICE,
                                  "--mode", "barycenter", "-o", npz])
        emb = gmm_sample(load_distribution(npz), torch.Generator().manual_seed(0))
        assert torch.isfinite(emb).all() and emb.shape == (1, 256), emb.shape
        code, _, body = _http(url, "/synthesize", {"phones": reqs[0]["phones"], "format": "json",
                                                   "speaker_emb": emb[0].tolist()})
        assert code == 200, (code, body[:200])
        r = json.loads(body)
        pcm = _wav_pcm(base64.b64decode(r["wav_b64"]))
        peak = int(np.abs(pcm.astype(np.int32)).max())
        n_corners = len(metadata_corners(cfg.preprocess.speaker_generation.metadata))
        print(f"[serve] cli.build_distribution --mode barycenter: {gmm.pi.shape[-1]} "
              f"components over {n_corners} corners; a sampled voice served as speaker_emb: 200, "
              f"mel_len {r['mel_len']}, peak {peak}")
        assert r["mel_len"] > 0 and peak > 100, (r["mel_len"], peak)

        # B = 1 latency per bucket, and K1/K4 device time per request at 128
        p50 = {}
        for n, ids in ids_by_bucket.items():
            lats = [engine.synthesize(ids)["latency_s"] for _ in range(5)]
            p50[n] = statistics.median(lats)
        print("[serve] B=1 latency p50 of 5: " + ", ".join(
            f"bucket {n} (T={engine.mel_caps[n]}) {s * 1e3:.1f} ms" for n, s in p50.items())
            + f"; on {smi}")
        reset_counts()
        engine.synthesize(ids_by_bucket[128])
        per_req = read_counts()
        assert per_req == {"K1": 10, "K2": 0, "K3": 0, "K4": 2}, per_req
        k1_dev = device_ms(lambda: engine.synthesize(ids_by_bucket[128]), 3, "flash_fwd")
        k4_dev = device_ms(lambda: engine.synthesize(ids_by_bucket[128]), 3, "mrf_")
        all_dev = device_ms(lambda: engine.synthesize(ids_by_bucket[128]), 3)
        print(f"[serve] one B=1 request at bucket 128 (T=1000): device time K1 {k1_dev:.3f} ms "
              f"(10 launches), K4 {k4_dev:.3f} ms (2 launches), all device work "
              f"{all_dev:.3f} ms, latency p50 {p50[128] * 1e3:.1f} ms; on {smi}")

        # dispatches of B = 8 / 16 / 32 at bucket 128: cli.serve's default
        # --dynamic_batch 32 warms and dispatches up to B = 32
        big = [{"ids": request_to_ids({"phones": "{" + " ".join(
            rng.choice(pool, rng.integers(65, 121))) + "}"})[0],
            "speaker_id": int(rng.integers(0, 16))} for _ in range(32)]
        sweep = []
        for b in (8, 16, 32):
            t0 = time.perf_counter()
            res = engine.synthesize_many(big[:b], batch_buckets=(b,))
            cold = time.perf_counter() - t0
            assert all(r["bucket"] == 128 and r["wav"].size == r["mel_len"] * HOP > 0
                       for r in res), b
            lats = [engine.synthesize_many(big[:b], batch_buckets=(b,))[0]["latency_s"]
                    for _ in range(3)]
            sweep.append(f"B={b} {statistics.median(lats) * 1e3:.1f} ms "
                         f"({b / statistics.median(lats):.1f} req/s; first dispatch "
                         f"{cold * 1e3:.1f} ms)")
        print("[serve] one dispatch at bucket 128 (T=1000), median of 3 after one first: "
              + ", ".join(sweep) + f"; on {smi}")

        # bf16: an engine that casts the vocoder too
        bf = make_engine(True, torch.bfloat16)
        assert bf.vocoder.dtype == torch.bfloat16
        bf.warmup(batch_sizes=(1,))
        reset_counts()
        for n in SERVE_BUCKETS:
            w = bf.synthesize(ids_by_bucket[n])["wav"]
            assert w.size > 0 and int(np.abs(w.astype(np.int32)).max()) > 100, n
        counts_bf = read_counts()
        assert counts_bf == {"K1": 40, "K2": 0, "K3": 0, "K4": 8}, counts_bf
        ids = ids_by_bucket[128]
        bstream = np.concatenate(list(bf.synthesize_streaming(ids)))
        bf_mel_engine = make_engine(True, torch.bfloat16, with_vocoder=False)
        _, _, bfull = one_shot_of_trimmed_mel(bf, bf_mel_engine, ids)
        print(f"[serve] bfloat16 engine: 4 requests through the kernels (launches "
              f"{counts_bf}), finite non-silent wavs; streaming vs one-shot max|err| "
              f"{_max_lsb(bstream, bfull)} LSB (not gated; receptive field measured in "
              f"bfloat16 {measure_receptive_field_frames(bf.vocoder)} frames)")
        del bf, bf_mel_engine
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=30)
        batcher.close()
        shutil.rmtree(root)
    return {"launches": serve_launches, "n_dispatches": n_disp,
            "per_request_bucket128": {"K1": {"launches": per_req["K1"], "device_ms": k1_dev},
                                      "K4": {"launches": per_req["K4"], "device_ms": k4_dev}}}


# ---------------------------------------------------------------------------
# vocoder training, mel dumping, fine-tuning and feature extraction
# ---------------------------------------------------------------------------

# masg_tpu's tests' TINY_CFG (tests/test_vocoder_training.py:41-51): the
# card-vs-CPU check of the GAN step
TINY_VOCODER = {"segment_size": 512, "hop_size": 16, "n_fft": 64, "win_size": 64,
                "num_mels": 8, "sampling_rate": 22050, "fmin": 0, "fmax": 8000,
                "fmax_for_loss": None, "learning_rate": 2e-4, "adam_b1": 0.8,
                "adam_b2": 0.99, "lr_decay": 0.999, "upsample_rates": [4, 4],
                "upsample_kernel_sizes": [8, 8], "upsample_initial_channel": 32,
                "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 2]],
                "mpd_periods": [2, 3], "mpd_channels": [4, 8, 16, 16], "msd_scales": 2,
                "msd_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}


def sine_batch(rng, b, n, noise=0.02):
    """(b, n) f32 audio: two harmonics of a random F0 in 100-300 Hz plus noise."""
    import numpy as np

    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(100, 300, size=(b, 1))
    ph = rng.uniform(0, 2 * np.pi, size=(b, 1))
    wav = 0.5 * np.sin(2 * np.pi * f0 * t + ph) + 0.2 * np.sin(4 * np.pi * f0 * t + ph)
    return (wav + noise * rng.normal(size=(b, n))).astype(np.float32)


def vocoder_train_path(smi):
    """Phase [vocoder_train]: the HiFi-GAN GAN step (`train.vocoder`) at the
    universal V1 width (generator 512 channels at rates 8·8·2·2, MPD periods
    2/3/5/7/11 up to 1024 channels, MSD 3 scales), B = 16, segment 8192, f32,
    seeded weights and a seeded sine-plus-noise batch: 2 warm-ups and 10
    timed steps (wall per step, each ending in a synchronize), finite losses,
    no K4 launch, peak memory, one profiler window (idle share, heaviest
    device ops); 3 steps at the tests' tiny width on the card and the CPU;
    K4 on a tensor that requires grad raises."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masg_tpu_torch.cli.train_vocoder import DEFAULT_TRAIN_CONFIG
    from masg_tpu_torch.infer.vocoder import DEFAULT_HIFIGAN_CONFIG
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage
    from masg_tpu_torch.train.vocoder import init_vocoder_train_state, make_vocoder_train_step

    cfg = {**DEFAULT_HIFIGAN_CONFIG, **DEFAULT_TRAIN_CONFIG}
    bsz, seg = cfg["batch_size"], cfg["segment_size"]
    y = torch.from_numpy(sine_batch(np.random.default_rng(0), bsz, seg)).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_vocoder_train_state(cfg, steps_per_epoch=1000, seed=0, device=DEVICE)
    n_gen = sum(p.numel() for p in state.generator.parameters())
    n_disc = sum(p.numel() for p in state.disc_params())
    step = make_vocoder_train_step(cfg)
    k4 = fused_mrf_stage.launches
    for _ in range(2):
        state, m = step(state, y)
    torch.cuda.synchronize()
    walls, losses = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        state, m = step(state, y)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append([float(x) for x in m])
    assert fused_mrf_stage.launches == k4, "K4 launched inside the GAN step"
    assert all(math.isfinite(x) for row in losses for x in row), losses
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(walls)
    print(f"[vocoder_train] V1 GAN step, B={bsz} x {seg} samples, f32 (TF32 off): generator "
          f"{n_gen / 1e6:.2f}M + discriminators {n_disc / 1e6:.2f}M parameters; "
          f"{med * 1e3:.1f} ms per step (median of 10; mean {statistics.mean(walls) * 1e3:.1f}, "
          f"min {min(walls) * 1e3:.1f}), {1 / med:.3f} steps/s; peak memory {peak:.2f} GiB; "
          f"losses step 3 {[round(x, 4) for x in losses[0]]}, step 12 "
          f"{[round(x, 4) for x in losses[-1]]} (disc, gen, adv, fm, mel_l1); K4 launches 0; "
          f"on {smi}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = step(state, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    assert kern, "the profiler saw no device work in the GAN step"
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kern])
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    print(f"[vocoder_train] profiler window, 2 steps: wall {wall / 2e3:.1f} ms / step, device "
          f"busy {busy / 2e3:.1f} ms / step ({100 * (1 - busy / wall):.1f} % idle), "
          f"{len(kern) // 2} device ops / step; heaviest (ms / step):")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print(f"[vocoder_train]   {t / 2e3:8.3f}  {name[:110]}")
    del state, step, y
    torch.cuda.empty_cache()

    # the tiny width, 3 steps on the card and on the CPU from the same weights
    tiny_step = make_vocoder_train_step(TINY_VOCODER)
    rng = np.random.default_rng(1)
    batches = [sine_batch(rng, 4, TINY_VOCODER["segment_size"]) for _ in range(3)]
    got = {}
    for dev in (DEVICE, "cpu"):
        st = init_vocoder_train_state(TINY_VOCODER, 2, seed=1, device=dev)
        got[dev] = []
        for b in batches:
            st, m = tiny_step(st, torch.from_numpy(b).to(dev))
            got[dev].append([float(x) for x in m])
    err = max(abs(a - b) / abs(b) for ra, rb in zip(got[DEVICE], got["cpu"])
              for a, b in zip(ra, rb))
    print(f"[vocoder_train] tiny width (TINY_CFG), 3 steps card vs CPU: max relative err of "
          f"the 5 losses {err:.3g} (tol 1e-4)")
    assert err <= 1e-4, (got, err)

    # the repair: K4 refuses a tensor that needs a gradient
    blocks = random_mrf_params(32, (3,), 1, torch.Generator().manual_seed(4), torch.float32)
    x = torch.randn(1, 64, 32, device=DEVICE, requires_grad=True)
    try:
        fused_mrf_stage(x, blocks, (3,), ((1,),))
    except RuntimeError as e:
        assert "inference-only" in str(e), e
    else:
        raise AssertionError("fused_mrf_stage ran K4 on a tensor that requires grad")
    print("[vocoder_train] fused_mrf_stage on a CUDA tensor that requires grad: raises "
          "(K4 is inference-only)")
    return {"ms_per_step": med * 1e3, "peak_gib": peak, "idle": 1 - busy / wall}


def _split_count(cfg_dir, split):
    from masg_tpu_torch.core.config import load_config_dir

    cfg = load_config_dir(cfg_dir)
    with open(os.path.join(next(iter(cfg.corpora.values())).preprocessed_path, split)) as f:
        return sum(1 for line in f if line.strip())


def dump_mels_path(smi, cfg_dir, root):
    """Phase [dump_mels]: `cli.dump_mels` on the card on `[trainer]`'s step 4
    and corpus (flagship width, batch 16, train.txt and val.txt): K1 exactly
    10 launches per batch, K2/K3 none; every mel within 2e-4 of the same
    dump on the plain path (`--no-use_flash`), identical names and lengths;
    K1's device time per batch from a profiler window. Returns (the kernels
    line's field, the mel dir)."""
    import numpy as np
    import torch

    from masg_tpu_torch.cli.dump_mels import main as dump_main

    n_batches = sum(-(-_split_count(cfg_dir, s) // 16) for s in ("train.txt", "val.txt"))
    args = ["-c", cfg_dir, "--restore_step", "4"]
    out_k, out_p = os.path.join(root, "mels"), os.path.join(root, "mels_plain")
    reset_counts()
    t0 = time.perf_counter()
    n = dump_main([*args, "--out", out_k])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert counts == {"K1": 10 * n_batches, "K2": 0, "K3": 0, "K4": 0}, (counts, n_batches)
    dump_main([*args, "--out", out_p, "--no-use_flash"])
    names = sorted(os.listdir(out_k))
    assert names == sorted(os.listdir(out_p)) and len(names) > 0
    err, frames = 0.0, 0
    for name in names:
        a, b = np.load(os.path.join(out_k, name)), np.load(os.path.join(out_p, name))
        assert a.shape == b.shape and np.isfinite(a).all(), name
        err = max(err, float(np.abs(a - b).max()))
        frames += a.shape[0]
    k1_dev = device_ms(lambda: dump_main([*args, "--out", os.path.join(root, "mels_prof")]),
                       1, "flash_fwd") / n_batches
    print(f"[dump_mels] cli.dump_mels on the card, step 4 of [trainer]: {n} mels ({len(names)} "
          f"files, {frames} frames) in {n_batches} batches of <= 16, {wall:.2f} s wall (model "
          f"build and checkpoint load included); launches {counts} = 10 K1 per batch; kernel vs "
          f"plain path max|mel err| {err:.3g} (tol 2e-4), lengths identical; K1 device time "
          f"{k1_dev:.3f} ms per batch; on {smi}")
    assert err <= 2e-4, err
    return {"launches": counts["K1"], "batches": n_batches, "launches_per_batch": 10,
            "device_ms_per_batch": k1_dev}, out_k


def vocoder_finetune_path(smi, root, mel_dir):
    """Phase [vocoder_finetune]: `cli.train_vocoder --mel_dir` on the card on
    `[dump_mels]`' mels and wavs written for `[trainer]`'s corpus (a sine
    plus noise per utterance, mel_len x 256 samples), at V1 width, segment
    8192, batch 16, 4 steps from a seeded V1 generator (warm start), saves at
    2 and 4; a run restored at step 2 repeats steps 3-4 within 1e-5
    relative; `generator_4.pth.tar` through `get_vocoder(fused_mrf=True)`
    (K4, 2 launches) against `fused_mrf=False` on a dumped mel within 2 LSB."""
    import numpy as np
    import torch

    from masg_tpu_torch.audio.wavio import write_wav
    from masg_tpu_torch.cli.train_vocoder import main as voc_main
    from masg_tpu_torch.core.config import ModelConfig
    from masg_tpu_torch.infer.vocoder import get_vocoder, vocoder_infer
    from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights

    rng = np.random.default_rng(3)
    wav_dir = os.path.join(root, "wavs")
    names = sorted(os.listdir(mel_dir))
    for name in names:
        spk, base = name[:-len(".npy")].split("-mel-")
        n = np.load(os.path.join(mel_dir, name)).shape[0] * HOP
        os.makedirs(os.path.join(wav_dir, spk), exist_ok=True)
        write_wav(os.path.join(wav_dir, spk, base + ".wav"), 0.6 * sine_batch(rng, 1, n)[0],
                  SAMPLE_RATE)
    warm = os.path.join(root, "g_seeded.pth.tar")
    gen = HiFiGANGenerator()
    init_random_weights(gen, torch.Generator().manual_seed(1))
    torch.save({"generator": gen.state_dict()}, warm)
    common = ["--wav_dir", wav_dir, "--mel_dir", mel_dir, "--batch_size", "16", "--steps", "4",
              "--save_step", "2", "--log_step", "1"]
    out1, out2 = os.path.join(root, "voc"), os.path.join(root, "voc_resumed")
    reset_counts()
    t0 = time.perf_counter()
    voc_main([*common, "--out", out1, "--warm_start_generator", warm])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert read_counts()["K4"] == 0
    voc_main([*common, "--out", out2, "--restore", os.path.join(out1, "vocoder_2.pth.tar")])
    logs = []
    for out in (out1, out2):
        with open(os.path.join(out, "log.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    assert [r["step"] for r in logs[0]] == [1, 2, 3, 4], logs[0]
    assert [r["step"] for r in logs[1]] == [3, 4], logs[1]
    keys = ("disc_loss", "gen_loss", "mel_l1", "fm")
    assert all(math.isfinite(r[k]) for r in logs[0] for k in keys)
    err = max(abs(b[k] - a[k]) / abs(a[k]) for a, b in zip(logs[0][2:], logs[1]) for k in keys)
    print(f"[vocoder_finetune] cli.train_vocoder --mel_dir, V1, B=16 x 8192, {len(names)} "
          f"pairs: 4 steps in {wall:.1f} s wall (build and warm start included), step 4 "
          f"{[round(logs[0][3][k], 4) for k in keys]} (disc, gen, mel_l1, fm); restored at "
          f"step 2: steps 3-4 max relative err {err:.3g} (tol 1e-5); on {smi}")
    assert err <= 1e-5, (logs, err)

    ckpt = os.path.join(out1, "generator_4.pth.tar")
    voc_k = get_vocoder(ModelConfig(), checkpoint=ckpt, fused_mrf=True)
    voc_p = get_vocoder(ModelConfig(), checkpoint=ckpt, fused_mrf=False)
    mel = torch.from_numpy(np.load(os.path.join(mel_dir, names[0])))[None].to(DEVICE)
    reset_counts()
    wk = vocoder_infer(mel, voc_k)[0]
    torch.cuda.synchronize()
    launches = read_counts()["K4"]
    wp = vocoder_infer(mel, voc_p)[0]
    lsb = int(np.abs(wk.astype(np.int32) - wp.astype(np.int32)).max())
    peak = int(np.abs(wp.astype(np.int32)).max())
    print(f"[vocoder_finetune] generator_4.pth.tar through get_vocoder: K4 vs plain MRF on a "
          f"dumped mel of {mel.shape[1]} frames: {lsb} LSB (tol 2; peak {peak}), K4 launches "
          f"{launches} per forward")
    assert launches == 2 and lsb <= 2 and peak > 100, (launches, lsb, peak)
    return {"launches_per_forward": launches, "max_lsb_vs_plain": lsb}


def preprocess_path(smi, root):
    """Phase [preprocess]: `cli.preprocess` on a `make_synthetic_corpus` raw
    corpus (2 speakers x 4 utterances) on the card and with `--device cpu`,
    `random` seeded alike: the same files and splits, identical duration and
    pitch arrays (F0 on the host, the C++ extension, which holds masg_tpu's
    bar against the numpy DIO on one utterance), mel (linear) and energy
    within 1e-5 of each file's peak, log-mel within 1e-3, stats.json within
    1e-5 relative. Then the speed, on a corpus of realistic size (4 speakers
    x 48 utterances of 24-40 phones, ~3-5 s each, JSUT's ~4 s average): ms
    per utterance on the card and with `--device cpu`, each split into its
    parts (`Preprocessor.seconds`: reads, host F0, features, writes,
    normalization); and on the card the features' first call at a new
    length (cuFFT's plan cache emptied) against a repeated call."""
    import random

    import numpy as np

    from masg_tpu_torch.audio.f0 import dio
    from masg_tpu_torch.audio.f0_native import dio_native
    from masg_tpu_torch.audio.wavio import read_wav
    from masg_tpu_torch.cli.preprocess import main as preprocess_main
    from masg_tpu_torch.data.synthetic import make_synthetic_corpus, write_config_dir

    # g++ builds the F0 extension at first use: build it before the timed runs
    t0 = time.perf_counter()
    dio_native(np.zeros(4096), SAMPLE_RATE)
    print(f"[preprocess] the native F0 extension built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    pres, walls = {}, {}
    for dev in ("cuda", "cpu"):
        raw, pre, _ = make_synthetic_corpus(os.path.join(root, dev), n_speakers=2,
                                            utts_per_speaker=4, seed=3)
        cfg_dir = write_config_dir(os.path.join(root, dev, "cfg"), pre,
                                   os.path.join(root, dev, "out"), raw_path=raw)
        random.seed(0)
        t0 = time.perf_counter()
        preprocess_main(["--config", cfg_dir, "--device", dev])
        walls[dev] = time.perf_counter() - t0
        pres[dev] = pre
    a, b = pres["cuda"], pres["cpu"]
    for split in ("train.txt", "val.txt", "test.txt"):
        with open(os.path.join(a, split)) as fa, open(os.path.join(b, split)) as fb:
            assert fa.read() == fb.read(), split
    errs = {"mel": 0.0, "log-mel": 0.0, "energy": 0.0}
    n_utts = 0
    for kind in ("duration", "pitch", "mel", "energy"):
        names = sorted(os.listdir(os.path.join(a, kind)))
        assert names == sorted(os.listdir(os.path.join(b, kind))) and len(names) == 8, kind
        n_utts = len(names)
        for name in names:
            x, r = np.load(os.path.join(a, kind, name)), np.load(os.path.join(b, kind, name))
            assert x.shape == r.shape and x.dtype == r.dtype, (kind, name)
            if kind in ("duration", "pitch"):
                assert np.array_equal(x, r), (kind, name)
            elif kind == "mel":
                ex, er = np.exp(x), np.exp(r)
                errs["mel"] = max(errs["mel"], float(np.abs(ex - er).max() / np.abs(er).max()))
                errs["log-mel"] = max(errs["log-mel"],
                                      float(np.abs(x - r).max() / np.abs(r).max()))
            else:
                errs[kind] = max(errs[kind], float(np.abs(x - r).max() / np.abs(r).max()))
    with open(os.path.join(a, "stats.json")) as fa, open(os.path.join(b, "stats.json")) as fb:
        sa, sb = json.load(fa), json.load(fb)
    stat_err = max(abs(x - r) / max(abs(r), 1e-30)
                   for k in ("pitch", "energy") for x, r in zip(sa[k], sb[k]))
    wav, sr = read_wav(os.path.join(root, "cpu", "raw_data", "SYNTH", "spk00",
                                    "spk00_utt00.wav"))
    frame_period = HOP / SAMPLE_RATE * 1000
    nat, (ref, _) = dio_native(wav, sr, frame_period), dio(wav, sr, frame_period)
    agree = float(np.mean((nat > 0) == (ref > 0)))
    both = (nat > 0) & (ref > 0)
    f0_err = float(np.max(np.abs(nat[both] - ref[both]) / ref[both]))
    print(f"[preprocess] cli.preprocess, 2 speakers x {n_utts // 2} utterances: card "
          f"{walls['cuda']:.2f} s, --device cpu {walls['cpu']:.2f} s (start-up included: the "
          f"speed is measured below); splits, "
          f"files, duration and pitch identical; mel {errs['mel']:.3g} (log-mel "
          f"{errs['log-mel']:.3g}), energy {errs['energy']:.3g} of the peak (tol 1e-5, 1e-3, "
          f"1e-5); stats.json {stat_err:.3g} (tol 1e-5); native vs numpy DIO: voiced decisions "
          f"agree on {agree:.3f} (> 0.97), F0 {f0_err:.3g} (< 5e-3); on {smi}")
    assert errs["mel"] <= 1e-5 and errs["energy"] <= 1e-5 and errs["log-mel"] <= 1e-3, errs
    assert stat_err <= 1e-5 and agree > 0.97 and f0_err < 5e-3, (stat_err, agree, f0_err)
    return preprocess_speed(smi, root)


def preprocess_speed(smi, root):
    """`cli.preprocess` ms per utterance by part, card and CPU, on 192
    utterances of ~4 s; the card's features at new and repeated lengths."""
    import random

    import numpy as np
    import torch

    from masg_tpu_torch.audio.stft import mel_spectrogram_and_energy
    from masg_tpu_torch.cli.preprocess import main as preprocess_main
    from masg_tpu_torch.data.synthetic import make_synthetic_corpus, write_config_dir

    speed = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        raw, pre, _ = make_synthetic_corpus(os.path.join(root, "speed_" + dev), n_speakers=4,
                                            utts_per_speaker=48, seed=5, n_phones=(24, 40))
        t_corpus = time.perf_counter() - t0
        cfg_dir = write_config_dir(os.path.join(root, "speed_" + dev, "cfg"), pre,
                                   os.path.join(root, "speed_" + dev, "out"), raw_path=raw)
        if dev == "cuda":
            torch.backends.cuda.cufft_plan_cache.clear()
        random.seed(0)
        p = next(iter(preprocess_main(["--config", cfg_dir, "--device", dev]).values()))
        n = p.n_utterances
        frames = sum(np.load(os.path.join(pre, "mel", f)).shape[0]
                     for f in os.listdir(os.path.join(pre, "mel")))
        speed[dev] = {k: v / n * 1e3 for k, v in p.seconds.items()}
        speed[dev]["other"] = speed[dev]["total"] - sum(
            v for k, v in speed[dev].items() if k not in ("total",))
        speed[dev]["plans_cached"] = (torch.backends.cuda.cufft_plan_cache.size
                                      if dev == "cuda" else None)
        audio_s = frames * HOP / SAMPLE_RATE
        parts = ", ".join(f"{k} {v:.2f}" for k, v in speed[dev].items()
                          if k not in ("total", "plans_cached"))
        print(f"[preprocess] speed, --device {dev}: {n} utterances, {audio_s:.1f} s of audio "
              f"kept ({audio_s / n:.2f} s each; corpus written in {t_corpus:.2f} s, not "
              f"counted): {speed[dev]['total']:.2f} ms per utterance ({parts}); cuFFT plans "
              f"cached after it: {speed[dev]['plans_cached']}; on {smi}")
        assert n >= 180, n  # an utterance with at most one voiced frame is skipped

    # the features alone on the card: the first call at each of 64 new frame counts
    # (cuFFT's plan cache emptied) against a second call at the same count
    torch.backends.cuda.cufft_plan_cache.clear()
    rng = np.random.default_rng(6)
    new, again = [], []
    with torch.inference_mode():
        for i in range(64):
            x = torch.from_numpy((0.3 * rng.normal(size=HOP * (250 + 3 * i) + 17))
                                 .astype(np.float32)).cuda()
            for times in (new, again):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mel, energy = mel_spectrogram_and_energy(x)
                mel.cpu(), energy.cpu()
                times.append(time.perf_counter() - t0)
    speed["cuda_features_new_length_ms"] = float(np.mean(new) * 1e3)
    speed["cuda_features_repeated_length_ms"] = float(np.mean(again) * 1e3)
    print(f"[preprocess] features on the card, 64 frame counts of 251-440 (~3-5 s): first "
          f"call at a new count {speed['cuda_features_new_length_ms']:.3f} ms, repeated "
          f"{speed['cuda_features_repeated_length_ms']:.3f} ms (mean); on {smi}")
    return speed


def jdit_config(width=None):
    """The flagship config with the JDIT teacher at the reference dims (1024 /
    1024, prenet 256, attention 128, location 32 x 31), or `width`'s
    (model.yaml overrides: a tiny config for the card-vs-CPU check)."""
    cfg = flagship_config()
    cfg.model.jdit.use_jdit = True
    for section, values in (width or {}).items():
        for k, v in values.items():
            setattr(getattr(cfg.model, section), k, v)
    return cfg


def jdit_state(cfg, kernels, device=None, dropout=False):
    """A fresh `use_jdit` train state on `device` from seed 0 (the same
    weights on both paths), its step, and the model; every dropout off
    unless `dropout`."""
    import torch

    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import make_train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FastSpeech2.from_config(cfg, use_flash=kernels)
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        dec = model.jdit.decoder
        dec.prenet.p = dec.p_attention_dropout = dec.p_decoder_dropout = 0.0
    model.to(device or DEVICE)
    st = create_train_state(model, cfg.train.optimizer, cfg.model.transformer.encoder_hidden)
    return st, make_train_step(model, use_jdit=True)


JDIT_TINY = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                             "decoder_hidden": 64, "conv_filter_size": 128},
             "variance_predictor": {"filter_size": 64},
             "jdit": {"attention_rnn_dim": 32, "decoder_rnn_dim": 24, "prenet_hidden": 16,
                      "attention_dim": 16, "location_filters": 8, "location_kernel": 5}}


def jdit_path(smi, root):
    """Phase [jdit]: the `use_jdit` train step (FastSpeech2 at the flagship
    width + the JDIT teacher at the reference dims) on [train]'s batch, f32:
    kernel vs plain path with dropout off (losses, every gradient, the
    teacher's included), exactly 10 launches each of K1-K3 per step, ms per
    step on both paths (medians, in turns), a profiler window over one
    kernel-path step (device ops, idle share, K1-K3 device time, heaviest
    ops), peak memory; the tiny width card vs CPU after 3 steps; then
    `cli.make_config JSUT --use_jdit` pointed at a synthetic corpus,
    `cli.train` 2 steps and `cli.evaluate` on the card. Returns {kernel:
    {launches, device_ms_per_step}} of the step."""
    import shutil

    import torch
    import yaml
    from torch.profiler import ProfilerActivity, profile

    from masg_tpu_torch.cli.evaluate import main as evaluate_main
    from masg_tpu_torch.cli.make_config import main as make_config
    from masg_tpu_torch.cli.train import main as train_main
    from masg_tpu_torch.data.synthetic import write_preprocessed_corpus
    from masg_tpu_torch.train.step import batch_to_device

    cfg = jdit_config()
    db = batch_to_device(example_inputs(B=B, L=L, T=T_MEL), DEVICE, torch.float32)
    sides = {}
    for kernels in (True, False):
        st, step = jdit_state(cfg, kernels)
        total, losses, eloss, _, out = step.loss_fn(st.model, db, 0, seed=0)
        mse = total - losses.total
        total.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in st.model.named_parameters()
                 if p.grad is not None}
        vals = [float(x.detach()) for x in (total, *losses, eloss, mse)]
        sides[kernels] = (st, step, vals, grads)
    (sk, stepk, lk, gk), (sp, stepp, lp, gp) = sides[True], sides[False]
    n_teacher = sum(1 for n in gk if n.startswith("jdit."))
    assert gk.keys() == gp.keys() and n_teacher > 0
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lk, lp))
    grad_err = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    teacher_err = max((gk[n] - gp[n]).abs().max().item() for n in gk if n.startswith("jdit."))
    n_params = sum(p.numel() for p in sk.model.jdit.parameters())
    print(f"[jdit] float32 kernel vs plain path, dropout off: losses (total, mel, postnet, "
          f"pitch, energy, duration, eloss, teacher mse) {[round(x, 5) for x in lk]}, max "
          f"relative err {loss_err:.3g} (tol 1e-5); max|grad err| {grad_err:.3g} over "
          f"{len(gk)} tensors, the teacher's {n_teacher} ({n_params / 1e6:.2f}M parameters) "
          f"{teacher_err:.3g} (tol 2e-3)")
    assert loss_err <= 1e-5 and grad_err <= 2e-3, (loss_err, grad_err)

    # launches and time per step through the entry point, dropout on
    paths = {k: jdit_state(cfg, k, dropout=True) for k in (True, False)}
    del sides, sk, sp, stepk, stepp, gk, gp
    reset_counts()
    st, step = paths[True]
    st, m = step(st, db, 0)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts == {"K1": 10, "K2": 10, "K3": 10, "K4": 0}, counts
    assert torch.isfinite(m.total) and torch.isfinite(m.grad_norm)
    paths[False][1](paths[False][0], db, 0)  # the plain path's warm-up
    walls = {True: [], False: []}
    for r in range(4):
        for kernels in ((True, False) if r % 2 == 0 else (False, True)):
            st, step = paths[kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, db, 1 + r)
            torch.cuda.synchronize()
            walls[kernels].append(time.perf_counter() - t0)
            assert torch.isfinite(m.total), kernels
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    print(f"[jdit] use_jdit step, float32: kernel path {med[True]:.1f} ms/step, plain path "
          f"{med[False]:.1f} ms/step (medians of 4 after 1 warm-up, in turns; walls "
          f"{[round(x * 1e3, 1) for x in walls[True]]} / "
          f"{[round(x * 1e3, 1) for x in walls[False]]} ms) on {smi}")

    st, step = paths[True]
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(st, db, 9)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    assert kern, "the profiler saw no device work"
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
    fields = {}
    for name, match in (("K1", "flash_fwd"), ("K2", "flash_dq"), ("K3", "flash_dkv")):
        dev = sum(e.time_range.end - e.time_range.start for e in kern if match in e.name) / 1e3
        fields[name] = {"step": "use_jdit, float32", "launches": counts[name],
                        "device_ms_per_step": dev}
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    print(f"[profile] use_jdit kernel path, one step: wall {wall:.1f} ms (profiled), device "
          f"busy {busy:.1f} ms ({100 * (1 - busy / wall):.1f} % idle), {len(kern)} device "
          f"ops; K1 {fields['K1']['device_ms_per_step']:.3f}, K2 "
          f"{fields['K2']['device_ms_per_step']:.3f}, K3 "
          f"{fields['K3']['device_ms_per_step']:.3f} ms; peak memory {peak:.2f} GiB; against "
          f"the unprofiled median step ({med[True]:.1f} ms) {100 * (1 - busy / med[True]):.1f} "
          f"% idle; on {smi}")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
        print(f"[profile]   {t / 1e3:8.3f} ms/step  {name[:100]}")
    del paths, st, step

    # the tiny width, card (K1-K3) vs CPU (plain versions), 3 steps
    tiny = jdit_config(JDIT_TINY)
    batches = [example_inputs(B=4, L=16, T=64, seed=s) for s in range(3)]
    losses = {}
    for device in (DEVICE, "cpu"):
        st, step = jdit_state(tiny, True, device=device)
        losses[device] = []
        for i, b in enumerate(batches):
            st, m = step(st, batch_to_device(b, device, torch.float32), i)
            losses[device].append(float(m.total))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[DEVICE], losses["cpu"]))
    print(f"[jdit] tiny width, 3 steps, card vs CPU (dropout off): losses "
          f"{[round(x, 6) for x in losses[DEVICE]]} vs {[round(x, 6) for x in losses['cpu']]}, "
          f"max relative err {rel:.3g} (tol 1e-5)")
    assert rel <= 1e-5, losses

    # cli.make_config JSUT --use_jdit -> a synthetic corpus -> cli.train, cli.evaluate
    pre = write_preprocessed_corpus(os.path.join(root, "jdit_pre"), n_utts=32, n_speakers=4,
                                    n_val=4, phones=(16, 48), frames_per_phone=(1, 4))
    cfg_dir = os.path.join(root, "jdit_cfg")
    make_config(["JSUT", "-o", cfg_dir, "--use_jdit"])
    with open(os.path.join(cfg_dir, "preprocess_JSUT.yaml")) as f:
        corpus = yaml.safe_load(f)
    corpus["path"]["preprocessed_path"] = pre
    corpus["accent"]["use_accent"] = False  # the synthetic corpus has no accent files
    with open(os.path.join(cfg_dir, "train.yaml")) as f:
        train = yaml.safe_load(f)
    train["path"] = {k: os.path.join(root, "jdit_out", k) for k in train["path"]}
    train["step"].update(save_step=2, val_step=1000, log_step=1)
    for name, body in (("preprocess_JSUT.yaml", corpus), ("train.yaml", train)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.safe_dump(body, f, sort_keys=False)
    for name in ("stats.json", "speakers.json"):
        shutil.copy(os.path.join(pre, name), cfg_dir)
    reset_counts()
    t0 = time.time()
    state = train_main(["-c", cfg_dir, "--max_steps", "2"])
    torch.cuda.synchronize()
    counts = read_counts()
    assert state.step == 2 and state.model.jdit is not None
    assert counts == {"K1": 20, "K2": 20, "K3": 20, "K4": 0}, counts
    t_train = time.time() - t0
    means = evaluate_main(["-c", cfg_dir, "--restore_step", "2"])
    again = evaluate_main(["-c", cfg_dir, "--restore_step", "2"])
    assert len(means) == 6 and all(math.isfinite(x) for x in means), means
    rel = max(abs(a - b) / abs(b) for a, b in zip(means, again))
    print(f"[jdit] cli.make_config JSUT --use_jdit -> cli.train: 2 steps in {t_train:.1f} s "
          f"(launches {counts}); cli.evaluate on step 2: total loss {means[0]:.4f}, a second "
          f"evaluate within {rel:.3g} relative (tol 1e-5: the teacher's eval masks are "
          f"seeded)")
    assert rel <= 1e-5, (means, again)
    return fields


def melgan_path(smi):
    """Phase [melgan]: text->wav at B = 16 through the default MelGAN (seeded
    random weights) behind the f32 flagship FastSpeech2: K1 exactly 10 and K4
    0 launches per forward; the kernel path against the plain path (mel_len
    identical, wav within 2 LSB); RTF and vocoder ms (medians of 3, in turns);
    `vocode_streaming` of one utterance against its one-shot vocode within 1
    LSB; one `ServingEngine` dispatch with the MelGAN vocoder. Returns the
    launches per forward."""
    import numpy as np
    import torch

    from masg_tpu_torch.infer.serving import ServingEngine
    from masg_tpu_torch.infer.vocoder import (measure_receptive_field_frames,
                                              vocode_streaming, vocoder_infer)
    from masg_tpu_torch.models.melgan import MelGANGenerator

    cfg = flagship_config()
    cfg.model.vocoder.model = "MelGAN"
    batch = example_inputs(B=B, L=L, T=T_MEL)
    paths = {k: build_path(cfg, torch.float32, k) for k in (True, False)}
    assert isinstance(paths[True][1].generator, MelGANGenerator)
    with torch.inference_mode():
        reset_counts()
        outk, wk = text_to_wav(*paths[True], batch)
        torch.cuda.synchronize()
        counts = read_counts()
        outp, wp = text_to_wav(*paths[False], batch)
    assert counts == {"K1": 10, "K2": 0, "K3": 0, "K4": 0}, counts
    assert torch.equal(outk.mel_len, outp.mel_len) and int(outk.mel_len.min()) > 0
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) for a, b in zip(wk, wp))
    level = max(int(np.abs(w.astype(np.int32)).max()) for w in wk)
    print(f"[melgan] text->wav B={B}, float32, default MelGAN (seeded): launches per forward "
          f"{counts}; kernel vs plain mel_len identical, wav max {lsb} LSB (tol 2), peak "
          f"|sample| {level}")
    assert lsb <= 2 and level > 100

    from masg_tpu_torch.infer.synthesis import synthesize_batch

    walls = {(k, part): [] for k in (True, False) for part in ("text2wav", "vocoder")}
    with torch.inference_mode():
        for k in (True, False):
            text_to_wav(*paths[k], batch)
        for r in range(3):
            for k in ((True, False) if r % 2 == 0 else (False, True)):
                model, vocoder = paths[k]
                walls[(k, "text2wav")].append(timed(lambda: text_to_wav(model, vocoder,
                                                                        batch))[0])
                out = synthesize_batch(model, batch, max_mel_len=T_MEL)
                walls[(k, "vocoder")].append(timed(lambda: vocoder(out.postnet_mel))[0])
    audio_s = int(outk.mel_len.sum()) * HOP / SAMPLE_RATE  # [rtf]'s: the frames synthesized
    med = {key: statistics.median(v) for key, v in walls.items()}
    for k in (True, False):
        print(f"[melgan] {'kernel' if k else 'plain'} path: text->wav "
              f"{med[(k, 'text2wav')] * 1e3:.1f} ms (RTF {audio_s / med[(k, 'text2wav')]:.1f}x "
              f"on {audio_s:.1f} s of audio), MelGAN vocoder {med[(k, 'vocoder')] * 1e3:.1f} ms "
              f"(medians of 3, in turns) on {smi}")

    model, vocoder = paths[True]
    with torch.inference_mode():
        mel = outk.postnet_mel[:1, : int(outk.mel_len[0])]
        full = vocoder_infer(mel, vocoder)[0]
        field = measure_receptive_field_frames(vocoder)
        stream = np.concatenate(list(vocode_streaming(vocoder, mel, chunk_frames=128)))
    s_lsb = int(np.abs(stream.astype(np.int32) - full.astype(np.int32)).max())
    print(f"[melgan] vocode_streaming of {mel.shape[1]} frames (receptive field {field} "
          f"frames, chunks of 128): {s_lsb} LSB from one-shot (tol 1)")
    assert stream.shape == full.shape and s_lsb <= 1

    engine = ServingEngine(cfg, state_dict=model.state_dict(), vocoder=vocoder,
                           text_buckets=(128,), device=DEVICE)
    ids = [int(x) for x in batch["texts"][0, : batch["src_lens"][0]]]
    engine.synthesize(ids)  # warm-up
    reset_counts()
    t, r = timed(lambda: engine.synthesize(ids))
    counts_srv = read_counts()
    assert counts_srv == {"K1": 10, "K2": 0, "K3": 0, "K4": 0}, counts_srv
    assert r["wav"].dtype == np.int16 and r["wav"].shape == (r["mel_len"] * HOP,)
    assert r["mel_len"] > 0
    print(f"[melgan] ServingEngine dispatch with MelGAN, bucket 128, B = 1: mel_len "
          f"{r['mel_len']}, {t * 1e3:.1f} ms, launches {counts_srv}")
    return counts


# upstream HiFi-GAN's universal V2 (jik876/hifi-gan config_v2.json): 128
# initial channels, so its four MRF stages run at C = 64, 32, 16 and 8
V2_CONFIG = {
    "resblock": "1", "num_gpus": 0, "batch_size": 16, "learning_rate": 0.0002,
    "adam_b1": 0.8, "adam_b2": 0.99, "lr_decay": 0.999, "seed": 1234,
    "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "segment_size": 8192, "num_mels": 80, "num_freq": 1025, "n_fft": 1024, "hop_size": 256,
    "win_size": 1024, "sampling_rate": 22050, "fmin": 0, "fmax": 8000, "fmax_for_loss": None,
}


def device_ms_by_kernel(fn, pattern, want, iters=3):
    """{template argument: device ms per launch} of the kernels whose name
    matches `pattern` (a regex with one group), averaged over the launches a
    torch.profiler window over `iters` calls of fn() recorded after a
    warm-up (CUPTI may drop records, so the mean is over those it kept). A
    window that misses one of the arguments in `want` is taken again, up to
    three times."""
    import re

    for _ in range(3):
        spans = {}
        for e in device_events(fn, iters):
            m = re.search(pattern, e.name)
            if m:
                spans.setdefault(m.group(1), []).append(
                    (e.time_range.end - e.time_range.start) / 1e3)
        if set(want) <= set(spans):
            return {k: statistics.mean(v) for k, v in spans.items()}
    raise AssertionError(f"the profiler saw {sorted(spans)} of {sorted(want)} ({pattern!r})")


def v2_path(smi, root):
    """Phase [v2]: text->wav at B = 16 through upstream's universal V2
    generator (config_v2.json's values as a hifigan_config.json, seeded random
    weights) behind the f32 flagship FastSpeech2: K1 exactly 10 and K4 4
    launches per forward (every MRF stage, C = 64, 32, 16, 8); the kernel path
    against the plain path (mel_len identical, wav within 2 LSB); RTF and
    vocoder ms (medians of 3, in turns); K4's device time per stage. Returns
    the kernels-line field."""
    import numpy as np
    import torch

    from masg_tpu_torch.infer.synthesis import synthesize_batch

    cfg = flagship_config()
    cfg_dir = os.path.join(root, "v2")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "hifigan_config.json"), "w") as f:
        json.dump(V2_CONFIG, f)
    batch = example_inputs(B=B, L=L, T=T_MEL)
    paths = {k: build_path(cfg, torch.float32, k, cfg_dir) for k in (True, False)}
    gen = paths[True][1].generator
    assert gen.conv_pre.out_channels == 128 and len(gen.resblocks) == 12
    with torch.inference_mode():
        reset_counts()
        outk, wk = text_to_wav(*paths[True], batch)
        torch.cuda.synchronize()
        counts = read_counts()
        outp, wp = text_to_wav(*paths[False], batch)
    assert counts == {"K1": 10, "K2": 0, "K3": 0, "K4": 4}, counts
    assert torch.equal(outk.mel_len, outp.mel_len) and int(outk.mel_len.min()) > 0
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) for a, b in zip(wk, wp))
    level = max(int(np.abs(w.astype(np.int32)).max()) for w in wk)
    print(f"[v2] text->wav B={B}, float32, universal V2 (seeded): launches per forward "
          f"{counts}; kernel vs plain mel_len identical, wav max {lsb} LSB (tol 2), peak "
          f"|sample| {level}")
    assert lsb <= 2 and level > 100

    walls = {(k, part): [] for k in (True, False) for part in ("text2wav", "vocoder")}
    with torch.inference_mode():
        mel = synthesize_batch(paths[True][0], batch, max_mel_len=T_MEL).postnet_mel
        for r in range(3):
            for k in ((True, False) if r % 2 == 0 else (False, True)):
                model, vocoder = paths[k]
                walls[(k, "text2wav")].append(timed(lambda: text_to_wav(model, vocoder,
                                                                        batch))[0])
                walls[(k, "vocoder")].append(timed(lambda: vocoder(mel))[0])
        per_stage = device_ms_by_kernel(lambda: paths[True][1](mel), r"mrf_kernel<(\d+)>",
                                        ("64", "32", "16", "8"))
    audio_s = int(outk.mel_len.sum()) * HOP / SAMPLE_RATE
    med = {key: statistics.median(v) * 1e3 for key, v in walls.items()}
    for k in (True, False):
        print(f"[v2] {'kernel' if k else 'plain'} path: text->wav {med[(k, 'text2wav')]:.1f} ms "
              f"(RTF {audio_s / med[(k, 'text2wav')] * 1e3:.1f}x on {audio_s:.1f} s of audio), "
              f"V2 vocoder {med[(k, 'vocoder')]:.1f} ms (medians of 3, in turns) on {smi}")
    stages = {int(c): per_stage[c] for c in sorted(per_stage, key=int, reverse=True)}
    assert sorted(stages) == [8, 16, 32, 64], stages
    print(f"[v2] K4 device ms per stage (C: ms) {stages}, {sum(stages.values()):.3f} ms a "
          f"forward")
    return {"path": "text->wav, universal V2, float32", "launches_per_forward": counts["K4"],
            "k1_launches_per_forward": counts["K1"],
            "k4_device_ms_per_stage": stages, "text2wav_ms": med[(True, "text2wav")],
            "plain_text2wav_ms": med[(False, "text2wav")], "vocoder_ms": med[(True, "vocoder")],
            "plain_vocoder_ms": med[(False, "vocoder")],
            "rtf": audio_s / med[(True, "text2wav")] * 1e3}


# masg_tpu's seven demo checks: the mechanics of the pipeline, which the port
# must give whatever its random numbers, and the learning gates, outcomes of
# one seeded run (scripts/demo_full_pipeline.py:171, 196, 378, 406)
DEMO_MECHANICS = ("clf_bce_logged_finite_positive", "clf_liveness_delta_above_1e-6",
                  "copy_synthesis_mcd_reported")
DEMO_LEARNING = ("ge2e_loss_falls", "ge2e_eer_below_0.35", "wav_peak_median_at_least_0.1",
                 "f0_score_median_in_(0.05,0.95)")


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    return math.isfinite(float(value))


# the one cut of the demo's budgets: at masg_tpu's 4000 vocoder steps the
# phase took 474-500 s on the card (the steps 328-344 s of it), over 6
# minutes; 1000 steps, where masg_tpu's audibility probe has the amplitude
# track the ground truth (scripts/probe_vocoder_audibility.py), pass the
# audibility gate (median peak >= 0.1 of full scale)
DEMO_VOCODER_STEPS = 1000


def demo_path(smi, root):
    """Phase [demo]: `masg_tpu_torch.demo.full_pipeline` on the card at
    masg_tpu's defaults (4 speakers x 20 utterances, 800 + 400 FastSpeech2
    steps, 40 GE2E epochs) but for `DEMO_VOCODER_STEPS`. Asserts the pipeline's
    mechanics: every stage ran, K1-K3 alike in both FastSpeech2 trainings and
    K4 in none, K4 4 a vocoder forward (16 in copy synthesis, 24 in the
    wavs), every evidence value finite, and masg_tpu's three mechanical
    checks (BCE logged, finite, > 0; the lambda 0 vs 1000 delta > 1e-6; the
    copy-synthesis MCD); prints its four learning gates with their values
    (`full_pipeline.main`, the demo's command, asserts all seven), and the
    copy synthesis of `demo.probe` (the vocoder's RMS, full-scale share and
    F0 against the ground truth's, where the F0 check fails). Returns the
    kernels-line field."""
    from masg_tpu_torch.demo import full_pipeline, probe

    t0 = time.time()
    result = full_pipeline.run(os.path.join(root, "demo"), vocoder_steps=DEMO_VOCODER_STEPS,
                               device="cuda")
    wall = time.time() - t0
    for name, t, n in result["stages"]:
        print(f"[demo] +{t:7.1f} s {name}: launches {n}")
    checks = result["checks"]
    assert sorted(checks) == sorted(DEMO_MECHANICS + DEMO_LEARNING), sorted(checks)
    for k in DEMO_MECHANICS + DEMO_LEARNING:
        ok, v = checks[k]
        kind = "mechanics" if k in DEMO_MECHANICS else "learning gate"
        print(f"[demo] check {k} ({kind}): {'holds' if ok else 'FAILS'} ({v})")
    print(f"[demo] evidence {json.dumps(result['evidence'])}")
    print(f"[demo] the full pipeline in {wall:.1f} s on {smi}")
    out = os.path.join(root, "demo")
    copy = probe.copy_synthesis_rows(
        os.path.join(out, "vocoder", f"generator_{DEMO_VOCODER_STEPS}.pth.tar"),
        full_pipeline.S.DEMO_HIFIGAN, probe.speaker_map(out), "cuda")
    for spk, r in sorted(copy.items()):
        print(f"[demo] copy synthesis (demo.probe), {spk}: RMS {r['rms']:.3f} against the ground "
              f"truth's {r['gt_rms']:.3f}, {100 * r['full_scale_share']:.1f} % of samples at full "
              f"scale, F0 {r['f0']:.1f} Hz against {r['gt_f0']:.1f} (0: unvoiced)")
    assert len(result["stages"]) == 11 and _finite(result["evidence"]), result["evidence"]
    by_stage = [n for _, _, n in result["stages"]]
    pretrain, clf, voc_train, copy_syn, wavs = (by_stage[i] for i in (4, 5, 6, 7, 9))
    for n in (pretrain, clf):
        assert n["K1"] == n["K2"] == n["K3"] > 0 and n["K4"] == 0, n
    assert voc_train["K4"] == 0 and copy_syn["K4"] == 4 * 4 and wavs["K4"] == 4 * 2 * 3, \
        (voc_train, copy_syn, wavs)
    assert all(checks[k][0] for k in DEMO_MECHANICS), {k: checks[k] for k in DEMO_MECHANICS}
    return {"path": f"demo.full_pipeline at masg_tpu's defaults, --vocoder_steps "
                    f"{DEMO_VOCODER_STEPS}", "seconds": wall,
            "checks": checks,
            "launches": {"fs2_pretrain": pretrain, "use_clf": clf, "copy_synthesis": copy_syn,
                         "demo_wavs": wavs}}


# ---------------------------------------------------------------------------
# [dp]: data parallelism over torch.distributed
# ---------------------------------------------------------------------------

DP_WORLD = 2  # two ranks sharing the one card over gloo (CUDA tensors)
DP_STEP_METRICS = ("total", "mel", "postnet_mel", "pitch", "energy", "duration",
                   "speaker_prior", "dloss")


def _no_dropout(model):
    import torch

    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _dp_fs2(variant, acc, disc):
    """A fresh flagship train state (seed 0, dropout off, kernel path) and its step."""
    import copy

    from masg_tpu_torch.train.step import make_train_step

    cfg = flagship_config()
    cfg.train.optimizer.grad_acc_step = acc
    if variant == "plain":
        st = train_state(cfg, True)
        _no_dropout(st.model)
        return st, make_train_step(st.model)
    return adversarial_state(cfg, "use_clf=model" if variant == "use_clf" else "ganlike",
                             True, copy.deepcopy(disc))


def _dp_ms(fn, n=3):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _dp_train(rank, world, variant, acc):
    """One train-step variant at the flagship width, B = 16 split over the
    ranks, against rank 0 alone on the global batch (the others wait at a
    barrier): the reduced gradients of one backward, the StepMetrics of 3
    updates (4 micro-steps at grad_acc_step 2), K1-K3 launches per rank per
    step, ms per step (mean of 2, after those) on 1 rank and on the ranks
    sharing the card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.parallel.mesh import DataMesh
    from masg_tpu_torch.train.step import batch_to_device

    batch = adversarial_batch() if variant != "plain" else example_inputs(B=B, L=L, T=T_MEL)
    torch.manual_seed(1)
    disc = SpeechEmbedder() if variant != "plain" else None
    mesh = DataMesh(world, rank).for_batch(B)
    assert mesh.sharded
    whole = batch_to_device(batch, DEVICE, torch.float32)
    mine = batch_to_device(mesh.shard_batch(batch), DEVICE, torch.float32)
    n_steps = 4 if acc == 2 else 3
    out = {}

    # the gradients of one backward: rank 0 alone on the whole batch, then
    # every rank on its rows, summed
    ref = None
    if rank == 0:
        st, step = _dp_fs2(variant, acc, disc)
        step.loss_fn(st.model, whole, 0)[0].backward()
        ref = [p.grad.clone() for p in st.params()]
        del st, step
    st, step = _dp_fs2(variant, acc, disc)
    step.loss_fn(st.model, mine, 0, mesh=mesh)[0].backward()
    mesh.reduce_grads(st.params())
    if rank == 0:
        worst, tensors = 0.0, 0
        for p, r in zip(st.params(), ref):
            g = p.grad if p.grad is not None else torch.zeros_like(r)
            worst = max(worst, float(((g - r).abs() - 1e-4 * r.abs()).max()))
            tensors += 1
        out["grad_excess"] = worst  # max(|g - r| - rtol |r|): within atol 5e-6
        out["grad_tensors"] = tensors
    del st, step, ref

    # the trajectories, then the times of 3 more steps
    if rank == 0:
        st, step = _dp_fs2(variant, acc, disc)
        ref_traj = []
        for i in range(n_steps):
            st, m = step(st, whole, i)
            ref_traj.append([float(getattr(m, k)) for k in DP_STEP_METRICS + ("grad_norm",)])
        out["ms_1rank"] = _dp_ms(lambda: step(st, whole, 9), n=2)
        out["ref"] = ref_traj
        del st, step
    torch.cuda.empty_cache()
    dist.barrier()
    st, step = _dp_fs2(variant, acc, disc)
    reset_counts()
    traj = []
    for i in range(n_steps):
        st, m = step(st, mine, i, mesh)
        traj.append([float(getattr(m, k)) for k in DP_STEP_METRICS + ("grad_norm",)])
    torch.cuda.synchronize()
    counts = read_counts()
    out["launches_per_step"] = {k: v / n_steps for k, v in counts.items()}
    out["traj"] = traj
    dist.barrier()
    out["ms_2ranks"] = _dp_ms(lambda: step(st, mine, 9, mesh), n=2)
    out["param_checksum"] = float(sum(p.detach().double().sum() for p in st.params()))
    del st, step
    torch.cuda.empty_cache()
    if rank == 0:
        ref_traj = np.asarray(out["ref"])
        got = np.asarray(traj)
        loss_rel = np.abs(got[:, :-1] - ref_traj[:, :-1]) / np.maximum(np.abs(ref_traj[:, :-1]),
                                                                       1e-30)
        out["loss_rel"] = float(loss_rel[ref_traj[:, :-1] != 0].max())
        out["grad_norm_rel"] = float((np.abs(got[:, -1] - ref_traj[:, -1]) /
                                      np.abs(ref_traj[:, -1])).max())
    return out


def _dp_ge2e(rank, world):
    """The GE2E trainer at masg_tpu's width, N x M = 32 x 10 chunks of 150
    frames split over the ranks, against rank 0 alone: (ge2e, da) losses of
    3 steps, dropout off; ms per step over steps 2-3 (the first builds
    cuDNN's LSTM plans)."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.parallel.mesh import DataMesh
    from masg_tpu_torch.train.ge2e import make_ge2e_train_step

    rng = np.random.default_rng(13)
    batches = [(rng.normal(size=(GE2E_N * GE2E_M, 150, 80)).astype(np.float32),
                np.repeat(np.arange(GE2E_N) % 2, GE2E_M).astype(np.float32)) for _ in range(3)]
    torch.manual_seed(1)
    base = _no_dropout(SpeechEmbedder())

    def run(mesh):
        init_state, step = make_ge2e_train_step(copy.deepcopy(base).to(DEVICE), GE2E_N, GE2E_M,
                                                mesh=mesh)
        st = init_state()
        losses = []
        for i, (mels, langs) in enumerate(batches):
            if i == 1:
                t0 = time.perf_counter()
            st, loss, da = step(st, mels, langs, i == 0)
            losses.append((float(loss), float(da)))  # the host fetch waits for the card
        return losses, (time.perf_counter() - t0) * 1e3 / 2

    out = {}
    if rank == 0:
        out["ref"], out["ms_1rank"] = run(None)
    dist.barrier()
    out["losses"], out["ms_2ranks"] = run(DataMesh(world, rank))
    if rank == 0:
        out["rel"] = max(abs(a - b) / abs(b) for sa, sb in zip(out["losses"], out["ref"])
                         for a, b in zip(sa, sb))
    return out


def _dp_vocoder(rank, world):
    """The HiFi-GAN V1 GAN step, B = 16 x 8192 samples split over the ranks,
    against rank 0 alone on the whole batch: VocoderMetrics of 2 steps, then
    the ms of a third (the first steps run cuDNN's algorithm search)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from masg_tpu_torch.cli.train_vocoder import training_config
    from masg_tpu_torch.parallel.mesh import DataMesh
    from masg_tpu_torch.train.vocoder import init_vocoder_train_state, make_vocoder_train_step

    cfg = training_config()
    bsz, seg = cfg["batch_size"], cfg["segment_size"]
    y = torch.from_numpy(sine_batch(np.random.default_rng(0), bsz, seg)).to(DEVICE)
    mesh = DataMesh(world, rank).for_batch(bsz)

    def run(m, rows):
        state = init_vocoder_train_state(cfg, steps_per_epoch=1000, seed=0, device=DEVICE)
        step = make_vocoder_train_step(cfg, mesh=m)
        metrics = []
        for _ in range(2):
            state, vm = step(state, y[rows])
            metrics.append([float(x) for x in vm])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, y[rows])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        del state
        torch.cuda.empty_cache()
        return metrics, ms

    out = {}
    if rank == 0:
        out["ref"], out["ms_1rank"] = run(None, slice(0, bsz))
    dist.barrier()
    out["metrics"], out["ms_2ranks"] = run(mesh, mesh.rows(bsz))
    if rank == 0:
        out["rel"] = max(abs(a - b) / abs(b) for sa, sb in zip(out["metrics"], out["ref"])
                         for a, b in zip(sa, sb))
    return out


def dp_worker(rank, world):
    """A rank of [dp]'s pair of worker processes (gloo, CUDA tensors on the
    one card): the train variants, GE2E and the vocoder GAN in turn.
    Returns host data only."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    out = {"train": {}}
    for variant, acc in (("plain", 1), ("plain", 2), ("use_clf", 1), ("ganlike", 1)):
        out["train"][f"{variant}/{acc}"] = _dp_train(rank, world, variant, acc)
    out["ge2e"] = _dp_ge2e(rank, world)
    out["vocoder"] = _dp_vocoder(rank, world)
    return out


def dp_serve(smi):
    """`ServingEngine(devices=[cuda:0, cuda:0])` (two replicas on the card)
    against the single engine on the flagship f32 weights: one B = 8
    dispatch at bucket 128 (K1 20, K4 4 launches: 10 and 2 a replica), a
    B = 1 request on the whole-batch path (K1 10, K4 2)."""
    import numpy as np
    import torch

    from masg_tpu_torch.compat.from_jax import with_duration_bias
    from masg_tpu_torch.infer.serving import ServingEngine
    from masg_tpu_torch.infer.synthesis import load_model
    from masg_tpu_torch.infer.vocoder import get_vocoder

    cfg = flagship_config()
    sd = with_duration_bias(load_model(cfg, device=DEVICE, seed=0).state_dict(), math.log(5.0))
    vocoder = get_vocoder(cfg.model, device=DEVICE, seed=1)

    def engine(**kw):
        return ServingEngine(cfg, state_dict=sd, vocoder=vocoder, text_buckets=SERVE_BUCKETS,
                             frames_per_phone=SERVE_FPP, **kw)

    single, dp = engine(device=DEVICE), engine(devices=[DEVICE, DEVICE])
    rng = np.random.default_rng(21)
    reqs = [{"ids": list(rng.integers(5, 80, size=int(rng.integers(100, 129)))),
             "speaker_id": int(rng.integers(0, 16))} for _ in range(8)]
    reset_counts()
    want = single.synthesize_many(reqs, batch_buckets=(8,))
    torch.cuda.synchronize()
    per_replica = read_counts()  # K1 10 and K4 2 at the flagship ([serve])
    dp.synthesize_many(reqs, batch_buckets=(8,))  # warm-up of the split shapes
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = dp.synthesize_many(reqs, batch_buckets=(8,))
    torch.cuda.synchronize()
    ms8 = (time.perf_counter() - t0) * 1e3
    counts8 = read_counts()
    assert all(g["bucket"] == 128 for g in got), [g["bucket"] for g in got]
    assert [g["mel_len"] for g in got] == [w["mel_len"] for w in want]
    assert all(g["mel_len"] > 0 for g in got)
    lsb8 = max(_max_lsb(g["wav"], w["wav"]) for g, w in zip(got, want))
    t = cfg.model.transformer
    assert per_replica["K1"] == t.encoder_layer + t.decoder_layer, per_replica
    assert counts8 == {k: 2 * v for k, v in per_replica.items()}, (counts8, per_replica)
    assert lsb8 <= 2, lsb8
    reset_counts()
    r1 = dp.synthesize(reqs[0]["ids"], speaker_id=reqs[0]["speaker_id"])
    torch.cuda.synchronize()
    counts1 = read_counts()
    w1 = single.synthesize(reqs[0]["ids"], speaker_id=reqs[0]["speaker_id"])
    assert counts1 == per_replica, (counts1, per_replica)
    assert r1["mel_len"] == w1["mel_len"] and _max_lsb(r1["wav"], w1["wav"]) <= 2
    print(f"[dp] serve: ServingEngine(devices=[cuda:0, cuda:0]) vs one engine, B=8 at "
          f"bucket 128: mel_len identical {[g['mel_len'] for g in got]}, wav max "
          f"{lsb8} LSB (tol 2), launches {counts8} (twice one engine's {per_replica}), "
          f"{ms8:.1f} ms; B=1 on the whole-batch path: launches {counts1}, "
          f"{_max_lsb(r1['wav'], w1['wav'])} LSB; on {smi}")
    return {"K1": counts8["K1"], "K4": counts8["K4"]}


def dp_nccl(smi, pre_dir, root):
    """`cli.train --n_devices 1 --multihost` under torchrun's environment at
    world size 1: the NCCL process group, 2 steps on [trainer]'s corpus."""
    import socket

    from masg_tpu_torch.data.synthetic import write_config_dir

    cfg_dir = write_config_dir(os.path.join(root, "dp_cfg"), pre_dir,
                               os.path.join(root, "dp_out"), step={"save_step": 2})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0", MASG_INIT_TIMEOUT="120")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "masg_tpu_torch.cli.train", "-c", cfg_dir,
                        "--n_devices", "1", "--multihost", "--max_steps", "2"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    mesh_line = next(x for x in r.stdout.splitlines() if x.startswith("mesh:"))
    assert "backend nccl" in mesh_line, mesh_line
    losses = _total_losses(cfg_dir)
    assert [s for s, _ in losses] == [1, 2] and all(math.isfinite(v) for _, v in losses)
    assert os.path.exists(os.path.join(root, "dp_out", "ckpt", "2.pth.tar"))
    print(f"[dp] NCCL: cli.train --n_devices 1 --multihost (torchrun env, world size 1): "
          f"'{mesh_line}', total losses {[round(v, 4) for _, v in losses]}, step-2 "
          f"checkpoint written, {wall:.1f} s for the process; on {smi}")


def dp_path(smi, pre_dir, root):
    """Phase [dp]: one pair of worker processes (`parallel.distributed.spawn`,
    gloo with CUDA tensors, both ranks on cuda:0) runs the train variants,
    GE2E and the vocoder GAN 2 ranks against 1; then the 2-replica serving
    engine here, and the NCCL group at world size 1 in a subprocess.
    The ranks share one card, so 2 ranks are not expected to be faster than
    1: the times show the cost of the collectives, not a speed-up. Returns
    the kernels-line fields (launches on the dp paths)."""
    import torch

    from masg_tpu_torch.parallel.distributed import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(dp_worker, DP_WORLD, backend="gloo", timeout_s=600)
    spent = time.perf_counter() - t0
    r0 = ranks[0]
    fields = {}
    for name, res in r0["train"].items():
        variant, acc = name.split("/")
        t = flagship_config().model.transformer  # one launch per attention layer
        per_k = (t.encoder_layer + t.decoder_layer) * (2 if variant != "plain" else 1)
        for i in range(DP_WORLD):
            lp = ranks[i]["train"][name]["launches_per_step"]
            assert lp == {"K1": per_k, "K2": per_k, "K3": per_k, "K4": 0}, (name, i, lp)
        sums = {ranks[i]["train"][name]["param_checksum"] for i in range(DP_WORLD)}
        assert len(sums) == 1, (name, sums)  # the replicas took the same updates
        print(f"[dp] train {variant}, grad_acc_step {acc}, flagship B={B} L={L} T_mel={T_MEL} "
              f"f32 (TF32 off), kernel path, dropout off, 2 ranks on cuda:0 (gloo) vs 1: "
              f"reduced gradients max(|err| - 1e-4 |ref|) {res['grad_excess']:.3g} over "
              f"{res['grad_tensors']} tensors (tol 5e-6), losses of "
              f"{len(res['traj'])} steps max relative err {res['loss_rel']:.3g} (tol 1e-5), "
              f"grad_norm {res['grad_norm_rel']:.3g}; launches per rank per step "
              f"{ranks[0]['train'][name]['launches_per_step']}; {res['ms_1rank']:.1f} ms per "
              f"step on 1 rank, {res['ms_2ranks']:.1f} ms on 2 ranks sharing the card "
              f"(no speed-up expected); on {smi}")
        assert res["grad_excess"] <= 5e-6 and res["loss_rel"] <= 1e-5, (name, res)
        fields[f"{variant}/{acc}"] = {"launches_per_rank_per_step": per_k,
                                      "ms_1rank": res["ms_1rank"],
                                      "ms_2ranks_one_card": res["ms_2ranks"]}
    g, v = r0["ge2e"], r0["vocoder"]
    print(f"[dp] GE2E N x M = {GE2E_N} x {GE2E_M}, 150 frames, 2 ranks vs 1: (ge2e, da) "
          f"losses {[tuple(round(x, 5) for x in s) for s in g['losses']]}, max relative err "
          f"{g['rel']:.3g} (tol 1e-4); {g['ms_1rank']:.1f} ms per step on 1 rank, "
          f"{g['ms_2ranks']:.1f} ms on 2 sharing the card; on {smi}")
    assert g["rel"] <= 1e-4, g
    print(f"[dp] vocoder GAN V1, B=16 x 8192, 2 ranks vs 1: VocoderMetrics of 2 steps max "
          f"relative err {v['rel']:.3g} (tol 1e-5); {v['ms_1rank']:.1f} ms per step on 1 "
          f"rank, {v['ms_2ranks']:.1f} ms on 2 sharing the card (the third step); on {smi}")
    assert v["rel"] <= 1e-5, v
    print(f"[dp] worker pair: {spent:.1f} s including start-up")
    serve = dp_serve(smi)
    dp_nccl(smi, pre_dir, root)
    return {"train": fields, "serve_dispatch_B8": serve}


# ---------------------------------------------------------------------------
# [tp]: tensor parallelism (the model axis) over torch.distributed
# ---------------------------------------------------------------------------

TP_WORLD = 4  # four ranks sharing the one card over gloo (CUDA tensors)
TP_GRAD_REL = 1e-2  # [tp]'s f32 gradient bar, of each tensor's largest entry (+ 5e-6)


def _tp_state(variant, acc, disc, mesh=None, dropout=False, dtype=None, use_flash=True):
    """A flagship train state on the card from seed 0 (on `mesh`'s model
    axis: this rank's shard of those weights), the kernel path unless
    `use_flash` is False, in `dtype` (default f32), and its step."""
    import copy

    import torch

    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.models.ganlike import GANLike
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import make_ganlike_train_step, make_train_step

    cfg = flagship_config()
    cfg.train.optimizer.grad_acc_step = acc
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FastSpeech2.from_config(cfg, use_flash=use_flash, mesh=mesh)
    if not dropout:
        _no_dropout(model)
    model.to(DEVICE, dtype)
    d_model, total = cfg.model.transformer.encoder_hidden, cfg.train.step.total_step
    if variant == "plain":
        return (create_train_state(model, cfg.train.optimizer, d_model),
                make_train_step(model, total_step=total))
    disc = copy.deepcopy(disc).to(DEVICE)
    if variant == "ganlike":
        gl = GANLike(model, disc)
        return (create_train_state(gl, cfg.train.optimizer, d_model),
                make_ganlike_train_step(gl, total_step=total))
    return (create_train_state(model, cfg.train.optimizer, d_model),
            make_train_step(model, use_clf=True, discriminator=disc, total_step=total))


def _whole_grads(st):
    """The state's gradients, each split one gathered over the model group."""
    from masg_tpu_torch.parallel.mesh import sharded_names, unshard_tensor

    axis = st.model_axis
    names = sharded_names(st.model) if axis is not None else {}
    out = []
    for n, p in st.model.named_parameters():
        if not p.requires_grad:
            continue
        g = p.grad if p.grad is not None else p.detach() * 0
        out.append(unshard_tensor(g, names[n], axis) if n in names else g.detach().clone())
    return out


def _replicated_digest(st):
    """A digest of this rank's replicated parameters and buffers, bit for bit."""
    import hashlib

    from masg_tpu_torch.parallel.mesh import sharded_names

    names = sharded_names(st.model) if st.model_axis is not None else {}
    h = hashlib.sha256()
    for k, v in st.model.state_dict().items():
        if k not in names:
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class _AllReduceBytes:
    """Counts the bytes `torch.distributed.all_reduce` moves in this process."""

    def __init__(self):
        import torch.distributed as dist

        self.inner, self.bytes = dist.all_reduce, 0
        dist.all_reduce = self

    def __call__(self, t, *args, **kw):
        self.bytes += t.numel() * t.element_size()
        return self.inner(t, *args, **kw)


def _tp_run(st, step, batch, mesh, n, first=0):
    """`n` train steps: [losses + grad_norm per step]."""
    import torch

    traj = []
    for i in range(n):
        st, m = step(st, batch, first + i, mesh)
        traj.append([float(getattr(m, k)) for k in DP_STEP_METRICS + ("grad_norm",)])
    torch.cuda.synchronize()
    return traj


def _traj_rel(got, want):
    """(largest relative loss error, largest relative grad_norm error)."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return float(rel[:, :-1][want[:, :-1] != 0].max()), float(rel[:, -1].max())


def _grad_report(got, want, names):
    """The gathered gradients against one rank's: the mesh bar's excess, its
    worst tensor and the share of entries outside it (max(|err| - 1e-4 |ref|)
    <= 5e-6), and per tensor max|err| - TP_GRAD_REL max|ref| (a tensor's
    gradient counted M times is off by >= 50 % of its largest entry; a ReLU
    whose f32 input rounds to the other side of 0 moved a tensor by up to
    5.5e-3 of it)."""
    mesh = [((g - r).abs() - 1e-4 * r.abs()) for g, r in zip(got, want)]
    worst = max(range(len(mesh)), key=lambda i: float(mesh[i].max()))
    outside = sum(int((m > 5e-6).sum()) for m in mesh) / sum(m.numel() for m in mesh)
    excess = [float((g - r).abs().max() - TP_GRAD_REL * r.abs().max())
              for g, r in zip(got, want)]
    w = max(range(len(excess)), key=excess.__getitem__)
    return {"grad_excess": float(mesh[worst].max()), "grad_worst": names[worst],
            "grad_outside": outside, "grad_tensor_excess": excess[w], "grad_tensor_worst": names[w]}


def _f64_grads(rank, mesh):
    """[tp]'s float64 check on the plain path: the gathered gradients of one
    backward of the flagship plain step on `mesh` (None: one rank)."""
    import torch

    from masg_tpu_torch.train.step import batch_to_device

    st, step = _tp_state("plain", 1, None, mesh, dtype=torch.float64, use_flash=False)
    batch = batch_to_device(example_inputs(B=B, L=L, T=T_MEL), DEVICE, torch.float64)
    step.loss_fn(st.model, batch, 0, mesh=mesh)[0].backward()
    grads = _whole_grads(st)
    del st, step
    torch.cuda.empty_cache()
    return grads


def _tp_measure(st, step, batch, mesh, counter, n_steps):
    """On the ranks of a mesh: the gathered gradients of one backward, the
    metrics of `n_steps` steps, K1-K3 launches per step, ms per step and
    bytes all-reduced per step (mean of 2 more), parameters held and the
    peak memory of this process."""
    import torch

    out = {"held": sum(p.numel() for p in st.model.parameters())}
    step.loss_fn(st.model, batch, 0, mesh=mesh)[0].backward()
    mesh.reduce_grads(st.params())
    out["grads"] = [g.cpu() for g in _whole_grads(st)]  # off the card: rank 0 keeps 4 sets
    out["names"] = [n for n, p in st.model.named_parameters() if p.requires_grad]
    for p in st.params():
        p.grad = None
    reset_counts()
    out["traj"] = _tp_run(st, step, batch, mesh, n_steps)
    out["launches_per_step"] = {k: v / n_steps for k, v in read_counts().items()}
    counter.bytes = 0
    t0 = time.perf_counter()
    _tp_run(st, step, batch, mesh, 2, first=n_steps)
    out["ms"] = (time.perf_counter() - t0) * 1e3 / 2
    out["bytes_per_step"] = counter.bytes / 2
    out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def tp_worker(rank, world):
    """A rank of [tp]'s four worker processes (gloo, CUDA tensors on the one
    card): the one-rank references on rank 0, then 1 x 2 (ranks 0, 1) and
    2 x 2 (all four) against them, dropout on, and a checkpoint. Returns
    host data only."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from masg_tpu_torch.core.checkpoint import CheckpointManager
    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.parallel.mesh import DataMesh
    from masg_tpu_torch.train.step import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    counter = _AllReduceBytes()
    pair_group = dist.new_group([0, 1])  # every rank creates every group
    mesh22 = DataMesh.from_process_group(B, n_model=2)
    mesh12 = DataMesh(n_model=2, model_rank=rank, model_group=pair_group) if rank < 2 else None
    torch.manual_seed(1)
    disc = SpeechEmbedder()
    variants = (("plain", 2), ("use_clf", 1), ("ganlike", 1))
    batches = {v: batch_to_device(adversarial_batch() if v != "plain"
                                  else example_inputs(B=B, L=L, T=T_MEL), DEVICE, torch.float32)
               for v in ("plain", "use_clf")}
    batches["ganlike"] = batches["use_clf"]
    out = {"train": {}}

    # float64 on the plain path, 1 x 2: the f/g/gather algebra at rounding level
    ref64 = _f64_grads(rank, None) if rank == 0 else None
    dist.barrier()
    if mesh12 is not None:
        got64 = _f64_grads(rank, mesh12)
        if rank == 0:
            out["f64_grad"] = max(float((g - r).abs().max() - 1e-10 * r.abs().max())
                                  for g, r in zip(got64, ref64))
            out["f64_tensors"] = len(ref64)
        del got64
    del ref64
    torch.cuda.empty_cache()
    dist.barrier()

    # the one-rank references
    refs = {}
    if rank == 0:
        for variant, acc in variants + (("plain", 1),):
            st, step = _tp_state(variant, acc, disc)
            torch.cuda.reset_peak_memory_stats()
            refs[variant, acc] = _tp_measure(st, step, batches[variant], DataMesh(), counter, 3)
            del st, step
            torch.cuda.empty_cache()
    dist.barrier()

    # 1 x 2 on ranks 0 and 1 (2 and 3 wait)
    for variant, acc in variants:
        res = None
        if mesh12 is not None:
            st, step = _tp_state(variant, acc, disc, mesh12)
            torch.cuda.reset_peak_memory_stats()
            res = _tp_measure(st, step, batches[variant], mesh12, counter, 3)
            del st, step
            torch.cuda.empty_cache()
        out["train"][f"1x2 {variant}/{acc}"] = _tp_compare(rank, res, refs.get((variant, acc)))
        dist.barrier()

    # 2 x 2 on all four: each data rank its 8 rows
    mesh = mesh22.for_batch(B)
    mine = batch_to_device(mesh.shard_batch(example_inputs(B=B, L=L, T=T_MEL)), DEVICE,
                           torch.float32)
    st, step = _tp_state("plain", 1, disc, mesh22)
    torch.cuda.reset_peak_memory_stats()
    res = _tp_measure(st, step, mine, mesh, counter, 2)
    del st, step
    torch.cuda.empty_cache()
    ref = refs.get(("plain", 1))
    if ref is not None:
        ref = dict(ref, traj=ref["traj"][:2])
    out["train"]["2x2 plain/1"] = _tp_compare(rank, res, ref)
    dist.barrier()

    # dropout on, 1 x 2: the replicated tensors of the two model ranks
    if mesh12 is not None:
        st, step = _tp_state("plain", 1, disc, mesh12, dropout=True)
        for i in range(3):
            st, _ = step(st, batches["plain"], 100 + i, mesh12)
        torch.cuda.synchronize()
        out["dropout_digest"] = _replicated_digest(st)
        del st, step
        torch.cuda.empty_cache()
    dist.barrier()

    # a 1 x 2 checkpoint at step 2, restored on rank 0 alone for step 3
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=os.path.join(REPO, "build")) \
        if rank == 0 else None
    box = [root]
    dist.broadcast_object_list(box, src=0)
    if mesh12 is not None:
        st, step = _tp_state("plain", 1, disc, mesh12)
        traj = _tp_run(st, step, batches["plain"], mesh12, 2)
        CheckpointManager(box[0]).save(2, st)
        out["ckpt_uninterrupted"] = traj + _tp_run(st, step, batches["plain"], mesh12, 1, 2)
        del st, step
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        st, step = _tp_state("plain", 1, disc)
        st = CheckpointManager(root).restore(2, st)
        out["ckpt_restored"] = _tp_run(st, step, batches["plain"], None, 1, 2)
        del st, step
        shutil.rmtree(root)
    return out


def _tp_compare(rank, res, ref):
    """Rank 0: its mesh result against the one-rank reference (the gathered
    gradients, the losses); every rank: its launches, parameters, memory."""
    if res is None:
        return None
    out = {k: res[k] for k in ("held", "launches_per_step", "ms", "bytes_per_step",
                               "max_memory_gib", "traj")}
    if rank == 0:
        out.update(_grad_report(res["grads"], ref["grads"], res["names"]))
        out["grad_tensors"] = len(ref["grads"])
        out["loss_rel"], out["grad_norm_rel"] = _traj_rel(res["traj"], ref["traj"])
        out["ms_1rank"] = ref["ms"]
        out["held_1rank"] = ref["held"]
        out["max_memory_gib_1rank"] = ref["max_memory_gib"]
    return out


def tp_kernel_times():
    """K1-K3 (float32) per train step at the flagship's shapes: the 2 heads
    of one device (B = 16), and a rank's 1 head on 1 x 2 (B = 16) and on
    2 x 2 (B = 8, each data rank's rows). 4 encoder calls (T = L) and 6
    decoder calls (T = T_mel), each key length from [train]'s batch. Every
    1-head shape is first held against the plain versions on its inputs at
    [K1] and [K2/K3] float32 bars (2e-5; 5e-3 with dK/dV exactly 0 past
    the length). {kernel: {"H2_ms", "H1_ms", "H1_B8_ms", "H1_max_abs_err"}},
    CUDA events; the B = 8 time is data rank 0's rows."""
    import torch

    from masg_tpu_torch.ops.attention import (flash_attention, flash_attention_dkv,
                                              flash_attention_dq, flash_attention_plain)

    batch = example_inputs(B=B, L=L, T=T_MEL)
    gen = torch.Generator().manual_seed(3)
    out = {k: {"H2_ms": 0.0, "H1_ms": 0.0, "H1_B8_ms": 0.0, "H1_max_abs_err": 0.0}
           for k in ("K1", "K2", "K3")}
    for t, lens, calls in ((L, batch["src_lens"], 4), (T_MEL, batch["mel_lens"], 6)):
        lens_all = torch.as_tensor(lens, device=DEVICE)
        for key, h, rows in (("H2_ms", 2, slice(0, B)), ("H1_ms", 1, slice(0, B)),
                             ("H1_B8_ms", 1, slice(0, B // 2)), (None, 1, slice(B // 2, B))):
            lens_t = lens_all[rows].contiguous()
            q, k, v, do, lse, delta, valid = bwd_inputs(t, torch.float32, lens_t, gen, h)
            if h == 1:
                o_ref, _ = flash_attention_plain(q, k, v, lens_t)
                err = (flash_attention(q, k, v, lens_t) - o_ref).abs().max().item()
                assert err <= 2e-5, (t, rows, err)
                errs = bwd_errors(q, k, v, do, lse, delta, lens_t, valid, torch.float32)
                for name, e in (("K1", err), ("K2", errs[0]), ("K3", max(errs[1:]))):
                    out[name]["H1_max_abs_err"] = max(out[name]["H1_max_abs_err"], e)
            if key is None:
                continue
            for name, fn in (("K1", lambda: flash_attention(q, k, v, lens_t)),
                             ("K2", lambda: flash_attention_dq(q, k, v, do, lse, delta, lens_t)),
                             ("K3", lambda: flash_attention_dkv(q, k, v, do, lse, delta,
                                                                lens_t))):
                out[name][key] += calls * cuda_ms(fn, 10)
    return out


def tp_path(smi):
    """Phase [tp]: four worker processes (`parallel.distributed.spawn`, gloo
    with CUDA tensors, all on cuda:0) run the flagship FastSpeech2 train
    step on 1 x 2 and 2 x 2 (data, model) meshes against one rank, dropout
    on, and a checkpoint; then K1-K3 at a rank's share of the heads here.
    The ranks share one card, so no speed-up is expected: the times show
    the cost of the collectives. Returns the kernels-line fields."""
    import torch

    from masg_tpu_torch.parallel.distributed import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(tp_worker, TP_WORLD, backend="gloo", timeout_s=600)
    spent = time.perf_counter() - t0
    r0 = ranks[0]
    t = flagship_config().model.transformer
    fields = {}
    for name, res in r0["train"].items():
        shape, va = name.split(" ")
        variant = va.split("/")[0]
        per_k = (t.encoder_layer + t.decoder_layer) * (2 if variant != "plain" else 1)
        on = [r["train"][name] for r in ranks if r["train"][name] is not None]
        assert len(on) == (2 if shape == "1x2" else 4), (name, len(on))
        for i, r in enumerate(on):
            lp = r["launches_per_step"]
            assert lp == {"K1": per_k, "K2": per_k, "K3": per_k, "K4": 0}, (name, i, lp)
        held = [r["held"] for r in on]
        print(f"[tp] train {va} on {shape} (data x model), flagship B={B} L={L} "
              f"T_mel={T_MEL} f32 (TF32 off), kernel path, dropout off, ranks on cuda:0 "
              f"(gloo) vs 1: gathered gradients over {res['grad_tensors']} tensors: "
              f"max(|err| - 1e-4 |ref|) {res['grad_excess']:.3g} ({res['grad_worst']}; "
              f"masg_tpu's dp bar 5e-6), {res['grad_outside']:.3g} of the entries past it "
              f"(f32 ReLU flips), per tensor max|err| - {TP_GRAD_REL:g} max|ref| "
              f"{res['grad_tensor_excess']:.3g} ({res['grad_tensor_worst']}; tol 5e-6); "
              f"losses of {len(res['traj'])} steps max relative err {res['loss_rel']:.3g} "
              f"(tol 1e-5), grad_norm {res['grad_norm_rel']:.3g} (tol 1e-5); launches per "
              f"rank per "
              f"step {on[0]['launches_per_step']}; parameters per rank {held} of "
              f"{res['held_1rank']}; peak memory per rank "
              f"{[round(r['max_memory_gib'], 3) for r in on]} GiB (1 rank "
              f"{res['max_memory_gib_1rank']:.3f}); {res['ms_1rank']:.1f} ms per step on 1 "
              f"rank, {res['ms']:.1f} ms on {shape} sharing the card (no speed-up expected), "
              f"{res['bytes_per_step'] / 1e9:.3f} GB all-reduced per step by rank 0; on {smi}")
        assert res["grad_tensor_excess"] <= 5e-6 and res["loss_rel"] <= 1e-5, (name, res)
        assert res["grad_norm_rel"] <= 1e-5, (name, res)
        assert max(held) < res["held_1rank"], held
        fields[name] = {"launches_per_rank_per_step": per_k, "ms_1rank": res["ms_1rank"],
                        "ms_one_card": res["ms"], "bytes_all_reduced_per_step":
                        res["bytes_per_step"], "parameters_per_rank": held,
                        "max_memory_gib_per_rank": [r["max_memory_gib"] for r in on]}
    print(f"[tp] float64, plain path, 1 x 2 vs 1 rank at the flagship width: gathered "
          f"gradients of one backward, per tensor max|err| - 1e-10 max|ref| "
          f"{r0['f64_grad']:.3g} over {r0['f64_tensors']} tensors (tol 1e-15)")
    assert r0["f64_grad"] <= 1e-15, r0["f64_grad"]
    digests = [r["dropout_digest"] for r in ranks[:2]]
    assert digests[0] == digests[1], digests
    print(f"[tp] dropout on, 1 x 2, 3 steps: the replicated parameters and buffers of the "
          f"two model ranks are bit-identical (sha256 {digests[0][:16]}...)")
    import numpy as np

    got, want = np.asarray(r0["ckpt_restored"]), np.asarray(r0["ckpt_uninterrupted"][2:])
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30))[:, :-1].max())
    print(f"[tp] checkpoint: a 1 x 2 run's step-2 checkpoint restored on one rank takes "
          f"step 3 with losses max relative err {rel:.3g} against the 1 x 2 run's own "
          f"step 3 (tol 1e-5)")
    assert rel <= 1e-5, (got, want)
    times = tp_kernel_times()
    for name, tm in times.items():
        print(f"[tp] {name} f32 per train step (4 encoder + 6 decoder calls): 2 heads "
              f"{tm['H2_ms']:.3f} ms (one device, B={B}), 1 head {tm['H1_ms']:.3f} ms (a "
              f"rank of 1 x 2, B={B}), 1 head {tm['H1_B8_ms']:.3f} ms (a rank of 2 x 2, "
              f"B={B // 2}); at 1 head (B={B} and both halves) vs the plain version max abs "
              f"err {tm['H1_max_abs_err']:.3g} (tol {2e-5 if name == 'K1' else 5e-3:g}); "
              f"on {smi}")
    print(f"[tp] worker quartet: {spent:.1f} s including start-up")
    return {"train": fields, "kernel_ms_per_step": times}


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

    def lap(name):
        print(f"[time] {name} done at {time.time() - t_start:.1f} s", flush=True)

    smi = header()
    build_kernels()
    check_flash()
    mrf, mrf_narrow = check_mrf()
    check_flash_bwd()
    lap("[build], [K1], [K4], [K2/K3]")
    results = main_path(smi)
    profile_inference(results, smi)
    entries = main_path_kernel_times(results, mrf)
    lap("[main], [profile], [kernels]")
    serve = serve_path(smi)
    lap("[serve]")
    for e, name in zip(entries, ("K1", "K4")):
        e["serve"] = {"launches": serve["launches"][name],
                      "dispatches": serve["n_dispatches"],
                      "per_request_bucket128": serve["per_request_bucket128"][name]}
    train = train_path(smi)
    param_storage_path(train, smi)
    profile_train_step(train, smi)
    lap("[train], [param_storage], [profile]")
    import shutil
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        cfg_dir = trainer_path(os.path.join(root, "trainer"))
        dump, mel_dir = dump_mels_path(smi, cfg_dir, root)
        finetune = vocoder_finetune_path(smi, root, mel_dir)
        lap("[trainer], [dump_mels], [vocoder_finetune]")
        dp = dp_path(smi, os.path.join(root, "trainer", "pre"), root)
        lap("[dp]")
        tp = tp_path(smi)
        lap("[tp]")
    finally:
        shutil.rmtree(root)
    train_entries, k1_train = train_kernel_times(train, smi)
    entries[0]["float32_train_step"] = k1_train
    entries[0]["dump_mels"] = dump
    entries[1]["trained_generator"] = finetune
    entries[1:1] = train_entries
    root = tempfile.mkdtemp(prefix="chip_smoke_ge2e_", dir=os.path.join(REPO, "build"))
    try:
        chunks = ge2e_path(smi, root)
        adversarial = adversarial_path(smi)
        adversarial_clis(chunks)
        vocoder_train_path(smi)
        preprocess_path(smi, root)
        jdit = jdit_path(smi, root)
    finally:
        shutil.rmtree(root)
    lap("[ge2e], [adversarial], [vocoder_train], [preprocess], [jdit]")
    melgan = melgan_path(smi)
    lap("[melgan]")
    root = tempfile.mkdtemp(prefix="chip_smoke_demo_", dir=os.path.join(REPO, "build"))
    try:
        v2 = v2_path(smi, root)
        lap("[v2]")
        demo = demo_path(smi, root)
        lap("[demo]")
    finally:
        shutil.rmtree(root)
    k4 = entries[3]
    k4["narrow_stages"] = {
        "path": "V2's stages C = 16 (T = 81,920) and C = 8 (T = 163,840), B = 16; 'demo': "
                "C = 16 with kernels (3, 7)",
        **{d: {str(c): {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "err")}
               for c, r in rows.items()} for d, rows in mrf_narrow.items()}}
    k4["v2"] = v2
    k4["demo"] = {"launches": demo["launches"], "checks": demo["checks"],
                  "seconds": demo["seconds"]}
    entries[0]["v2"] = {"path": v2["path"], "launches_per_forward": v2["k1_launches_per_forward"]}
    for e, name in zip(entries[:3], ("K1", "K2", "K3")):
        e["demo"] = {stage: n[name] for stage, n in demo["launches"].items()}
    for e, name in zip(entries[:3], ("K1", "K2", "K3")):
        e["adversarial"] = adversarial[name]
        e["jdit"] = jdit[name]
    for e, name in zip((entries[0], entries[3]), ("K1", "K4")):
        e["melgan"] = {"path": "text->wav, MelGAN, float32", "launches_per_forward": melgan[name]}
    for e in entries[:3]:  # [dp]: per rank per step, 2 ranks sharing the card
        e["dp_train"] = dp["train"]
    for e, name in zip(entries[:3], ("K1", "K2", "K3")):  # [tp]: per rank, sharing the card
        e["tp_train"] = dict(tp["train"], kernel_ms_per_train_step=tp["kernel_ms_per_step"][name])
    for e, name in zip((entries[0], entries[3]), ("K1", "K4")):
        e["dp_serve"] = {"path": "ServingEngine(devices=[cuda:0, cuda:0]), B=8, bucket 128",
                         "launches_per_dispatch": dp["serve_dispatch_B8"][name]}
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
