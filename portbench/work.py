"""Operations and bytes from shapes, and the device's peaks.

A kernel's roofline share is the least time the chip could take for the
work the call needs at its own inputs (the larger of operations over the
peak rate and bytes over the memory rate) over the time the kernel took.
MFU counts the model's useful work: each row at its own lengths, so work
done on padding counts for nothing.

The peak is one per operand type, whatever a kernel uses to compute:
- float32: 495e12 FLOP/s, the H100 SXM's dense TF32 tensor-core rate, the
  highest rate at which float32 operands enter the chip's arithmetic. No
  method that keeps float32 accuracy goes faster (3xTF32 reaches a third of
  it, the CUDA cores 67e12), so no honest kernel reads over 100 %, and a
  kernel that changes method is still measured against the same work.
- bfloat16: 989e12 FLOP/s, dense.
- memory: 3.35e12 B/s (HBM3).
These are NVIDIA's published SXM figures at the 700 W limit; the card's
power limit is printed beside each run's numbers.

The counts of K1-K4 are copied from the program's on-chip check script
(`flash_work`, `flash_bwd_work`, `mrf_work`), with the head count and
width as arguments.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the work could take on the chip."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def flash_work(lengths: Iterable[int], t: int, heads: int, dh: int, elem: int
               ) -> Tuple[int, int]:
    """K1 (attention forward) at these key lengths: every query row against
    its valid keys (q.k and p.v, 2 flops a MAC); q read, valid k/v rows
    read, o and the f32 LSE written."""
    valid = [min(int(n), t) for n in lengths]
    ops = sum(4 * heads * t * n * dh for n in valid)
    nbytes = (len(valid) * heads * t * dh * elem * 2
              + sum(2 * heads * n * dh * elem for n in valid)
              + len(valid) * heads * t * 4 + len(valid) * 4)
    return ops, nbytes


def flash_bwd_work(lengths: Iterable[int], t: int, heads: int, dh: int, elem: int):
    """((ops, bytes) of K2, (ops, bytes) of K3) at these key lengths. Per
    (b, h) with n = len: 3 (K2: s, dp, ds.k) and 4 (K3: s, dp, p^T.do,
    ds^T.q) products of 2 n^2 Dh flops. K2 reads q, do, LSE and delta at
    every row and k, v at the valid rows, and writes dq; K3 reads all six at
    the valid rows and writes dk, dv at every row."""
    valid = [min(int(n), t) for n in lengths]
    nb, row = len(valid), dh * elem
    sq = sum(n * n for n in valid)
    kv = sum(2 * heads * n * row for n in valid) + nb * 4
    k2 = (3 * 2 * heads * sq * dh, nb * heads * t * (3 * row + 8) + kv)
    k3 = (4 * 2 * heads * sq * dh, sum(heads * n * (2 * row + 8) for n in valid) + kv
          + nb * heads * t * 2 * row)
    return k2, k3


def mrf_work(b: int, t: int, c: int, kernel_sizes: Sequence[int], n_dil: int, elem: int
             ) -> Tuple[int, int]:
    """K4, one MRF stage: 2 convs per dilation unit, k taps of a C x C
    product per row each; x read, out written, weights read once."""
    taps = sum(2 * n_dil * k for k in kernel_sizes)
    ops = 2 * b * t * c * c * taps
    nbytes = 2 * b * t * c * elem + (taps * c * c + 2 * n_dil * len(kernel_sizes) * c) * 4
    return ops, nbytes


# --- whole models, useful work -------------------------------------------------


def _fft_layer_flops(n: int, h: int, d_inner: int, kernels: Sequence[int]) -> int:
    """One FFT block over a row of n valid positions: the q, k, v and output
    projections, scores and values over n keys, the two FFN convs."""
    proj = 4 * 2 * h * h * n
    attn = 2 * 2 * n * n * h
    ffn = 2 * h * d_inner * kernels[0] * n + 2 * d_inner * h * kernels[1] * n
    return proj + attn + ffn


def fs2_forward_flops(model: dict, n_mels: int, src_len: int, mel_len: int) -> int:
    """FastSpeech2 forward for one row of src_len phones and mel_len frames:
    encoder, three variance predictors, decoder, mel projection, PostNet."""
    t = model["transformer"]
    h, f, k = t["encoder_hidden"], t["conv_filter_size"], t["conv_kernel_size"]
    vp, vk = model["variance_predictor"]["filter_size"], model["variance_predictor"]["kernel_size"]
    enc = t["encoder_layer"] * _fft_layer_flops(src_len, h, f, k)
    var = 3 * src_len * (2 * h * vp * vk + 2 * vp * vp * vk + 2 * vp)
    dec = t["decoder_layer"] * _fft_layer_flops(mel_len, h, f, k)
    mel = 2 * h * n_mels * mel_len
    post = 2 * mel_len * 5 * (n_mels * 512 + 3 * 512 * 512 + 512 * n_mels)
    return enc + var + dec + mel + post


def hifigan_flops_per_frame(cfg: dict) -> int:
    """The HiFi-GAN generator's flops per mel frame: conv_pre, each stage's
    transposed conv and MRF, conv_post."""
    ch, n_mels = cfg["upsample_initial_channel"], cfg["num_mels"]
    total, samples = 2 * n_mels * ch * 7, 1
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        samples *= u
        total += 2 * cin * cout * k // u * samples
        taps = sum(2 * len(d) * rk for rk, d in zip(cfg["resblock_kernel_sizes"],
                                                    cfg["resblock_dilation_sizes"]))
        total += 2 * cout * cout * taps * samples
    return total + 2 * (ch // 2 ** len(cfg["upsample_rates"])) * 7 * samples


def mrf_stages(cfg: dict, b: int, t_mel: int) -> list:
    """(b, t, c) of each MRF stage of at most 64 channels, the stages the
    program runs through K4, at a mel of t_mel frames."""
    ch, out, t = cfg["upsample_initial_channel"], [], t_mel
    for i, u in enumerate(cfg["upsample_rates"]):
        t *= u
        c = ch // 2 ** (i + 1)
        if c <= 64:
            out.append((b, t, c))
    return out
