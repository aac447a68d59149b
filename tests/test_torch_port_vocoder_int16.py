"""The int16 conversion and trim that `vocoder_infer` runs on the card
(`trim_to_int16`), run here on CPU tensors, against numpy's `to_int16` and
the trim of the CPU path: the same samples, bit for bit."""

import numpy as np
import pytest
import torch

from masg_tpu_torch.infer.vocoder import to_int16, trim_to_int16
import torch_port_support  # noqa: F401  (the port tests' thread count)

T = 64
MAX_WAV = 32768.0


def edge_rows() -> np.ndarray:
    """±1, values past ±1, the neighbours of ±k/32768 and of the int16 ends,
    half steps, zeros and tiny values; rows of T, padded with random."""
    f32 = np.float32
    vals = [0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0, 1.5, -1.5, 2.0, -3.0, 1e6, -1e6,
            32767 / 32768, -32767 / 32768, 32766.5 / 32768, -32767.5 / 32768]
    for k in (1, 2, 3, 100, 12345, 32767, 32768):
        for sign in (1, -1):
            v = f32(sign * k / 32768)
            vals += [v, np.nextafter(v, f32(np.inf)), np.nextafter(v, f32(-np.inf)),
                     f32(sign * (k - 0.5) / 32768)]
    for v in (1.0, -1.0):
        vals += [np.nextafter(f32(v), f32(0)), np.nextafter(f32(v), f32(2 * v))]
    vals = np.asarray(vals, np.float32)
    rng = np.random.default_rng(7)
    n_rows = -(-vals.size // T) + 1
    out = rng.normal(0, 0.5, n_rows * T).astype(np.float32)
    out[: vals.size] = vals
    return out.reshape(n_rows, T)


def random_rows() -> np.ndarray:
    return np.random.default_rng(11).normal(0, 0.6, (5, T)).astype(np.float32)


@pytest.mark.parametrize("lengths", ["none", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("make", [edge_rows, random_rows], ids=["edges", "random"])
def test_trim_to_int16_matches_numpy_bit_for_bit(make, dtype, lengths):
    wav = torch.from_numpy(make()).to(dtype)
    b = wav.shape[0]
    lens = None if lengths == "none" else ([0, T, T + 37, 1, T - 1] * b)[:b]
    flat, sizes = trim_to_int16(wav, MAX_WAV, lens)
    got = flat.split(sizes)

    want = list(to_int16(wav.float().numpy(), MAX_WAV))  # the CPU path
    if lens is not None:
        want = [w[: int(n)] for w, n in zip(want, lens)]
    assert flat.dtype == torch.int16 and len(got) == len(want) == b
    for g, w in zip(got, want):
        assert w.dtype == np.int16 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    if lens is not None:
        assert sizes[:3] == [0, T, T]
    # the clip engages and both ends of int16 are reached
    all_want = np.concatenate(want)
    assert make is random_rows or (all_want.min() == -32768 and all_want.max() == 32767)
