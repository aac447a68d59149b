"""Kernel K4 at the narrow widths (masg_tpu_torch.ops.fused_mrf, C = 16 and 8,
and C = 1, 2, 4 run at 8 on zero-padded channels) on the CPU: generators of
128 initial channels (upstream HiFi-GAN V2, and the demos' vocoder) with
masg_tpu's weights carried across against masg_tpu's generator, its Pallas
K4 in interpret mode; the packed weights at C = 8 and 16 (and the padded
widths); the zero padding's invariance; and the wrapper's argument checks
against masg_tpu's set of admitted C (every C <= 64 that divides 128)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from masg_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from masg_tpu.models.hifigan import convert_torch_state_dict
from masg_tpu_torch.compat.from_jax import hifigan_state_dict_from_jax
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from masg_tpu_torch.ops.fused_mrf import (check_stage_args, fused_mrf_stage_plain,
                                          kernel_channels, pack_stage_weights,
                                          unpack_stage_weights)
import torch_port_support  # noqa: F401  (the port tests' thread count)

# upstream config_v2.json (128 channels, kernels 3 / 7 / 11) and the demos'
# DEMO_HIFIGAN (kernels 3 / 7): MRF stages at C = 64, 32, 16, 8; 8 mels here
V2 = dict(n_mels=8, upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
          upsample_initial_channel=128, resblock_kernel_sizes=(3, 7, 11),
          resblock_dilation_sizes=((1, 3, 5),) * 3)
DEMO = dict(V2, resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5),) * 2)


def _blocks(c, ks, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for k in ks:
        bp = {}
        for i in range(3):
            for cn in ("convs1", "convs2"):
                bp[f"{cn}_{i}_kernel"] = torch.from_numpy(
                    (scale * rng.normal(size=(k, c, c)) / np.sqrt(c * k)).astype(np.float32))
                bp[f"{cn}_{i}_bias"] = torch.from_numpy(
                    (0.1 * rng.normal(size=c)).astype(np.float32))
        out.append(bp)
    return out


@pytest.mark.parametrize("name,kw", [("V2", V2), ("DEMO_HIFIGAN", DEMO)])
def test_generator_matches_masg_tpu_fused_interpret(name, kw):
    """The port's generator (the plain MRF on the CPU) against masg_tpu's with
    its K4 in interpret mode at every stage (C = 64, 32, 16, 8), masg_tpu's
    weights carried across, within 1e-6."""
    gen = HiFiGANGenerator(fused_mrf=True, **kw)
    init_random_weights(gen, torch.Generator().manual_seed(7))
    # 3/4 of the variance-keeping std: the wav stays well inside tanh's range
    # and float32 rounding well under the bar
    sd = {k: v.numpy() * (0.75 if k.endswith("weight") else 1.0)
          for k, v in gen.state_dict().items()}
    params = convert_torch_state_dict(sd, {"upsample_rates": list(kw["upsample_rates"]),
                                           "resblock_kernel_sizes":
                                               list(kw["resblock_kernel_sizes"])})
    mel = np.random.default_rng(1).normal(size=(1, 10, 8)).astype(np.float32)
    want = np.asarray(JaxGenerator(fused_mrf=True, fused_interpret=True, **kw).apply(
        {"params": params}, jnp.asarray(mel)))
    gen.load_state_dict(hifigan_state_dict_from_jax(params), strict=True)
    assert [c for c in (64, 32, 16, 8) if gen._stage_is_fused(c)] == [64, 32, 16, 8]
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape == (1, 10 * 256) and np.abs(want).max() > 0.05
    print(f"[parity] {name} generator vs masg_tpu fused (interpret), C = 64..8: max abs err "
          f"{err:.3g} (bar 1e-6)")
    assert err <= 1e-6


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packing_round_trips_at_narrow_widths(c, dtype):
    """Exact round trip at C = 8 and 16; at C = 1, 2, 4 the pack is the
    kernel's 8 channels, zero beyond C, and unpacks to the stage's C."""
    ks = (3, 7, 11)
    blocks = _blocks(c, ks, 10 + c)
    packed = pack_stage_weights(blocks, ks, 3, dtype, "cpu")
    kc = kernel_channels(c)
    assert packed.channels == c and packed.bias.shape == (18, kc)
    per_element = 2 if dtype == torch.float32 else 1
    assert packed.weight.numel() == per_element * 2 * 3 * sum(ks) * kc * kc
    assert (packed.bias[:, c:] == 0).all()
    if kc != c:  # every packed element of a padded row or column is 0
        padded = pack_stage_weights([{n: F.pad(v, (0, kc - c, 0, kc - c)[:2 * v.dim()])
                                      for n, v in b.items()} for b in blocks], ks, 3, dtype,
                                    "cpu")
        assert torch.equal(padded.weight, packed.weight)
    for want, got in zip(blocks, unpack_stage_weights(packed)):
        assert set(want) == set(got)
        for n in want:
            assert torch.equal(got[n], want[n].to(dtype)), n


def test_bf16_fragment_order_at_c8():
    """The m16n8k8 order the bf16 kernel reads at C = 8: per tap, lane l holds
    W[j][2 (l % 4) + e][l // 4], e = 0, 1."""
    blocks = _blocks(8, (3,), 3)
    w = blocks[0]["convs2_1_kernel"].to(torch.bfloat16)
    frag = pack_stage_weights(blocks, (3,), 3, torch.bfloat16, "cpu").weight
    first = 3 * 64 * 3  # convs1_0, convs2_0, convs1_1 before it, 3 taps of 64 each
    frag = frag[first:first + 3 * 64].reshape(3, 32, 2)
    for j in range(3):
        for lane in range(32):
            for e in range(2):
                assert frag[j, lane, e] == w[j, 2 * (lane % 4) + e, lane // 4]


@pytest.mark.parametrize("c", [1, 2, 4])
def test_zero_padded_channels_stay_zero(c):
    """The stage at 8 channels on x and weights zero-padded from C: the
    padded channels come out exactly 0 and the first C are the C-channel
    stage's (the arithmetic the kernel runs at C = 1, 2, 4)."""
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    blocks = _blocks(c, ks, 20 + c, scale=2.0)
    x = torch.from_numpy(np.random.default_rng(c).normal(size=(2, 300, c)).astype(np.float32))
    pad = [{n: F.pad(v, (0, 8 - c, 0, 8 - c)[:2 * v.dim()]) for n, v in b.items()}
           for b in blocks]
    want = fused_mrf_stage_plain(x, blocks, ks, ds)
    got = fused_mrf_stage_plain(F.pad(x, (0, 8 - c)), pad, ks, ds)
    assert torch.equal(got[..., c:], torch.zeros_like(got[..., c:]))
    assert (want - x).abs().max() > 0.1
    torch.testing.assert_close(got[..., :c], want, atol=1e-6, rtol=0)


def test_checks_admit_masg_tpus_widths():
    """`check_stage_args` (what the wrapper checks before a launch, on any
    device) admits every C <= 64 that divides 128, masg_tpu's K4 widths, and
    refuses any other C, a dtype or a shape the kernel does not take."""
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    for c in range(1, 130):
        x = torch.zeros(1, 4, c)
        if c <= 64 and 128 % c == 0:
            assert check_stage_args(x, ks, ds, 3) == max(c, 8)
            assert check_stage_args(x.bfloat16(), ks[:2], ds[:2], 2) == max(c, 8)
        else:
            with pytest.raises(ValueError):
                check_stage_args(x, ks, ds, 3)
    x = torch.zeros(1, 4, 16)
    with pytest.raises(TypeError):
        check_stage_args(x.double(), ks, ds, 3)
    with pytest.raises(ValueError):
        check_stage_args(x.transpose(1, 2), ks, ds, 3)  # not contiguous (B, T, C)
    for bad_ks, bad_ds, n in (((4,), ((1, 3, 5),), 1), ((3, 7), ((1, 3, 5),) * 2, 3),
                              ((13,), ((1, 3, 5),), 1), ((3,) * 5, ((1,),) * 5, 5)):
        with pytest.raises(ValueError):
            check_stage_args(x, bad_ks, bad_ds, n)
