"""K4's packed weights (masg_tpu_torch.ops.fused_mrf.pack_stage_weights):
the packing round-trips to the `convs{1,2}_{i}_kernel`/`_bias` tensors in
both kernel dtypes, the bf16 and f32 (TF32 part + remainder) fragment orders
are the ones csrc/fused_mrf.cu reads, and HiFiGANGenerator packs a stage once
and packs again when its weights change (load_state_dict, .to, an in-place
update)."""

import numpy as np
import pytest
import torch

from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from masg_tpu_torch.ops.fused_mrf import (PackedStage, fused_mrf_stage, pack_stage_weights,
                                          tf32_round, unpack_stage_weights)
import torch_port_support  # noqa: F401  (the port tests' thread count)

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
KW = dict(n_mels=8, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
          upsample_initial_channel=128, resblock_kernel_sizes=KS, resblock_dilation_sizes=DS)


def _blocks(c, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in KS:
        bp = {}
        for i in range(3):
            for cn in ("convs1", "convs2"):
                bp[f"{cn}_{i}_kernel"] = torch.from_numpy(
                    rng.normal(size=(k, c, c)).astype(np.float32))
                bp[f"{cn}_{i}_bias"] = torch.from_numpy(rng.normal(size=c).astype(np.float32))
        out.append(bp)
    return out


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packing_round_trips(c, dtype):
    blocks = _blocks(c, c)
    packed = pack_stage_weights(blocks, KS, 3, dtype, "cpu")
    assert packed.weight.dtype == dtype and packed.bias.dtype == torch.float32
    # f32 holds each element twice: its TF32 part and the remainder
    per_element = 2 if dtype == torch.float32 else 1
    assert packed.weight.numel() == per_element * 2 * 3 * sum(KS) * c * c
    assert packed.bias.shape == (18, c)
    back = unpack_stage_weights(packed)
    for want, got in zip(blocks, back):
        assert set(want) == set(got)
        for name in want:
            assert torch.equal(got[name], want[name].to(dtype)), name


def test_bf16_fragment_order():
    """Spot-check the order the kernel reads: lane l, element e of the first
    uint4 of tap j holds W[j][2 (l % 4) + e % 2 + 8 ((e % 4) // 2)][l // 4]
    for e < 4 and column 8 + l // 4 for e >= 4."""
    c = 32
    blocks = _blocks(c, 1)
    w = blocks[0]["convs1_0_kernel"].to(torch.bfloat16)
    frag = pack_stage_weights(blocks, KS, 3, torch.bfloat16, "cpu").weight
    frag = frag[:3 * c * c].reshape(3, c // 16, c // 16, 32, 8)
    for j in range(3):
        for lane in (0, 5, 31):
            for e in range(8):
                ci = 2 * (lane % 4) + e % 2 + 8 * ((e % 4) // 2)
                co = 8 * (e // 4) + lane // 4
                assert frag[j, 0, 0, lane, e] == w[j, ci, co]
    # k-step 1, n-tile pair 1 of the last tap
    assert frag[2, 1, 1, 9, 6] == w[2, 16 + 2 * 1 + 0 + 8, 8 * 3 + 2]


def test_f32_split_fragment_order():
    """The f32 order the 3xTF32 kernel reads: per tap, (k-step kk, n-tile n,
    lane l) holds hi(W[8 kk + l % 4][8 n + l // 4]), hi(W[8 kk + l % 4 + 4][..])
    and the two remainders W - hi; hi is a TF32 value (low 13 bits 0) and
    hi + remainder gives W back bit for bit."""
    c = 64
    blocks = _blocks(c, 2)
    w = blocks[1]["convs2_2_kernel"]  # resblock 1 (k = 7), unit 2, conv2
    packed = pack_stage_weights(blocks, KS, 3, torch.float32, "cpu").weight
    first = (3 * 2 * 3 + 7 * 2 * 2 + 7) * c * c * 2  # convs before it, two floats each
    frag = packed[first:first + 7 * c * c * 2].reshape(7, c // 8, c // 8, 32, 4)
    hi, rem = frag[..., :2], frag[..., 2:]
    assert ((hi.contiguous().view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(hi, tf32_round(hi))
    for j, kk, n, lane in ((0, 0, 0, 0), (3, 2, 5, 13), (6, 7, 7, 31)):
        for e in range(2):
            want = w[j, 8 * kk + lane % 4 + 4 * e, 8 * n + lane // 4]
            assert hi[j, kk, n, lane, e] == tf32_round(want)
            assert hi[j, kk, n, lane, e] + rem[j, kk, n, lane, e] == want
    # the remainder is at most half a TF32 ulp of W
    assert (rem.abs() <= hi.abs() * 2 ** -11).all()


def test_tf32_round_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -12), 3.0 * 2 ** 100])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 ** -10, -1.0,
                         3.0 * 2 ** 100])
    assert torch.equal(tf32_round(x), want)


def test_generator_packs_once_and_sees_new_weights():
    gen = HiFiGANGenerator(**KW)
    init_random_weights(gen, torch.Generator().manual_seed(0))
    first = gen.packed_mrf(0, torch.float32, "cpu")
    assert isinstance(first, PackedStage)
    assert gen.packed_mrf(0, torch.float32, "cpu") is first  # cached
    assert gen.packed_mrf(1, torch.float32, "cpu") is not first  # per stage

    def stage0():
        return [b.kernel_params() for b in gen.resblocks[:3]]

    # a reload of weights is seen
    other = HiFiGANGenerator(**KW)
    init_random_weights(other, torch.Generator().manual_seed(1))
    gen.load_state_dict(other.state_dict())
    reloaded = gen.packed_mrf(0, torch.float32, "cpu")
    assert reloaded is not first
    for want, got in zip(stage0(), unpack_stage_weights(reloaded)):
        for name in want:
            assert torch.equal(got[name], want[name].detach()), name
    assert gen.packed_mrf(0, torch.float32, "cpu") is reloaded

    # an in-place update (an optimizer step) is seen
    with torch.no_grad():
        gen.resblocks[1].convs2[2].bias.add_(1.0)
    updated = gen.packed_mrf(0, torch.float32, "cpu")
    assert updated is not reloaded
    assert torch.equal(updated.bias[11], reloaded.bias[11] + 1.0)  # resblock 1, unit 2, conv2

    # .to(bf16): a pack per dtype, from the converted weights
    gen.to(torch.bfloat16)
    packed = gen.packed_mrf(0, torch.bfloat16, "cpu")
    assert packed.weight.dtype == torch.bfloat16
    for want, got in zip(stage0(), unpack_stage_weights(packed)):
        for name in want:
            assert torch.equal(got[name], want[name].detach()), name


def test_generator_cpu_forward_takes_the_plain_path():
    """On the CPU the generator packs nothing (the plain path needs no pack)
    and the wrapper ignores `packed`."""
    gen = HiFiGANGenerator(**KW)
    init_random_weights(gen, torch.Generator().manual_seed(2))
    mel = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 20, 8)).astype(np.float32))
    with torch.no_grad():
        gen(mel)
    assert gen._mrf_packed == {}
    x = torch.randn(1, 30, 32, generator=torch.Generator().manual_seed(3))
    blocks = _blocks(32, 4)
    packed = pack_stage_weights(blocks, KS, 3, torch.float32, "cpu")
    assert torch.equal(fused_mrf_stage(x, blocks, KS, DS, packed),
                       fused_mrf_stage(x, blocks, KS, DS))
