"""Fused MRF stage and HiFi-GAN generator (masg_tpu_torch) against masg_tpu:
K4's plain version against the Pallas kernel in interpret mode, the port's
generator against masg_tpu's (fused and plain), and the weight mappings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from masg_tpu.models.hifigan import ResBlock as JaxResBlock
from masg_tpu.models.hifigan import convert_torch_state_dict
from masg_tpu.ops.fused_mrf import chain_halo as jax_chain_halo
from masg_tpu.ops.fused_mrf import fused_mrf_stage as jax_fused_mrf_stage
from masg_tpu_torch.compat.from_jax import hifigan_state_dict_from_jax
from masg_tpu_torch.infer.vocoder import load_generator_checkpoint
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from masg_tpu_torch.ops.fused_mrf import chain_halo, fused_mrf_stage, fused_mrf_stage_plain
import torch_port_support  # noqa: F401  (the port tests' thread count)

# tests/test_fused_mrf.py's small generator: stages of C = 64 and C = 32
KW = dict(n_mels=8, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
          upsample_initial_channel=128, resblock_kernel_sizes=(3, 7, 11),
          resblock_dilation_sizes=((1, 3, 5),) * 3)
KS, DS = (3, 7, 11), ((1, 3, 5),) * 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_blocks(jax_blocks):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()} for b in jax_blocks]


def test_chain_halo_matches():
    for k in KS:
        assert chain_halo(k, (1, 3, 5)) == jax_chain_halo(k, (1, 3, 5))
    assert chain_halo(11, (1, 3, 5)) == 60


def test_fused_stage_plain_matches_pallas_multi_tile():
    """C=64, L=400 with 128-row tiles on the Pallas side: tile boundaries and
    both sequence edges (tests/test_fused_mrf.py's 1e-6 bar)."""
    c, length = 64, 400
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, length, c)).astype(np.float32)
    mods = [JaxResBlock(c, k, d) for k, d in zip(KS, DS)]
    blocks = [_np_tree(m.init(jax.random.PRNGKey(i), jnp.asarray(x))["params"])
              for i, m in enumerate(mods)]
    # masg_tpu's init is normal(0.01): scale each conv to std 0.25/sqrt(C*k),
    # the largest gain that keeps float32 rounding well under the 1e-6 bar
    # (outputs reach ~4.5; the chain moves them by ~0.14)
    blocks = [{n: v * (0.25 / (0.01 * np.sqrt(c * k)) if n.endswith("kernel") else 1.0)
               for n, v in b.items()} for b, k in zip(blocks, KS)]
    want = np.asarray(jax_fused_mrf_stage(jnp.asarray(x), blocks, KS, DS, tile=128,
                                          interpret=True))
    got = fused_mrf_stage_plain(torch.from_numpy(x), _torch_blocks(blocks), KS, DS)
    assert np.abs(want - x).max() > 0.1  # the stage does real work
    print(f"[parity] K4 plain vs Pallas interpret, C=64 L=400: max abs err "
          f"{np.abs(got.numpy() - want).max():.3g} (bar 1e-6)")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(fused_mrf_stage(torch.from_numpy(x), _torch_blocks(blocks), KS, DS),
                       got)


def _jax_generator_params(seed=0):
    """masg_tpu generator params with audio-range outputs: the port's
    variance-keeping random init carried over by masg_tpu's converter
    (masg_tpu's own normal(0.01) init gives outputs near 1e-4)."""
    gen = HiFiGANGenerator(**KW)
    init_random_weights(gen, torch.Generator().manual_seed(seed))
    # half the variance-keeping std: outputs stay well inside tanh's range
    sd = {k: v.numpy() * (0.5 if k.endswith("weight") else 1.0)
          for k, v in gen.state_dict().items()}
    return convert_torch_state_dict(sd, {"upsample_rates": list(KW["upsample_rates"]),
                                         "resblock_kernel_sizes": list(KS)})


@pytest.mark.parametrize("t", [37, 200])
def test_generator_fused_matches_jax_fused_interpret(t):
    params = _jax_generator_params()
    mel = np.random.default_rng(t).normal(size=(2, t, 8)).astype(np.float32)
    want = np.asarray(JaxGenerator(fused_mrf=True, fused_interpret=True, **KW).apply(
        {"params": params}, jnp.asarray(mel)))
    gen = HiFiGANGenerator(fused_mrf=True, **KW)
    gen.load_state_dict(hifigan_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, t * 16) and np.abs(want).max() > 0.05
    print(f"[parity] HiFi-GAN fused vs masg_tpu fused (interpret), T={t}: max abs err "
          f"{np.abs(got - want).max():.3g} (bar 1e-6)")
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_generator_plain_matches_jax_plain():
    params = _jax_generator_params(1)
    mel = np.random.default_rng(3).normal(size=(1, 50, 8)).astype(np.float32)
    want = np.asarray(JaxGenerator(time_packing=False, **KW).apply(
        {"params": params}, jnp.asarray(mel)))
    gen = HiFiGANGenerator(fused_mrf=False, **KW)
    gen.load_state_dict(hifigan_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    print(f"[parity] HiFi-GAN plain vs masg_tpu plain: max abs err "
          f"{np.abs(got - want).max():.3g} (bar 1e-6)")
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_hifigan_state_dict_round_trips_through_masg_tpu():
    params = _jax_generator_params(2)
    sd = {k: v.numpy() for k, v in hifigan_state_dict_from_jax(params).items()}
    back = convert_torch_state_dict(sd, {"upsample_rates": list(KW["upsample_rates"]),
                                         "resblock_kernel_sizes": list(KS)})
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


def test_weight_norm_checkpoint_folds_like_masg_tpu(tmp_path):
    """An upstream `{'generator': sd}` file with weight_g/weight_v loads to the
    same weights masg_tpu's converter folds."""
    gen = HiFiGANGenerator(fused_mrf=False, **KW)
    rng = np.random.default_rng(4)
    sd = {}
    for name, p in gen.state_dict().items():
        if name.endswith(".weight"):
            v = rng.normal(size=p.shape).astype(np.float32)
            sd[name[:-len("weight")] + "weight_v"] = torch.from_numpy(v)
            sd[name[:-len("weight")] + "weight_g"] = torch.from_numpy(
                rng.uniform(0.5, 2.0, size=(p.shape[0], 1, 1)).astype(np.float32))
        else:
            sd[name] = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
    path = tmp_path / "g.pth"
    torch.save({"generator": sd}, path)
    cfg = {"upsample_rates": list(KW["upsample_rates"]),
           "resblock_kernel_sizes": list(KS),
           "resblock_dilation_sizes": [list(d) for d in DS]}
    folded = load_generator_checkpoint(str(path), cfg)
    gen.load_state_dict(folded, strict=True)
    jax_params = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    back = hifigan_state_dict_from_jax(jax_params)
    assert set(back) == set(folded)
    for k in back:
        np.testing.assert_allclose(folded[k].numpy(), back[k].numpy(), rtol=1e-6, atol=1e-7)
