"""The port's HiFi-GAN vocoder training (masg_tpu_torch.train.vocoder,
models.hifigan_disc, data.vocoder, cli.train_vocoder) against masg_tpu's at
its tests' TINY_CFG (segment 512, hop 16, n_fft 64, periods 2/3, 2 scales):
the discriminators, weight norm's folds, spectral norm's power iterations,
the loss mel, the losses, f64 GAN trajectories (from audio and from mels,
with the per-epoch lr decay) carried across from masg_tpu's state, the
exported generator through both packages' vocoders, the datasets, and the
CLI on the CPU with a resume. masg_tpu's states are built from the port's
seeded weights (masg_tpu's own flax init takes ~30 s on the CPU)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.data import vocoder as jdata
from masg_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from masg_tpu.models.hifigan_disc import build_discriminators as jax_build_discriminators
from masg_tpu.train import vocoder as jv
from masg_tpu_torch.audio.wavio import write_wav
from masg_tpu_torch.compat.from_jax import (hifigan_disc_state_dict_from_jax,
                                            vocoder_train_state_from_jax)
from masg_tpu_torch.data import vocoder as tdata
from masg_tpu_torch.models.hifigan_disc import build_discriminators
from masg_tpu_torch.train import vocoder as tv
from test_vocoder_training import TINY_CFG, TINY_GEN, _sine_batch
import torch_port_support  # noqa: F401  (the port tests' thread count)

CFG = TINY_CFG
B, SPE, N_STEPS = 2, 2, 4  # steps_per_epoch 2: the lr decays after update 2
FRAMES = CFG["segment_size"] // CFG["hop_size"]


# ---------------------------------------------------------------------------
# port weights -> masg_tpu trees (the inverse of compat.from_jax's layouts)
# ---------------------------------------------------------------------------


def _is_sn(m):
    return (tv.parametrize.is_parametrized(m, "weight")
            and isinstance(m.parametrizations.weight[0], tv.SpectralNorm))


def _plain(module):
    """{module name: (weight, bias)} as numpy: weight norm folded, a
    spectral-norm weight unnormalised (reading it would power-iterate)."""
    return {n: ((m.parametrizations.weight.original if _is_sn(m) else m.weight)
                .detach().numpy(), m.bias.detach().numpy())
            for n, m in tv._convs(module)}


def jax_generator_tree(gen):
    convs = _plain(gen)
    n_res = len(CFG["resblock_kernel_sizes"])

    def put(out, key, name, perm):
        w, b = convs[name]
        out[f"{key}_kernel"], out[f"{key}_bias"] = np.transpose(w, perm), b

    out = {}
    put(out, "conv_pre", "conv_pre", (2, 1, 0))
    put(out, "conv_post", "conv_post", (2, 1, 0))
    for i in range(len(CFG["upsample_rates"])):
        put(out, f"ups_{i}", f"ups.{i}", (2, 0, 1))
        for j in range(n_res):
            block = out[f"resblock_{i}_{j}"] = {}
            for cn in ("convs1", "convs2"):
                for c in range(len(CFG["resblock_dilation_sizes"][j])):
                    put(block, f"{cn}_{c}", f"resblocks.{i * n_res + j}.{cn}.{c}", (2, 1, 0))
    return out


def jax_disc_trees(mpd, msd):
    def tree(d, perm):
        out = {}
        for name, (w, b) in _plain(d).items():
            key = name.replace(".", "_")
            out[f"{key}_kernel"], out[f"{key}_bias"] = np.transpose(w, perm), b
        return out

    mpd_t = {f"disc_{p}": tree(d, (2, 3, 1, 0))
             for p, d in zip(mpd.periods, mpd.discriminators)}
    msd_t = {f"disc_{i}": tree(d, (2, 1, 0)) for i, d in enumerate(msd.discriminators)}
    return mpd_t, msd_t


def _as(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def jax_state(port, dtype):
    """masg_tpu's VocoderTrainState on the port state's weights: weight norm's
    (v = w, g = ||w||) and spectral norm's crc32-seeded (u, v), as masg_tpu's
    init_vocoder_train_state makes them, and fresh AdamW states."""
    gen = _as(jax_generator_tree(port.generator), dtype)
    mpd_t, msd_t = (_as(t, dtype) for t in jax_disc_trees(port.mpd, port.msd))
    g_wn, _ = jv.weight_norm_init(gen)
    mpd_wn, _ = jv.weight_norm_init(mpd_t)
    msd_wn, sn = jv.weight_norm_init(msd_t, sn_scope=jv.SPECTRAL_NORM_SCOPE)
    sn = _as(sn, dtype)
    disc = {"mpd": mpd_wn, "msd": msd_wn}
    gen_tx, disc_tx = jv.make_optimizers(CFG, SPE)
    state = jv.VocoderTrainState(step=jnp.asarray(0, jnp.int32), gen_params=g_wn,
                                 disc_params=disc, sn_state=sn, gen_opt=gen_tx.init(g_wn),
                                 disc_opt=disc_tx.init(disc))
    return state, gen_tx, disc_tx


def jax_modules():
    return JaxGenerator(n_mels=CFG["num_mels"], **TINY_GEN), *jax_build_discriminators(CFG)


def _peak_err_of(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_close_rel(got, want, rtol, what):
    err = abs(got - want) / max(abs(want), 1e-30)
    assert err <= rtol, (what, got, want, err)
    return err


# ---------------------------------------------------------------------------
# modules, parametrizations, mels, losses
# ---------------------------------------------------------------------------


def test_discriminators_match_masg_tpu():
    """MPD and MSD logits and every feature map of (y, y_hat) within 1e-5,
    f32, on weights carried across by `hifigan_disc_state_dict_from_jax`."""
    _, mpd_j, msd_j = jax_modules()
    rng = np.random.default_rng(0)
    y = (0.3 * rng.normal(size=(B, 500))).astype(np.float32)  # 500: reflect-padded periods
    y_hat = (0.3 * rng.normal(size=(B, 500))).astype(np.float32)
    port = tv.init_vocoder_train_state(CFG, SPE, seed=5)
    mpd_t, msd_t = jax_disc_trees(port.mpd, port.msd)
    mpd, msd = build_discriminators(CFG)
    for m, sd in zip((mpd, msd), hifigan_disc_state_dict_from_jax(mpd_t, msd_t)):
        m.load_state_dict(sd, strict=True)
    err = 0.0
    for jm, params, tm in ((mpd_j, mpd_t, mpd), (msd_j, msd_t, msd)):
        want = jax.jit(jm.apply)({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
        with torch.no_grad():
            got = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
        for k in (0, 1):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                err = max(err, float(np.abs(a.numpy() - np.asarray(b)).max()))
        for k in (2, 3):
            for fa, fb in zip(got[k], want[k]):
                assert len(fa) == len(fb)
                for a, b in zip(fa, fb):  # torch channel-first, masg_tpu channel-last
                    a = a.numpy()
                    a = a.transpose(0, 2, 3, 1) if a.ndim == 4 else a.transpose(0, 2, 1)
                    assert a.shape == np.asarray(b).shape
                    err = max(err, float(np.abs(a - np.asarray(b)).max()))
    print(f"[parity] MPD + MSD logits and feature maps: max err {err:.3g}")
    assert err <= 1e-5


def _upstream_discriminators(cfg, seed):
    """Seeded MPD and MSD in upstream's `do_*` format: `torch.nn.utils.weight_norm`
    everywhere, `torch.nn.utils.spectral_norm` on the MSD's scale 0, jik876's names."""
    from torch.nn.utils import spectral_norm, weight_norm

    from masg_tpu_torch.models.hifigan_disc import init_random_weights

    mpd, msd = build_discriminators(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_random_weights(mpd, gen)
    init_random_weights(msd, gen)
    for _, m in tv._convs(mpd):
        weight_norm(m)
    for i, d in enumerate(msd.discriminators):
        for _, m in tv._convs(d):
            (spectral_norm if i == 0 else weight_norm)(m)
    assert any(k.endswith("weight_orig") for k in msd.state_dict())
    return mpd, msd


def test_upstream_discriminator_state_dicts_load():
    """Discriminators in upstream's `do_*` format load into the trainer's
    parametrized ones: the same logits and feature maps in eval mode."""
    mpd, msd = _upstream_discriminators(CFG, 11)
    state = tv.init_vocoder_train_state(CFG, SPE, seed=12)
    tv.load_upstream_discriminators(state, mpd.state_dict(), msd.state_dict())
    rng = np.random.default_rng(13)
    y, y_hat = (torch.from_numpy((0.3 * rng.normal(size=(B, 512))).astype(np.float32))
                for _ in range(2))
    err = 0.0
    for want_m, got_m in ((mpd, state.mpd), (msd, state.msd)):
        want_m.eval(), got_m.eval()
        with torch.no_grad():
            want, got = want_m(y, y_hat), got_m(y, y_hat)
        flat = lambda o: o[0] + o[1] + [f for fs in o[2] + o[3] for f in fs]  # noqa: E731
        err = max(err, max((a - b).abs().max().item() for a, b in zip(flat(got), flat(want))))
    assert err <= 1e-6, err


def _perturbed_wn_tree(tree, rng):
    """A weight-normed tree with every g scaled off ||v||, so a fold is not the identity."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x * rng.uniform(0.5, 2.0, size=x.shape)).astype(x.dtype)
        if str(path[-1].key).endswith("kernel_g") else x, tree)


def test_weight_norm_folds_match_masg_tpu():
    """(v, g) with g off ||v||, carried across: the port's parametrized
    weights (weight norm, dim 0; the input channel of `ups.i`) equal
    masg_tpu's `fold_params` within 1e-6, generator and MPD."""
    rng = np.random.default_rng(1)
    port = tv.init_vocoder_train_state(CFG, SPE, seed=6)
    state, _, _ = jax_state(port, jnp.float32)
    state = state.replace(
        gen_params=_perturbed_wn_tree(jax.device_get(state.gen_params), rng),
        disc_params=_perturbed_wn_tree(jax.device_get(state.disc_params), rng))
    vocoder_train_state_from_jax(jax.device_get(state), port)
    want_g, _ = jv.fold_params(state.gen_params, None)
    want_p, _ = jv.fold_params(state.disc_params["mpd"], None)
    got_g = jax_generator_tree(port.generator)
    got_p, _ = jax_disc_trees(port.mpd, port.msd)
    errs = [float(np.abs(np.asarray(a) - b).max()) for a, b in
            zip(jax.tree.leaves(want_g) + jax.tree.leaves(want_p),
                jax.tree.leaves(got_g) + jax.tree.leaves(got_p))]
    ups = port.generator.ups[0].parametrizations.weight.original0
    assert ups.shape == (port.generator.ups[0].in_channels, 1, 1)
    print(f"[parity] weight-norm folds (generator, MPD): max err {max(errs):.3g}")
    assert max(errs) <= 1e-6


def test_spectral_norm_power_iterations_match_masg_tpu():
    """The MSD's full-rate scale: W / sigma and (u, v) after one and after two
    train-mode accesses of each weight against masg_tpu's `fold_params(
    update_sn=True)` once and twice, within 1e-6; eval mode does not iterate."""
    port = tv.init_vocoder_train_state(CFG, SPE, seed=7)
    state, _, _ = jax_state(port, jnp.float32)
    msd_wn, sn = state.disc_params["msd"], state.sn_state
    scale = port.msd.discriminators[0]
    errs = []
    for _ in range(2):
        folded, sn = jv.fold_params(msd_wn, sn, update_sn=True)
        for name, m in tv._convs(scale):
            key = f"disc_0/{name.replace('.', '_')}_kernel"
            w = m.weight.detach().numpy()  # one power iteration (train mode)
            errs.append(np.abs(np.transpose(w, (2, 1, 0)) -
                               np.asarray(folded["disc_0"][key.split("/")[1]])).max())
            pw = m.parametrizations.weight[0]
            errs.append(np.abs(pw._u.numpy() - np.asarray(sn[key]["u"])).max())
            errs.append(np.abs(pw._v.numpy() - np.asarray(sn[key]["v"])).max())
    scale.eval()
    u = scale.convs[0].parametrizations.weight[0]._u.clone()
    scale.convs[0].weight
    assert torch.equal(u, scale.convs[0].parametrizations.weight[0]._u)
    print(f"[parity] spectral norm, 2 power iterations: max err {max(errs):.3g}")
    assert max(errs) <= 1e-6


@pytest.mark.parametrize("f_max", [8000, None])
def test_mel_spectrogram_hifigan_matches_masg_tpu(f_max):
    rng = np.random.default_rng(2)
    audio = (0.3 * rng.normal(size=(B, 2048))).astype(np.float32)
    kw = tv.mel_kwargs(CFG)
    want = np.asarray(jv.mel_spectrogram_hifigan(jnp.asarray(audio), f_max=f_max, **kw))
    got = tv.mel_spectrogram_hifigan(torch.from_numpy(audio), f_max=f_max, **kw).numpy()
    assert got.shape == want.shape == (B, 2048 // CFG["hop_size"], CFG["num_mels"])
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"[parity] mel_spectrogram_hifigan f_max={f_max}: {err:.3g} of the peak")
    assert err <= 1e-5


def test_gan_losses_match_masg_tpu():
    rng = np.random.default_rng(3)
    dr = [rng.normal(size=(2, 7)) for _ in range(3)]
    dg = [rng.normal(size=(2, 7)) for _ in range(3)]
    fr = [[rng.normal(size=(2, 4, 3)) for _ in range(2)] for _ in range(3)]
    fg = [[rng.normal(size=(2, 4, 3)) for _ in range(2)] for _ in range(3)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x, jnp.float32) for x in xs]  # noqa: E731
    pairs = [(tv.discriminator_loss(t(dr), t(dg)), jv.discriminator_loss(j(dr), j(dg))),
             (tv.generator_adv_loss(t(dg)), jv.generator_adv_loss(j(dg))),
             (tv.feature_loss([t(f) for f in fr], [t(f) for f in fg]),
              jv.feature_loss([j(f) for f in fr], [j(f) for f in fg]))]
    for got, want in pairs:
        assert_close_rel(float(got), float(want), 1e-6, "loss")


# ---------------------------------------------------------------------------
# the GAN step
# ---------------------------------------------------------------------------


def _batches(from_mels, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        audio = _sine_batch(rng, B, CFG["segment_size"]).astype(np.float64)
        if from_mels:
            mels = rng.normal(-4.0, 1.0, size=(B, FRAMES, CFG["num_mels"]))
            out.append((mels, audio))
        else:
            out.append(audio)
    return out


def _state_tensors(state):
    """Every parameter and buffer, folded weights and (u, v) included."""
    out = {}
    for name in ("generator", "mpd", "msd"):
        mod = getattr(state, name)
        out.update({f"{name}.{k}": v.detach().clone() for k, v in mod.state_dict().items()})
        out.update({f"{name}.{n}.folded": m.weight.detach().clone()
                    for n, m in tv._convs(mod) if not _is_sn(m)})
    return out


@pytest.mark.parametrize("from_mels", [False, True])
def test_gan_f64_trajectory_matches_masg_tpu(from_mels):
    """4 f64 GAN steps, steps_per_epoch 2 (the lr decays after update 2),
    from audio and from given mels: every VocoderMetrics field within 1e-5
    relative; then every parameter (weight norm's v and g, spectral norm's
    original), the folded weights and the spectral-norm (u, v) within 1e-6."""
    batches = _batches(from_mels, seed=10 + from_mels)
    port = tv.init_vocoder_train_state(CFG, SPE, seed=8, dtype=torch.float64)
    with jax.enable_x64(True):
        state, gen_tx, disc_tx = jax_state(port, jnp.float64)
        vocoder_train_state_from_jax(jax.device_get(state), port)
        step_j = jax.jit(jv.make_vocoder_train_step(*jax_modules(), gen_tx, disc_tx, CFG,
                                                    from_mels=from_mels))
        want = []
        for b in batches:
            state, m = step_j(state, jax.tree.map(jnp.asarray, b))
            want.append([float(x) for x in m])
        final = jax.device_get(state)
    step = tv.make_vocoder_train_step(CFG, from_mels=from_mels)
    worst = 0.0
    for b, w in zip(batches, want):
        port, m = step(port, tuple(map(torch.from_numpy, b)) if from_mels
                       else torch.from_numpy(b))
        for got, ref, name in zip(m, w, tv.VocoderMetrics._fields):
            worst = max(worst, assert_close_rel(float(got), ref, 1e-5, name))
    assert port.step == N_STEPS and port.schedule(N_STEPS - 1) < port.schedule(0)
    ref = vocoder_train_state_from_jax(final, tv.init_vocoder_train_state(
        CFG, SPE, dtype=torch.float64))
    got_t, want_t = _state_tensors(port), _state_tensors(ref)
    assert got_t.keys() == want_t.keys() and any("._u" in k for k in got_t)
    perr = max((got_t[k] - want_t[k]).abs().max().item() for k in got_t)
    print(f"[parity] GAN f64 trajectory from_mels={from_mels}: metrics {worst:.3g} relative, "
          f"parameters, folds and (u, v) {perr:.3g}")
    assert perr <= 1e-6


def test_trainer_generator_is_plain_and_every_parameter_learns():
    """The trainer's generator runs the plain MRF (K4 has no backward), and
    one step gives every generator parameter a nonzero gradient; the
    generator's backward leaves the discriminators' gradients as their own
    update saw them."""
    port = tv.init_vocoder_train_state(CFG, SPE, seed=9)
    assert port.generator.fused_mrf is False
    seen = {}
    d_step = port.disc_opt.step

    def spy(*args, **kwargs):
        seen["grads"] = [p.grad.clone() for p in port.disc_params()]
        return d_step(*args, **kwargs)

    port.disc_opt.step = spy
    audio = torch.from_numpy(_sine_batch(np.random.default_rng(4), B, CFG["segment_size"]))
    port, _ = tv.make_vocoder_train_step(CFG)(port, audio)
    names = [n for n, p in port.generator.named_parameters()
             if p.grad is None or not bool(p.grad.abs().max() > 0)]
    assert names == []
    assert all(torch.equal(g, p.grad) for g, p in zip(seen["grads"], port.disc_params()))


# ---------------------------------------------------------------------------
# datasets, export, CLI
# ---------------------------------------------------------------------------


def _wav_corpus(root, rng, n=5):
    wav_dir = os.path.join(root, "wavs", "spk")
    mel_dir = os.path.join(root, "mels")
    os.makedirs(wav_dir)
    os.makedirs(mel_dir)
    for i in range(n):
        length = [4000, 300, 5200, 2600, 4100][i % 5]  # one shorter than a segment
        write_wav(os.path.join(wav_dir, f"u{i}.wav"), 0.6 * _sine_batch(rng, 1, length)[0],
                  22050)
        np.save(os.path.join(mel_dir, f"spk-mel-u{i}.npy"),
                rng.normal(size=(length // 16 + 3, CFG["num_mels"])).astype(np.float32))
    return os.path.join(root, "wavs"), mel_dir


def test_datasets_match_masg_tpu(tmp_path):
    """VocoderSegmentDataset (normalized and raw) and VocoderFineTuneDataset
    give masg_tpu's batches bit for bit over 3 epochs of crops."""
    wav_dir, mel_dir = _wav_corpus(str(tmp_path), np.random.default_rng(5))
    paths = tdata.list_wavs(wav_dir)
    assert paths == jdata.list_wavs(wav_dir)
    for normalize in (True, False):
        got = tdata.VocoderSegmentDataset(paths, 512, seed=3, normalize=normalize)
        want = jdata.VocoderSegmentDataset(paths, 512, seed=3, normalize=normalize)
        for a, b in zip(got.batches(2, num_steps=6), want.batches(2, num_steps=6)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    got = tdata.VocoderFineTuneDataset(mel_dir, wav_dir, 512, 16, seed=4)
    want = jdata.VocoderFineTuneDataset(mel_dir, wav_dir, 512, 16, seed=4)
    assert got.pairs == want.pairs and got.steps_per_epoch(2) == want.steps_per_epoch(2)
    for (ma, aa), (mb, ab) in zip(got.batches(2, num_steps=6), want.batches(2, num_steps=6)):
        assert np.array_equal(ma, mb) and np.array_equal(aa, ab)


def _two_datasets(root, seed):
    wav_dir, mel_dir = _wav_corpus(root, np.random.default_rng(seed))
    return {"segment": lambda: tdata.VocoderSegmentDataset(tdata.list_wavs(wav_dir), 512,
                                                          seed=3),
            "finetune": lambda: tdata.VocoderFineTuneDataset(mel_dir, wav_dir, 512, 16, seed=4)}


def _batch_arrays(batch):
    return batch if isinstance(batch, tuple) else (batch,)


@pytest.mark.parametrize("kind", ["segment", "finetune"])
def test_dataset_stream_state_resumes(tmp_path, kind):
    """A dataset given the stream state saved after 3 batches (mid-epoch: 5
    items, batches of 2), round-tripped through `torch.save` and
    `torch.load(weights_only=True)` as a checkpoint holds it, yields the
    uninterrupted stream's batches 4-7 bit for bit, across two new epochs."""
    make = _two_datasets(str(tmp_path), 8)[kind]
    whole, first = make(), make()
    want = list(whole.batches(2, num_steps=7))[3:]
    for _ in first.batches(2, num_steps=3):
        pass
    path = os.path.join(str(tmp_path), "stream.pt")
    torch.save({"data_stream": first.stream_state()}, path)
    resumed = make()
    resumed.load_stream_state(torch.load(path, weights_only=True)["data_stream"])
    got = list(resumed.batches(2, num_steps=4))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(_batch_arrays(a), _batch_arrays(b)))


@pytest.mark.parametrize("kind", ["segment", "finetune"])
def test_datasets_refuse_fewer_items_than_a_batch(tmp_path, kind):
    """5 items cannot fill a batch of 6: `batches` and `steps_per_epoch` raise
    at once, where masg_tpu's stream spins forever drawing permutations."""
    dataset = _two_datasets(str(tmp_path), 9)[kind]()
    assert dataset.steps_per_epoch(5) == 1
    with pytest.raises(ValueError, match="cannot fill a batch of 6"):
        dataset.batches(6)
    with pytest.raises(ValueError, match="cannot fill a batch of 6"):
        dataset.steps_per_epoch(6)


def _cli_config(root, **extra):
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump({**CFG, "batch_size": 2, **extra}, f)
    return path


def _log(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_vocoder_cli_restores_and_exports(tmp_path):
    """`cli.train_vocoder --device cpu`: 4 steps from audio, then a run
    restored at step 2 repeats steps 3-4 bit for bit (losses, and the step-4
    generator); `--mel_dir` fine-tunes 2 steps from the step-4 generator;
    the exported `generator_4.pth.tar` vocodes through the port's
    `get_vocoder` and masg_tpu's `load_generator_checkpoint` + `Vocoder`
    within 2 LSB."""
    from masg_tpu.infer.vocoder import Vocoder as JaxVocoder
    from masg_tpu.infer.vocoder import load_generator_checkpoint as jax_load_generator
    from masg_tpu_torch.cli.train_vocoder import main
    from masg_tpu_torch.core.config import ModelConfig
    from masg_tpu_torch.infer.vocoder import get_vocoder, vocoder_infer

    root = str(tmp_path)
    wav_dir, mel_dir = _wav_corpus(root, np.random.default_rng(6))
    # three dilation units: masg_tpu's torch-checkpoint reader takes the reference's three
    dils = {"resblock_dilation_sizes": [[1, 3, 5]]}
    cfg = _cli_config(root, **dils)
    common = ["--wav_dir", wav_dir, "--config", cfg, "--log_step", "1", "--device", "cpu"]
    out1, out2 = os.path.join(root, "a"), os.path.join(root, "b")
    main([*common, "--out", out1, "--steps", "4", "--save_step", "2"])
    main([*common, "--out", out2, "--steps", "4", "--save_step", "2",
          "--restore", os.path.join(out1, "vocoder_2.pth.tar")])
    first, resumed = _log(out1), _log(out2)
    assert [r["step"] for r in first] == [1, 2, 3, 4] and [r["step"] for r in resumed] == [3, 4]
    keys = ("disc_loss", "gen_loss", "mel_l1", "fm")
    assert [[r[k] for k in keys] for r in first[2:]] == [[r[k] for k in keys] for r in resumed]
    g1 = torch.load(os.path.join(out1, "generator_4.pth.tar"), weights_only=True)["generator"]
    g2 = torch.load(os.path.join(out2, "generator_4.pth.tar"), weights_only=True)["generator"]
    assert all(torch.equal(g1[k], g2[k]) for k in g1)

    # fine-tuning from the step-4 generator and upstream-format discriminators
    out3 = os.path.join(root, "ft")
    mpd, msd = _upstream_discriminators(CFG, 14)
    do_path = os.path.join(root, "do_00000004")
    torch.save({"mpd": mpd.state_dict(), "msd": msd.state_dict(), "steps": 4}, do_path)
    main([*common, "--out", out3, "--steps", "2", "--save_step", "2", "--mel_dir", mel_dir,
          "--warm_start_generator", os.path.join(out1, "generator_4.pth.tar"),
          "--warm_start_discriminators", do_path])
    assert [r["step"] for r in _log(out3)] == [1, 2]
    assert all(np.isfinite(r["gen_loss"]) for r in _log(out3))

    # the export through both packages' vocoders (hifigan_config.json: the tiny generator)
    with open(os.path.join(root, "hifigan_config.json"), "w") as f:
        json.dump({**CFG, **dils}, f)
    ckpt = os.path.join(out1, "generator_4.pth.tar")
    voc = get_vocoder(ModelConfig(), config_dir=root, checkpoint=ckpt, device="cpu")
    mel = np.random.default_rng(7).normal(-4.0, 1.0, size=(1, 40, CFG["num_mels"]))
    got = vocoder_infer(torch.from_numpy(mel.astype(np.float32)), voc)[0]
    jgen = JaxGenerator(n_mels=CFG["num_mels"], **{**TINY_GEN, "resblock_dilation_sizes": ((1, 3, 5),)})
    jvoc = JaxVocoder(jgen, jax_load_generator(ckpt, jgen, {**CFG, **dils}),
                      hop_length=CFG["hop_size"])
    want = np.clip(np.asarray(jvoc(jnp.asarray(mel, jnp.float32)))[0] * 32768.0,
                   -32768, 32767).astype(np.int16)
    lsb = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    wav_err = _peak_err_of(voc(torch.from_numpy(mel.astype(np.float32)))[0].numpy(),
                           np.asarray(jvoc(jnp.asarray(mel, jnp.float32)))[0])
    print(f"[parity] exported generator, port vs masg_tpu vocoder: {lsb} LSB "
          f"(peak {int(np.abs(want.astype(np.int32)).max())}); float wav {wav_err:.3g} of the peak")
    assert got.shape == want.shape and lsb <= 2 and wav_err <= 1e-5
