"""The port's JDIT teacher (masg_tpu_torch.models.jdit) and its train variant
against masg_tpu's: the teacher forward in f64 and f32 with dropout patched
out on both sides, `attention_to_duration`, an f64 `use_jdit` trajectory
under masg_tpu's two-bias Adam, the f32 flash-path step against the plain
path, and `cli.train` / `cli.evaluate` / `cli.dump_mels` with
`jdit.use_jdit: true` on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masg_tpu.compat.torch_fs2 import convert_torch_fastspeech2, convert_torch_jdit
from masg_tpu.core import config as jcfg
from masg_tpu.models import FastSpeech2 as JaxFastSpeech2
from masg_tpu.models.jdit import JDIT as JaxJDIT
from masg_tpu.models.jdit import attention_to_duration as jax_attention_to_duration
from masg_tpu.train.state import create_train_state as jax_create_train_state
from masg_tpu.train.step import make_train_step as jax_make_train_step
from masg_tpu_torch.compat.from_jax import jdit_state_dict_from_jax
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models import FastSpeech2
from masg_tpu_torch.models.jdit import JDIT, attention_to_duration
from masg_tpu_torch.train.state import create_train_state
from masg_tpu_torch.train.step import batch_to_device, jdit_generator, make_train_step
from torch_port_support import (HIDDEN, METRICS, _to64, assert_params, assert_traj,
                                jax_optimizer, jax_run, jax_step, make_batches,
                                no_flax_dropout, port_model,
                                tiny_config)  # noqa: F401  (a fixture)

# teacher widths: the reference's structure at 16-32
DIMS = dict(attention_rnn_dim=32, decoder_rnn_dim=24, prenet_dim=16, attention_dim=16,
            location_filters=8, location_kernel=5)
CFG_DIMS = dict(attention_rnn_dim=32, decoder_rnn_dim=24, prenet_hidden=16, attention_dim=16,
                location_filters=8, location_kernel=5)


def no_teacher_dropout(model):
    """The port's teacher dropouts off (the parity checks' counterpart of
    patching flax's Dropout)."""
    dec = model.decoder if isinstance(model, JDIT) else model.jdit.decoder
    dec.prenet.p = dec.p_attention_dropout = dec.p_decoder_dropout = 0.0
    return model


def teacher_inputs(ftype, enc=20, b=3, length=7, t=12, seed=0):
    """Memory, teacher mels and source lengths; one row fully padded, one of
    length 1."""
    rng = np.random.default_rng(seed)
    memory = rng.normal(size=(b, length, enc)).astype(ftype)
    mels = rng.normal(size=(b, t, 80)).astype(ftype)
    return memory, mels, np.array([length, 1, 0], np.int64)[:b]


def masg_tpu_teacher_params(dtype):
    """masg_tpu `JDIT` params from a seeded port teacher, through masg_tpu's
    own torch converter (flax's eager init of the scan takes ~16 s here):
    the two torch biases fold into one."""
    torch.manual_seed(0)
    sd = JDIT(80, 20, **DIMS).state_dict()
    params = convert_torch_jdit({f"jdit.{k}": v.numpy() for k, v in sd.items()})
    return jax.tree.map(lambda x: np.asarray(x, dtype), params)


@pytest.mark.parametrize("dtype,bar", [("float64", 1e-10), ("float32", 1e-5)])
def test_teacher_matches_masg_tpu(no_flax_dropout, dtype, bar):
    """mel, gate and alignments of the port's teacher from masg_tpu's weights
    (`jdit_state_dict_from_jax`), dropout off on both sides; a fully padded
    row gets uniform weights on both, not NaN."""
    memory, mels, src_lens = teacher_inputs(dtype)
    pad = np.arange(memory.shape[1])[None, :] >= src_lens[:, None]
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32
    params = masg_tpu_teacher_params(dtype)
    with jax.enable_x64(dtype == "float64"):
        jm = JaxJDIT(n_mels=80, encoder_dim=memory.shape[2], dtype=jdtype, **DIMS)
        want = [np.asarray(x) for x in jax.jit(jm.apply)(
            {"params": params}, jnp.asarray(memory), jnp.asarray(mels), jnp.asarray(pad))]
    tdtype = getattr(torch, dtype)
    m = no_teacher_dropout(JDIT(80, memory.shape[2], **DIMS).to(tdtype))
    m.load_state_dict(jdit_state_dict_from_jax(params), strict=True)
    m.eval()
    with torch.no_grad():
        got = m(torch.from_numpy(memory), torch.from_numpy(mels), torch.from_numpy(pad),
                torch.Generator().manual_seed(0))
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"[parity] JDIT teacher {dtype}: mel / gate / alignments max abs err "
          f"{errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g} (bar {bar:g})")
    assert max(errs) <= bar, errs
    assert np.isfinite(want[2]).all()
    np.testing.assert_allclose(got[2][2].numpy(), 1.0 / memory.shape[1], rtol=1e-6)

    # durations: the alignments' argmax counts, 0 past src_len
    want_d = np.asarray(jax_attention_to_duration(jnp.asarray(want[2]), jnp.asarray(src_lens)))
    got_d = attention_to_duration(got[2], torch.from_numpy(src_lens)).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    assert got_d[1].tolist() == [mels.shape[1]] + [0] * 6 and not got_d[2].any()
    rand = np.random.default_rng(1).random((3, 12, 7))
    np.testing.assert_array_equal(
        attention_to_duration(torch.from_numpy(rand), torch.from_numpy(src_lens)).numpy(),
        np.asarray(jax_attention_to_duration(jnp.asarray(rand), jnp.asarray(src_lens))))


def test_eval_forward_repeats_and_train_masks_follow_the_seed():
    """The prenet's dropout stays on in eval, from the generator given: the
    same seed gives the same teacher mel, another seed another; the 0.1
    dropouts add to it in train mode only."""
    memory, mels, src_lens = teacher_inputs("float32")
    pad = torch.from_numpy(np.arange(7)[None, :] >= src_lens[:, None])
    m = JDIT(80, 20, **DIMS).eval()
    run = lambda seed: m(torch.from_numpy(memory), torch.from_numpy(mels), pad,  # noqa: E731
                         torch.Generator().manual_seed(seed))[0]
    with torch.no_grad():
        a, b, c = run(0), run(0), run(1)
        m.train()
        d = run(0)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def jdit_config(mod):
    cfg = tiny_config(mod)
    cfg.model.jdit.use_jdit = True
    for k, v in CFG_DIMS.items():
        setattr(cfg.model.jdit, k, v)
    return cfg


def masg_tpu_fs2_params(cfg):
    """masg_tpu FastSpeech2 + teacher params and batch_stats (f64) from a
    seeded port model, through masg_tpu's own torch converter (no eager
    flax init)."""
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in FastSpeech2.from_config(cfg).state_dict().items()}
    tr = cfg.model.transformer
    params, bs = convert_torch_fastspeech2(sd, tr.encoder_layer, tr.decoder_layer)
    return _to64(params), _to64(bs)


def test_f64_jdit_trajectory_matches(no_flax_dropout):
    """3 `use_jdit` steps from the same weights, dropout off, against masg_tpu's
    `make_train_step(use_jdit=True)` under its two-bias Adam
    (`torch_lstm_bias_compat`): StepMetrics within rtol 1e-5, the final
    parameters (the teacher's included) within 1e-6; both halves of each LSTM
    bias stay equal."""
    batches = make_batches(3, seed=40)
    cfg_j = jdit_config(jcfg)
    cfg = jdit_config(tcfg)
    params, bs = masg_tpu_fs2_params(cfg)
    with jax.enable_x64(True):
        model = JaxFastSpeech2.from_config(cfg_j, dtype=jnp.float64)
        tx = jax_optimizer(cfg_j.train.optimizer, HIDDEN, torch_lstm_bias_compat=True)
        jstate = jax_create_train_state(model, {"params": params, "batch_stats": bs}, tx)
        want, final, _ = jax_run(jax_step(jax_make_train_step, model, use_jdit=True), jstate,
                                 batches)
    m = no_teacher_dropout(port_model(cfg, params, bs, torch.float64))
    state = create_train_state(m, cfg.train.optimizer, HIDDEN)
    step = make_train_step(m, use_jdit=True)
    # grad_norm: torch's two LSTM biases per gate carry the same gradient,
    # which masg_tpu's one folded bias counts once; take the second copy out
    hh = []
    cells = (m.jdit.decoder.attention_rnn, m.jdit.decoder.decoder_rnn)
    for cell in cells:
        cell.bias_hh.register_hook(lambda g: hh.append(float(g.square().sum())))
    got = []
    for i, b in enumerate(batches):
        hh.clear()
        state, metrics = step(state, batch_to_device(b, "cpu", torch.float64), i)
        got.append({k: float(getattr(metrics, k)) for k in METRICS})
        got[-1]["grad_norm"] = (got[-1]["grad_norm"] ** 2 - sum(hh)) ** 0.5
    assert_traj(got, want, "f64 use_jdit trajectory")
    assert_params(m, cfg, final.params, final.batch_stats, "f64 use_jdit trajectory")
    for cell in cells:
        torch.testing.assert_close(cell.bias_ih, cell.bias_hh, rtol=0, atol=1e-12)


def test_f32_flash_path_jdit_step_matches_plain():
    """The f32 `use_jdit` step through the flash path's wrappers (their plain
    K1-K3 on the CPU) against the plain attention path, from the same weights
    and the same teacher masks: losses within 1e-5 relative, every gradient
    (the teacher's included) within 2e-3."""
    batch = batch_to_device(make_batches(1, seed=41, ftype=np.float32)[0], "cpu",
                            torch.float32)
    cfg = jdit_config(tcfg)
    sides = []
    for use_flash in (True, False):
        torch.manual_seed(0)
        m = FastSpeech2.from_config(cfg, use_flash=use_flash)
        for mod in m.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        total, losses, eloss, _, out = make_train_step(m, use_jdit=True).loss_fn(
            m, batch, 0, seed=7)
        total.backward()
        sides.append((m, [float(x.detach()) for x in (total, *losses, eloss)], out))
    (mk, lk, ok), (mp, lp, op) = sides
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp) if b != 0)
    zero = torch.zeros(())
    grads = {n: float(((zero if a.grad is None else a.grad)
                       - (zero if b.grad is None else b.grad)).abs().max())
             for (n, a), b in zip(mk.named_parameters(), mp.parameters())}
    print(f"[parity] f32 flash-path use_jdit step vs plain: loss err {loss_err:.3g}, "
          f"max|grad err| {max(grads.values()):.3g}")
    assert loss_err <= 1e-5 and max(grads.values()) <= 2e-3
    # every teacher tensor but the gate layer's (the loss reads no gate) is reached
    teacher = {n: a.grad for n, a in mk.named_parameters() if n.startswith("jdit.")}
    assert ok.mel_jdit is not None and all(
        (g is None) == (".gate_layer." in n) for n, g in teacher.items())
    assert all(g.abs().max() > 0 for g in teacher.values() if g is not None)
    # the eval generator: seeded from 0 whatever the call
    g1, g2 = jdit_generator(torch.device("cpu"), 0), jdit_generator(torch.device("cpu"), 0)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


TINY = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                        "decoder_hidden": 64, "conv_filter_size": 128},
        "variance_predictor": {"filter_size": 64},
        "jdit": {"use_jdit": True, **CFG_DIMS}}


def test_jdit_cli_train_evaluate_and_dump_mels(tmp_path):
    """`cli.train` 2 steps, `cli.evaluate` (twice: the same losses, the
    teacher's eval masks are seeded) and `cli.dump_mels` with
    `jdit.use_jdit: true` on the CPU."""
    from masg_tpu_torch.cli.dump_mels import main as dump_mels
    from masg_tpu_torch.cli.evaluate import main as evaluate_main
    from masg_tpu_torch.cli.train import main as train_main
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

    pre = write_preprocessed_corpus(str(tmp_path / "pre"), n_utts=8, n_speakers=2, n_val=4,
                                    phones=(5, 10), frames_per_phone=(1, 3))
    cfg_dir = write_config_dir(str(tmp_path / "cfg"), pre, str(tmp_path / "out"), model=TINY,
                               optimizer={"batch_size": 4, "warm_up_step": 10},
                               step={"save_step": 2})
    state = train_main(["-c", cfg_dir, "--device", "cpu", "--max_steps", "2"])
    assert state.step == 2 and state.model.jdit is not None
    first = evaluate_main(["-c", cfg_dir, "--restore_step", "2", "--device", "cpu"])
    second = evaluate_main(["-c", cfg_dir, "--restore_step", "2", "--device", "cpu"])
    assert first == second and len(first) == 6 and all(np.isfinite(first))
    out = tmp_path / "mels"
    dump_mels(["-c", cfg_dir, "--restore_step", "2", "--out", str(out), "--device", "cpu"])
    assert len(os.listdir(out)) > 0
