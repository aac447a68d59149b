"""Data-parallel training in the port (masg_tpu_torch.parallel) on the CPU:
two gloo ranks against one process on the global batch, f64, dropout off,
as masg_tpu's mesh guarantees (tests/test_mesh_trainer.py: a dp step is
the one-device step). The ranks are a pool of two spawned processes
(tests/torch_dp_cases.py) that serves this module's jobs; every job has its
own timeout.

- the plain step with grad_acc_step 2, `--use_clf`, ganlike and `use_jdit`:
  StepMetrics within rtol 1e-5 and the parameters within 1e-6 after the
  steps, the two ranks' parameters identical;
- the plain step's 2-rank run against masg_tpu's own f64 trajectory;
- PostNet's BatchNorm over the global batch and its gradient (1e-12);
- a batch that 2 does not divide runs whole on both ranks;
- GE2E (rtol 1e-6) and the HiFi-GAN GAN step (1e-5 / 1e-6), 2 against 1;
- `cli.train --n_devices 2 --device cpu` logs the losses of
  `--n_devices 1`, and its checkpoint, restored by a 1-process run,
  continues it.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_cases as cases
from masg_tpu.core import config as jcfg
from masg_tpu_torch.models import FastSpeech2
from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
from masg_tpu_torch.parallel.mesh import DataMesh, data_parallel_size
from torch_port_support import (_to64, adversarial_batches, jax_init, jax_trajectory,
                                make_batches, no_flax_dropout, port_disc_sd,
                                tiny_config)  # noqa: F401  (a fixture)

JOB_S = 60.0


@pytest.fixture(scope="module")
def pool():
    p = cases.RankPool(2, timeout_s=JOB_S)
    yield p
    p.close()


def _init_sd(use_jdit=False):
    torch.manual_seed(0)
    m = FastSpeech2.from_config(cases.tiny_config(use_jdit=use_jdit), use_flash=False)
    return {k: v.double().numpy() if v.is_floating_point() else v.numpy()
            for k, v in m.state_dict().items()}


def assert_same_run(got, want, what, rtol=1e-5, ptol=1e-6):
    (traj, params), (want_traj, want_params) = got, want
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for g, w in zip(traj, want_traj) for k in g if w[k] != 0)
    perr = max(float(np.abs(params[k] - want_params[k]).max()) for k in want_params
               if want_params[k].dtype.kind == "f")
    print(f"[dp] {what}: {len(traj)} steps, largest relative metric err {worst:.3g}, "
          f"max|param err| {perr:.3g}")
    for i, (g, w) in enumerate(zip(traj, want_traj)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-12,
                                       err_msg=f"{what}: step {i + 1} {k}")
    assert perr <= ptol, what


def assert_ranks_equal(results, what):
    p0, p1 = results[0][1], results[1][1]
    assert all(np.array_equal(p0[k], p1[k]) for k in p0), f"{what}: the replicas drifted"


@pytest.mark.parametrize("variant,acc,n", [("plain", 2, 4), ("use_clf", 1, 3),
                                           ("ganlike", 1, 3), ("jdit", 1, 3)])
def test_two_ranks_match_one(pool, variant, acc, n):
    adversarial = variant in ("use_clf", "ganlike")
    batches = (adversarial_batches(n, seed=20, jitter=variant == "ganlike") if adversarial
               else make_batches(n, seed=21))
    args = (variant, _init_sd(variant == "jdit"), port_disc_sd() if adversarial else None,
            batches, acc)
    want = cases.fs2_steps(0, 1, *args)
    got = pool.run(cases.fs2_steps, *args, timeout_s=JOB_S)
    assert_ranks_equal(got, variant)
    if adversarial:
        assert all(t["dloss"] != 0 for t in want[0])
    assert_same_run(got[0], want, f"{variant}, grad_acc_step {acc}: 2 ranks vs 1")


def test_two_ranks_match_masg_tpu(pool, no_flax_dropout):  # noqa: F811
    """The plain step over 2 ranks against masg_tpu's jitted step on one
    device, from masg_tpu's initial weights (f64, dropout off)."""
    from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax

    batches = make_batches(3, seed=0)
    cfg_j = tiny_config(jcfg)
    with jax.enable_x64(True):
        model, params, bs = jax_init(cfg_j, batches[0], dtype=jnp.float64)
        params, bs = _to64(params), _to64(bs)
        want, final, _ = jax_trajectory(cfg_j, batches, params, bs, model)
    cfg = cases.tiny_config()
    init = {k: v.numpy() for k, v in fs2_state_dict_from_jax(params, bs, cfg).items()}
    got = pool.run(cases.fs2_steps, "plain", init, None, batches, timeout_s=JOB_S)
    assert_ranks_equal(got, "plain vs masg_tpu")
    want_params = {k: v.numpy() for k, v in
                   fs2_state_dict_from_jax(final.params, final.batch_stats, cfg).items()
                   if k in got[0][1] and ("running_" in k or k in init)}
    trained = {k: got[0][1][k] for k in want_params
               if "position_enc" not in k and "_bins" not in k}
    assert_same_run((got[0][0], trained), (want, {k: want_params[k] for k in trained}),
                    "plain: 2 ranks vs masg_tpu on one device")


def test_global_batchnorm_matches_one_process(pool):
    rng = np.random.default_rng(7)
    x = rng.normal(2.0, 3.0, size=(4, 6, 8))
    cot = rng.normal(size=x.shape)
    want = cases.batchnorm(0, 1, x, cot)
    got = pool.run(cases.batchnorm, x, cot, timeout_s=JOB_S)
    out = np.concatenate([g[0] for g in got])
    dx = np.concatenate([g[1] for g in got])
    for name, a, b in (("output", out, want[0]), ("input gradient", dx, want[1])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=name)
    for g in got:  # weight, bias gradients and running statistics, on both ranks
        for a, b in zip(g[2:], want[2:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_non_divisible_batch_runs_whole(pool):
    """B = 3 over 2 ranks: every rank runs the whole batch (masg_tpu's
    replicate fallback) and takes the one-device step."""
    assert not DataMesh(2, 0).for_batch(3).sharded and DataMesh(2, 1).for_batch(3).rows(3) == \
        slice(0, 3)
    batches = [{k: v[:3] for k, v in b.items()} for b in make_batches(2, seed=22)]
    args = ("plain", _init_sd(), None, batches)
    want = cases.fs2_steps(0, 1, *args)
    got = pool.run(cases.fs2_steps, *args, timeout_s=JOB_S)
    assert_ranks_equal(got, "B = 3")
    assert_same_run(got[0], want, "B = 3 over 2 ranks (replicated) vs 1")


def test_ge2e_two_ranks_match_one(pool):
    n_spk, m_utt = 4, 4
    rng = np.random.default_rng(9)
    batches = [(rng.normal(size=(n_spk * m_utt, 20, 80)),
                np.repeat(np.arange(n_spk) % 2, m_utt).astype(np.float64)) for _ in range(3)]
    assert data_parallel_size(n_spk * m_utt, 2) == 2
    torch.manual_seed(4)
    init = {k: v.double().numpy() for k, v in
            SpeechEmbedder(n_mels=80, **cases.DISC).state_dict().items()}
    want = cases.ge2e_steps(0, 1, init, batches, n_spk, m_utt)
    got = pool.run(cases.ge2e_steps, init, batches, n_spk, m_utt, timeout_s=JOB_S)
    for g in got:
        np.testing.assert_allclose(g[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(g[1], want[1], rtol=1e-6)
        for k, v in want[2].items():
            np.testing.assert_allclose(g[2][k], v, rtol=1e-6, atol=1e-9, err_msg=k)
    print(f"[dp] GE2E 2 ranks vs 1: losses {got[0][0]} vs {want[0]}")


def test_vocoder_gan_two_ranks_match_one(pool):
    rng = np.random.default_rng(11)
    batches = [np.tanh(rng.normal(size=(4, 2048))) * 0.5 for _ in range(2)]
    want = cases.vocoder_steps(0, 1, batches)
    got = pool.run(cases.vocoder_steps, batches, timeout_s=JOB_S)
    for g in got:
        np.testing.assert_allclose(g[0], want[0], rtol=1e-5)
        err = max(float(np.abs(g[1][k] - v).max()) for k, v in want[1].items())
        assert err <= 1e-6, err
    # the spectral norm's power-iteration vectors stayed equal on both ranks
    sn = [k for k in want[1] if k.endswith("._u") or k.endswith("._v")]
    assert sn and all(np.array_equal(got[0][1][k], got[1][1][k]) for k in sn)


# ---------------------------------------------------------------------------
# cli.train over 2 processes: the launcher, the Trainer and the checkpoint
# ---------------------------------------------------------------------------

TINY_NO_DROPOUT = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                                   "decoder_hidden": 64, "conv_filter_size": 128,
                                   "encoder_dropout": 0.0, "decoder_dropout": 0.0},
                   "variance_predictor": {"filter_size": 64, "dropout": 0.0}}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """4 steps of cli.train on 1 process and on 2 (PostNet's fixed dropout
    off, every other dropout 0 in the config), and a 1-process run
    restored at the 2-process run's step 2 for 2 steps. tensorboard logs
    through its stub: TensorFlow, where installed, takes ~14 s to import."""
    import sys

    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

    if "tensorflow" not in sys.modules:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "tensorflow", None)
            return _cli_runs(tmp_path_factory, write_config_dir, write_preprocessed_corpus)
    return _cli_runs(tmp_path_factory, write_config_dir, write_preprocessed_corpus)


def _cli_runs(tmp_path_factory, write_config_dir, write_preprocessed_corpus):
    root = tmp_path_factory.mktemp("dp_cli")
    pre = write_preprocessed_corpus(str(root / "pre"), n_utts=16, n_speakers=4, n_val=4,
                                    phones=(5, 10), frames_per_phone=(1, 3))

    def cfg(name):
        return write_config_dir(str(root / name / "cfg"), pre, str(root / name / "out"),
                                model=TINY_NO_DROPOUT,
                                optimizer={"batch_size": 4, "warm_up_step": 10},
                                step={"save_step": 2, "log_step": 1, "synth_step": 1000,
                                      "val_step": 1000})

    dirs = {name: cfg(name) for name in ("one", "two", "resumed")}
    cases.train_cli(["-c", dirs["one"], "--max_steps", "4"], 1)
    cases.train_cli(["-c", dirs["two"], "--max_steps", "4"], 2)
    ckpt = root / "resumed" / "out" / "ckpt"
    ckpt.mkdir(parents=True)
    shutil.copy(root / "two" / "out" / "ckpt" / "2.pth.tar", ckpt / "2.pth.tar")
    cases.train_cli(["-c", dirs["resumed"], "--restore_step", "2", "--max_steps", "2"], 1)
    return {name: cases.losses_logged(str(root / name / "out" / "log")) for name in dirs}, root


def _assert_logged(got, want, steps, what, rtol):
    worst = 0.0
    for s in steps:
        for tag, w in want[s].items():
            np.testing.assert_allclose(got[s][tag], w, rtol=rtol[s], err_msg=f"{what}: {s} {tag}")
            worst = max(worst, abs(got[s][tag] - w) / max(abs(w), 1e-30))
    print(f"[dp] {what}: largest relative loss err {worst:.3g}")


def test_cli_train_two_processes_log_the_losses_of_one(cli_runs):
    """float32: steps 1-2 within 1e-5 relative; steps 3-4 within 1e-3, the
    float32 noise the Adam updates amplify (a 1-process run moves its step-4
    PostNet loss by 2.2e-4 relative when only its thread count changes, 1
    against 4; the f64 cases above hold 2 ranks to 1 at 1e-15)."""
    logs, root = cli_runs
    assert sorted(logs["two"]) == sorted(logs["one"]) == [1, 2, 3, 4]
    _assert_logged(logs["two"], logs["one"], [1, 2, 3, 4], "cli.train --n_devices 2 vs 1",
                   rtol={1: 1e-5, 2: 1e-5, 3: 1e-3, 4: 1e-3})
    # one checkpoint layout whatever the topology (the f64 cases above hold
    # the parameters; in float32 Adam turns the sign of near-zero gradients
    # into whole learning-rate steps)
    one = torch.load(root / "one" / "out" / "ckpt" / "4.pth.tar", weights_only=True)
    two = torch.load(root / "two" / "out" / "ckpt" / "4.pth.tar", weights_only=True)
    assert one.keys() == two.keys() and one["model"].keys() == two["model"].keys()
    assert one["optimizer"]["state"].keys() == two["optimizer"]["state"].keys()
    assert one["optimizer"]["param_groups"][0]["params"] == \
        two["optimizer"]["param_groups"][0]["params"]


def test_two_process_checkpoint_continues_in_one(cli_runs):
    logs, _ = cli_runs
    assert sorted(logs["resumed"]) == [3, 4]
    _assert_logged(logs["resumed"], logs["two"], [3, 4],
                   "2-process step-2 checkpoint resumed on 1 process", rtol={3: 1e-5, 4: 1e-4})


VOCODER_JSON = {"segment_size": 2048, "num_mels": 80, "upsample_rates": [8, 8, 4],
                "upsample_kernel_sizes": [16, 16, 8], "upsample_initial_channel": 16,
                "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
                "batch_size": 2, "mpd_periods": [2], "mpd_channels": [4, 8, 8, 8],
                "msd_scales": 1, "msd_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}


def test_cli_train_vocoder_two_processes_log_the_losses_of_one(tmp_path):
    """`cli.train_vocoder --n_devices 2 --device cpu` (1 segment a rank; the
    GAN has no dropout) logs the losses of `--n_devices 1` and writes rank
    0's checkpoints."""
    import json

    from masg_tpu_torch.cli.train_vocoder import main as train_vocoder
    from masg_tpu_torch.data.synthetic import make_synthetic_corpus

    raw, _, _ = make_synthetic_corpus(str(tmp_path), n_speakers=2, utts_per_speaker=3)
    cfg = tmp_path / "voc.json"
    cfg.write_text(json.dumps(VOCODER_JSON))
    logs = {}
    for n in (1, 2):
        out = tmp_path / f"voc{n}"
        train_vocoder(["--wav_dir", raw, "--out", str(out), "--config", str(cfg), "--steps", "2",
                       "--save_step", "2", "--log_step", "1", "--device", "cpu",
                       "--n_devices", str(n)])
        logs[n] = [json.loads(line) for line in open(out / "log.jsonl")]
        assert (out / "generator_2.pth.tar").exists() and (out / "vocoder_2.pth.tar").exists()
    assert [r["step"] for r in logs[2]] == [r["step"] for r in logs[1]] == [1, 2]
    for a, b in zip(logs[2], logs[1]):
        for k in ("disc_loss", "gen_loss", "mel_l1", "fm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=f"step {b['step']} {k}")


def test_cli_train_speech_embedder_two_processes(tmp_path):
    """`cli.train_speech_embedder --n_devices 2 --device cpu` (N x M = 4 x 2
    chunks over 2 processes): rank 0 writes the reference-format checkpoint,
    which the GE2E loader reads."""
    from masg_tpu_torch.cli.train_speech_embedder import main as ge2e_main
    from masg_tpu_torch.train.loop import load_ge2e_checkpoint

    rng = np.random.default_rng(0)
    chunks = tmp_path / "chunks"
    chunks.mkdir()
    for s in range(4):  # {dataset}_{spkr}_{gender}_{lang}.npy, (n_chunks, 80, 150)
        np.save(chunks / f'synth_s{s}_{"MF"[s % 2]}_{"ja" if s < 2 else "en"}.npy',
                rng.normal(size=(3, 80, 150)).astype(np.float32))
    out = tmp_path / "ge2e"
    ge2e_main(["--data_path", str(chunks), "--datasets", "SYNTH", "--out_dir", str(out),
               "-N", "4", "-M", "2", "--epochs", "1", "--device", "cpu", "--n_devices", "2"])
    emb = load_ge2e_checkpoint(str(out / "final_epoch_1.pth"))
    assert all(torch.isfinite(p).all() for p in emb.parameters())
