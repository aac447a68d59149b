"""Tensor-parallel training in the port (`--n_model > 1`) on the CPU: a pool of
4 spawned gloo ranks (tests/torch_tp_cases.py) split into two 2-rank meshes
(1 x 2 or 2 x 1) or one 2 x 2 or 1 x 4 (data, model) mesh a round, held
against one process on the global batch in f64 with dropout off, as
masg_tpu's mesh guarantees (tests/test_mesh_trainer.py:160, a 4 x 2 mesh
against one device). Every pool job has its own timeout.

- the Megatron operators f, g and the channel gather, value and gradient
  (a gather whose backward summed would return M times the gradient);
- the plain step with grad_acc_step 2, `--use_clf`, ganlike and `use_jdit`
  on 1 x 2 and 2 x 2, and `--param_storage bf16` on 1 x 2 (the clip binds:
  the gradient norms are ~50 against a threshold of 1);
- 1 x 2 against masg_tpu's own f64 trajectory through the sharded bridge;
- 2 heads on a model axis of 4: attention stays whole, the rest splits;
  the layers split what masg_tpu's rules name;
- dropout on: the replicated parameters stay bit-identical over the model
  ranks;
- checkpoints move between topologies, and masg_tpu reads a 1 x 2 one;
- `cli.train` and `cli.train_ganlike` with `--n_model 2 --device cpu` on the
  pool's four ranks (2 x 2) log the losses of `--n_model 1`, with samples,
  validation and checkpoints inside the run; the launcher sizes the mesh.
"""

import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_cases as dp
import torch_tp_cases as tp
from masg_tpu.core import config as jcfg
from masg_tpu_torch.core import config as tcfg
from masg_tpu_torch.models import FastSpeech2
from masg_tpu_torch.parallel.mesh import rule_dim, sharded_names
from masg_tpu_torch.parallel.tensor import ModelAxis
from test_torch_port_adversarial import adversarial_batches
from test_torch_port_parallel import _disc_sd
from test_torch_port_train import (_to64, jax_init, jax_trajectory, make_batches,
                                   no_flax_dropout)  # noqa: F401  (a fixture)

torch.set_num_threads(2)
JOB_S = 60.0
VARIANTS = ("plain", "use_clf", "ganlike", "jdit", "bf16")


@pytest.fixture(scope="module")
def pool():
    p = tp.TPPool(timeout_s=JOB_S)
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def _inputs(variant):
    """(initial weights, batches, discriminator weights) of `variant`'s runs."""
    adversarial = variant in ("use_clf", "ganlike")
    batches = (adversarial_batches(3, seed=20, jitter=variant == "ganlike") if adversarial
               else make_batches(3, seed=21))
    return tp.full_init(variant == "jdit"), batches, _disc_sd() if adversarial else None


def _spec(variant, shape, **kw):
    """A 3-step run of `variant` (bf16: the plain step under bf16 storage)."""
    init, batches, disc = _inputs(variant)
    spec = dict(shape=shape, variant="plain" if variant == "bf16" else variant, init=init,
                batches=batches, disc=disc, acc=2 if variant == "plain" else 1,
                storage="bf16" if variant == "bf16" else "f32")
    spec.update(kw)
    return spec


def _rounds(dirs):
    """The module's pool runs, two 2-rank meshes or one 4-rank mesh a round,
    each round with the one-process runs taken while the pool works on it:
    [({name: mesh spec}, {name: one-process spec})]. The checkpoints: one
    process (4 steps, saved at 2), 2 x 1 and 1 x 2 save at step 2; 1 x 2
    resumes the one-process and the 2 x 1 ones, one process the 1 x 2 one."""
    batches = make_batches(4, seed=23)
    base = dict(variant="plain", init=tp.full_init(), batches=batches)
    one = dict(base, shape=(1, 1))
    two = dict(base, shape=(1, 2))
    tail, three = batches[2:], batches[:3]
    return [
        ({"plain 1x2": _spec("plain", (1, 2)),
          "2x1 save": dict(base, shape=(2, 1), batches=batches[:2], save=(2, dirs["dp"]))},
         {"plain": _spec("plain", (1, 1)), "one save": dict(one, save=(2, dirs["one"]))}),
        ({"use_clf 1x2": _spec("use_clf", (1, 2)), "ganlike 1x2": _spec("ganlike", (1, 2))},
         {"use_clf": _spec("use_clf", (1, 1)), "ganlike": _spec("ganlike", (1, 1))}),
        ({"jdit 1x2": _spec("jdit", (1, 2)), "bf16 1x2": _spec("bf16", (1, 2))},
         {"jdit": _spec("jdit", (1, 1)), "bf16": _spec("bf16", (1, 1))}),
        ({"1x2 save": dict(two, save=(2, dirs["tp"])),
          "1->1x2": dict(two, batches=tail, restore=(2, dirs["one"]))},
         {"dropout": dict(one, dropout=True, batches=three)}),
        ({"2x1->1x2": dict(two, batches=tail, restore=(2, dirs["dp"])),
          "dropout 1x2": dict(two, dropout=True, batches=three)},
         {"1x2->1": dict(one, batches=tail, restore=(2, dirs["tp"]))}),
        *[({f"{v} 2x2": _spec(v, (2, 2))}, {}) for v in VARIANTS if v != "bf16"],
        ({"heads 1x4": _spec("plain", (1, 4), acc=1)}, {"heads": _spec("plain", (1, 1), acc=1)}),
    ]


@pytest.fixture(scope="module")
def runs(pool, tmp_path_factory):
    """({name: the mesh's rank results}, {name: the one-process result}) of
    every run of `_rounds`."""
    root = tmp_path_factory.mktemp("tp_ckpt")
    got, want = {}, {}
    for on_pool, here in _rounds({k: str(root / k) for k in ("one", "dp", "tp")}):
        specs = list(on_pool.values())
        size = specs[0]["shape"][0] * specs[0]["shape"][1]
        assert len(specs) * size == 4
        pool.submit(tp.train, specs)
        for name, spec in here.items():
            want[name] = tp.train(0, 1, [spec])
        ranks = pool.collect(JOB_S)
        for j, name in enumerate(on_pool):
            got[name] = ranks[j * size:(j + 1) * size]
    return got, want


def assert_same_metrics(traj, want_traj, what, rtol=1e-5):
    """StepMetrics within rtol, step by step."""
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for g, w in zip(traj, want_traj) for k in g if w[k] != 0)
    print(f"[tp] {what}: {len(traj)} steps, largest relative metric err {worst:.3g}")
    for i, (g, w) in enumerate(zip(traj, want_traj)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-12,
                                       err_msg=f"{what}: step {i + 1} {k}")


def assert_same_run(got, want, what, rtol=1e-5, ptol=1e-6):
    """StepMetrics within rtol, the whole final parameters within ptol."""
    (traj, params), (want_traj, want_params) = got, want
    assert_same_metrics(traj, want_traj, what, rtol)
    perr = max(float(np.abs(params[k] - want_params[k]).max()) for k in want_params
               if want_params[k].dtype.kind == "f")
    print(f"[tp] {what}: max|param err| {perr:.3g}")
    assert perr <= ptol, (what, perr)


# the key biases (softmax ignores a shift of every key's logit) and the
# conv biases before a train-mode BatchNorm (which takes the mean out): their
# gradients are 0 in exact arithmetic, rounding alone in f64 or bf16
ZERO_GRAD = re.compile(r".*(slf_attn\.w_ks|postnet\.convolutions\.\d\.0\.conv)\.bias$")


def assert_grads_near(got, want, what, tol):
    """bf16: each gradient of one backward within `tol` of the reference's
    norm (||err|| <= tol ||ref||), the ZERO_GRAD tensors left out. A
    shard's gradient counted twice is off by 1.0 of its norm."""
    assert got.keys() == want.keys(), what
    ratio = {k: float(np.linalg.norm(got[k] - w)) / float(np.linalg.norm(w))
             for k, w in want.items() if not ZERO_GRAD.match(k)}
    worst = max(ratio, key=ratio.get)
    print(f"[tp] {what}: gradients of one backward, {len(ratio)} tensors (of "
          f"{len(want)}), largest ||err|| / ||ref|| {ratio[worst]:.3g} ({worst})")
    assert ratio[worst] <= tol, (what, worst, ratio[worst])


def assert_same_grads(got, want, what, rel=1e-12, atol=1e-15):
    """The whole gradients of one backward, tensor by tensor, within `rel`
    of the tensor's largest entry plus `atol` (f64: 1e-12 and 1e-15; the
    conv biases before a BatchNorm and the key biases have a zero gradient,
    ~1e-18 of rounding). Adam's update does not see a gradient's scale, so
    the trajectories alone would miss a shard's gradient counted M times."""
    assert got.keys() == want.keys(), what
    excess = {k: float(np.abs(got[k] - w).max()) - rel * float(np.abs(w).max())
              for k, w in want.items()}
    worst = max(excess, key=excess.get)
    print(f"[tp] {what}: gradients of one backward, {len(want)} tensors, largest "
          f"max|err| - {rel:g} max|ref| {excess[worst]:.3g} ({worst})")
    assert excess[worst] <= atol, (what, worst, excess[worst])


def assert_model_ranks_agree(results, n_model, what):
    """The ranks of each model group hold the same replicated tensors, bit
    for bit, and the same whole state."""
    for g in range(0, len(results), n_model):
        first = results[g]
        for other in results[g + 1:g + n_model]:
            for k, v in first[2].items():
                assert np.array_equal(v, other[2][k]), f"{what}: {k} drifted"
            for k, v in first[1].items():
                assert np.array_equal(v, other[1][k]), f"{what}: whole {k} differs"


def test_operators_match_one_process(pool):
    """f, g and the gather on a 1 x 4 axis against the whole layers: values
    and gradients within 1e-12 (the gather's gradient is the cotangent's
    slice: a backward that summed would give 4 times it)."""
    rng = np.random.default_rng(0)
    x, w1, w2, b2 = (rng.normal(size=s) for s in ((3, 5, 8), (12, 8), (8, 12), (8,)))
    cot, cot_h = rng.normal(size=(3, 5, 8)), rng.normal(size=(3, 5, 12))
    want = tp.operators(0, 1, x, w1, w2, b2, cot, cot_h)
    got = pool.run(tp.operators, x, w1, w2, b2, cot, cot_h, timeout_s=JOB_S)
    for r, g in enumerate(got):
        cols = slice(3 * r, 3 * r + 3)
        expect = [want[0], want[1], want[2][cols], want[3][:, cols], want[4], want[5],
                  want[6][cols]]
        for name, a, b in zip(("out", "dx", "dW1", "dW2", "gathered", "dx (gather)",
                               "dW1 (gather)"), g, expect):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f"rank {r} {name}")
    np.testing.assert_allclose(want[6], cot_h.reshape(-1, 12).T @ x.reshape(-1, 8),
                               rtol=1e-12)


@pytest.mark.parametrize("n_model", [2, 4])
def test_process_group_layout(pool, n_model):
    """Rank r sits at (r // M, r % M), masg_tpu's make_mesh order; the data
    group holds the ranks of one model rank, the model group those of one
    data rank; `replicate` broadcasts data rank 0's values within the data
    group (a shard stays with its model rank)."""
    got = pool.run(tp.layout, n_model, timeout_s=JOB_S)
    n_data = 4 // n_model
    for r, (d, m, over_data, over_model, replicated) in enumerate(got):
        assert (d, m) == divmod(r, n_model)
        assert over_data == sum(range(m, 4, n_model))
        assert over_model == sum(range(d * n_model, (d + 1) * n_model))
        assert replicated == (m if n_data > 1 else r)
    assert len({g[0] for g in got}) == n_data


# bf16 storage: the model computes in bf16, so each row-parallel partial sum
# is rounded to bf16 before the reduce (one device rounds the whole sum
# once). bf16 itself moves the 3-step losses by ~1e-1 relative from f64 (the
# total by 11 % at step 3 on one process), the bar of StepMetrics here
# (read: 4.9e-2); masg_tpu's own check is the eval loss within 25 % of f32's
# (test_torch_port_param_storage.py). The gradients of the first backward,
# from the same bf16 weights, differ by up to 0.23 of a tensor's norm (read:
# the pitch predictor's output bias; most tensors 0.12-0.14), held at 0.5,
# where a shard's gradient counted twice is off by 1.0.
BF16_RTOL = 1e-1
BF16_GTOL = 0.5
CASES = [(v, s) for s in ((1, 2), (2, 2)) for v in VARIANTS if s == (1, 2) or v != "bf16"]


@pytest.mark.parametrize("variant,shape", CASES,
                         ids=[f"{v}-{s[0]}x{s[1]}" for v, s in CASES])
def test_tensor_parallel_matches_one_process(runs, variant, shape):
    """f64, dropout off, 3 steps: StepMetrics and the eval step's losses
    afterwards within rtol 1e-5, the whole parameters within 1e-6, the
    gathered gradients of one backward within 1e-12 of each tensor's largest
    entry (bf16 storage, 1 x 2: StepMetrics at BF16_RTOL and the gradients
    at BF16_GTOL against the one-process bf16 run). The model ranks agree
    bit for bit; the clip binds (grad_norm > 1)."""
    got, want = runs[0][f"{variant} {shape[0]}x{shape[1]}"], runs[1][variant]
    assert_model_ranks_agree(got, shape[1], f"{variant} {shape}")
    assert all(t["grad_norm"] > 1.0 for t in want[0])  # the clip at 1.0 binds
    if variant in ("use_clf", "ganlike"):
        assert all(t["dloss"] != 0 for t in want[0])
    what = f"{variant}, {shape[0]} x {shape[1]} vs one process"
    if variant == "bf16":
        assert_same_metrics(got[0][0], want[0], what, rtol=BF16_RTOL)
        assert_grads_near(got[0][5], want[5], what, BF16_GTOL)
    else:  # (under bf16 the eval losses read BatchNorm statistics of bf16 activations)
        assert_same_run(got[0][:2], want[:2], what)
        np.testing.assert_allclose(got[0][4], want[4], rtol=1e-5, atol=1e-12)
        assert_same_grads(got[0][5], want[5], what)
    whole = sum(v.size for k, v in want[1].items() if not k.endswith("num_batches_tracked"))
    assert got[0][3] < whole  # a rank holds its shards only


def test_one_by_two_matches_masg_tpu(pool, no_flax_dropout):  # noqa: F811
    """The plain step on 1 x 2 against masg_tpu's jitted step on one device,
    f64, dropout off, 2 steps: masg_tpu's params from the port's one-device
    weights (its own `convert_torch_fastspeech2`), then cut for each model
    rank by the sharded bridge (`fs2_state_dict_from_jax(..., model_axis=)`)."""
    from masg_tpu.compat.torch_fs2 import convert_torch_fastspeech2
    from masg_tpu.models import FastSpeech2 as JaxFastSpeech2
    from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax
    from test_torch_port_train import tiny_config as jax_tiny_config

    batches = make_batches(2, seed=0)
    cfg_j = jax_tiny_config(jcfg)
    cfg = dp.tiny_config()
    with jax.enable_x64(True):
        params, bs = map(_to64, convert_torch_fastspeech2(
            tp.full_init(), encoder_layers=2, decoder_layers=2, multi_speaker=True))
        shards = [{k: v.numpy() for k, v in fs2_state_dict_from_jax(
            params, bs, cfg, model_axis=ModelAxis(2, m)).items()} for m in range(2)]
        spec = dict(shape=(1, 2), variant="plain", init=shards, batches=batches)
        pool.submit(tp.train, [spec, spec])
        model = JaxFastSpeech2.from_config(cfg_j, dtype=jnp.float64, use_flash=False)
        want, final, _ = jax_trajectory(cfg_j, batches, params, bs, model)
    got = pool.collect(JOB_S)
    assert_model_ranks_agree(got, 2, "plain vs masg_tpu")
    assert shards[0]["postnet.convolutions.0.0.conv.weight"].shape[0] == 256
    want_params = {k: v.numpy() for k, v in
                   fs2_state_dict_from_jax(final.params, final.batch_stats, cfg).items()
                   if "position_enc" not in k and "_bins" not in k and
                   "num_batches" not in k}
    assert_same_run((got[0][0], {k: got[0][1][k] for k in want_params}),
                    (want, want_params), "plain: 1 x 2 vs masg_tpu on one device")


def _meta_model(cfg, axis):
    """The port's FastSpeech2 of `cfg` on `axis`, shapes only (no weights)."""
    with torch.device("meta"):
        return FastSpeech2.build(cfg, False, axis)


def test_heads_that_do_not_split_stay_whole(runs):
    """2 heads on a model axis of 4 (masg_tpu splits the 256 projected
    features; the port splits by whole heads): attention is replicated, the
    FFN and PostNet convs split, and the run is the one-process run."""
    names = sharded_names(_meta_model(dp.tiny_config(), ModelAxis(4, 0)))
    assert names and not any("slf_attn" in k for k in names)
    assert any("pos_ffn.w_1" in k for k in names) and any("postnet" in k for k in names)
    got, want = runs[0]["heads 1x4"], runs[1]["heads"]
    assert_model_ranks_agree(got, 4, "1 x 4")
    assert_same_run(got[0][:2], want[:2], "2 heads on 1 x 4 vs one process")
    assert_same_grads(got[0][5], want[5], "2 heads on 1 x 4 vs one process")


def _tail(run):
    return run[0][2:], run[1]


@pytest.mark.parametrize("move", ["1x2->1", "1->1x2", "2x1->1x2"])
def test_checkpoints_move_between_topologies(runs, move):
    """A step-2 checkpoint of one topology, restored on another, continues
    the uninterrupted run (masg_tpu: tests/test_mesh_trainer.py:202): the
    StepMetrics of steps 3-4 within rtol 1e-12, the final parameters within
    1e-10 (Adam's m / sqrt(v) turns the f64 rounding of a near-zero gradient
    entry into ~1e-12 of a weight per step)."""
    on_pool, here = runs
    tp_run, one_run = on_pool["1x2 save"][0], here["one save"]
    got = here[move] if move == "1x2->1" else on_pool[move][0]
    want = _tail(tp_run if move == "1x2->1" else one_run)
    assert_same_run(got[:2], want, f"checkpoint {move}", rtol=1e-12, ptol=1e-10)
    assert_same_run(_tail(tp_run), _tail(one_run), "1 x 2 vs one process, 4 steps")


def test_dropout_keeps_the_model_ranks_identical(runs):
    """Dropout on, 1 x 2, 3 steps: every rank of the model group draws the
    one-device masks (seeded from the data rank; PostNet's after its
    gather), so the replicated parameters stay bit-identical and the run is
    the one-process run with dropout."""
    got, want = runs[0]["dropout 1x2"], runs[1]["dropout"]
    assert_model_ranks_agree(got, 2, "dropout on")
    assert want[0][0]["total"] != runs[1]["one save"][0][0]["total"]  # dropout acted
    assert_same_run(got[0][:2], want[:2], "dropout on, 1 x 2 vs one process")


# ---------------------------------------------------------------------------
# the CLIs: --n_model 2 over 2 CPU processes
# ---------------------------------------------------------------------------

TINY_NO_DROPOUT = {"transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                                   "decoder_hidden": 64, "conv_filter_size": 128,
                                   "encoder_dropout": 0.0, "decoder_dropout": 0.0},
                   "variance_predictor": {"filter_size": 64, "dropout": 0.0}}


@pytest.fixture(scope="module")
def cli_runs(pool, tmp_path_factory):
    """`cli.train` and `cli.train_ganlike` for 4 steps (synth, val and save
    every 2 steps): `--n_model 2 --device cpu` on the pool's four ranks (a
    2 x 2 mesh: `main` as a joined `--multihost` process runs it), `--n_model
    1` here meanwhile; PostNet's fixed dropout off in both."""
    from masg_tpu_torch.cli import train, train_ganlike
    from masg_tpu_torch.data.synthetic import write_config_dir, write_preprocessed_corpus

    root = tmp_path_factory.mktemp("tp_cli")
    pre = write_preprocessed_corpus(str(root / "pre"), n_utts=16, n_speakers=4, n_val=4,
                                    phones=(5, 10), frames_per_phone=(1, 3))

    def config(tag):
        return write_config_dir(str(root / tag / "cfg"), pre, str(root / tag / "out"),
                                model=TINY_NO_DROPOUT,
                                optimizer={"batch_size": 4, "warm_up_step": 10},
                                step={"save_step": 2, "log_step": 1, "synth_step": 2,
                                      "val_step": 2})

    clis = {"train": train, "train_ganlike": train_ganlike}
    out = {f"{n}_{m}": (config(f"{n}_{m}"), root / f"{n}_{m}" / "out")
           for n in clis for m in (1, 2)}
    argv = ["--device", "cpu", "--max_steps", "4", "--n_model"]
    with pytest.MonkeyPatch.context() as mp:
        if "tensorflow" not in sys.modules:  # tensorboard on its stub here
            mp.setitem(sys.modules, "tensorflow", None)
        for n, cli in clis.items():
            pool.submit(tp.cli_main, n, ["-c", out[f"{n}_2"][0], *argv, "2"])
            with tp.postnet_dropout_off():
                cli.main(["-c", out[f"{n}_1"][0], *argv, "1"])
            pool.collect(3 * JOB_S)
    return out


def test_launcher_sizes_the_mesh(monkeypatch, capsys):
    """`launch_data_parallel` (`--device cpu`): n_data = data_parallel_size(
    batch, N // M) with N = `--n_devices` (default M), n_data x M ranks
    spawned; a mesh larger than N raises."""
    import argparse

    from masg_tpu_torch.parallel import distributed as D
    from masg_tpu_torch.parallel.mesh import launch_data_parallel

    spawned = []
    monkeypatch.setattr(D, "spawn", lambda fn, n, **kw: spawned.append(n))
    for n_devices, n_model, batch, world in ((None, 2, 4, 2), (4, 2, 4, 4), (6, 2, 4, 4),
                                             (8, 4, 6, 8), (8, 4, 3, 4), (None, 1, 4, None)):
        args = argparse.Namespace(n_model=n_model, n_devices=n_devices, multihost=False,
                                  device="cpu")
        spawned.clear()
        ran = launch_data_parallel(lambda a, d: "here", args, batch)
        assert spawned == ([world] if world else []), (n_devices, n_model, batch)
        assert ran == (None if world else "here")
        n_data = (world or 1) // n_model
        assert f"mesh: {{'data': {n_data}, 'model': {n_model}}}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--n_model 4 needs 4 devices"):
        launch_data_parallel(print, argparse.Namespace(n_model=4, n_devices=3, multihost=False,
                                                       device="cpu"), 4)


def _val_losses(out):
    """{step: {tag: value}} of a run's validation losses."""
    import json

    got = {}
    for line in open(out / "log" / "val" / "scalars.jsonl"):
        r = json.loads(line)
        if r["tag"].startswith("Loss/"):
            got.setdefault(r["step"], {})[r["tag"]] = r["value"]
    return got


@pytest.mark.parametrize("cli", ["train", "train_ganlike"])
def test_cli_n_model_2_logs_the_losses_of_one(cli_runs, cli):
    """float32: steps 1-2 within 1e-5 relative, 3-4 within 1e-3 (the float32
    noise Adam amplifies; see test_torch_port_parallel.py); the validation
    losses of step 2 within 1e-4 and of step 4 within 5e-2 (the eval forward
    normalises with PostNet's running statistics: changing only the thread
    count of a 1-process run, 1 against 4, moves its step-4 validation
    PostNet loss by 1.4e-2; the f64 cases above hold the eval losses at
    1e-5); both runs wrote the
    step-2 and step-4 checkpoints, the same keys and shapes."""
    (_, one), (_, two) = cli_runs[f"{cli}_1"], cli_runs[f"{cli}_2"]
    got, want = dp.losses_logged(str(two / "log")), dp.losses_logged(str(one / "log"))
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    rtol = {1: 1e-5, 2: 1e-5, 3: 1e-3, 4: 1e-3}
    for s in want:
        for tag, w in want[s].items():
            np.testing.assert_allclose(got[s][tag], w, rtol=rtol[s], err_msg=f"{s} {tag}")
    val = [_val_losses(d) for d in (two, one)]
    assert sorted(val[0]) == sorted(val[1]) == [2, 4]
    for s, losses in val[1].items():
        for tag, w in losses.items():
            np.testing.assert_allclose(val[0][s][tag], w, rtol={2: 1e-4, 4: 5e-2}[s],
                                       err_msg=f"val {s} {tag}")
    for step in (2, 4):
        a = torch.load(two / "ckpt" / f"{step}.pth.tar", weights_only=True)
        b = torch.load(one / "ckpt" / f"{step}.pth.tar", weights_only=True)
        assert a.keys() == b.keys()
        assert {k: v.shape for k, v in a["model"].items()} == \
            {k: v.shape for k, v in b["model"].items()}
        assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()


def test_masg_tpu_reads_a_tensor_parallel_checkpoint(cli_runs):
    """The `--n_model 2` run's step-2 checkpoint through what masg_tpu's
    `convert_checkpoint --torch_ckpt` runs on it (`convert_torch_fastspeech2`,
    `import_torch_optimizer`): the whole weights and Adam moments, in the
    trees of the `--n_model 1` run's checkpoint."""
    import optax

    from masg_tpu.compat.torch_fs2 import (convert_torch_fastspeech2, import_torch_optimizer,
                                           reference_param_order)
    from masg_tpu.core.config import load_config_dir
    from masg_tpu.train.optim import make_optimizer

    trees = []
    for tag in ("train_2", "train_1"):
        cfg_dir, out = cli_runs[tag]
        cfg = load_config_dir(cfg_dir)
        raw = torch.load(out / "ckpt" / "2.pth.tar", map_location="cpu", weights_only=True)
        params, _ = convert_torch_fastspeech2({k: v.numpy() for k, v in raw["model"].items()},
                                              encoder_layers=2, decoder_layers=2)
        opt = make_optimizer(cfg.train.optimizer, 64).init(params)
        opt = import_torch_optimizer(opt, raw["optimizer"],
                                     param_names=reference_param_order(2, 2))
        trees.append((params, opt))
    (params, opt), (params1, opt1) = trees
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(params1)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(params),
                                                  jax.tree.leaves(params1)))
    mu = [x for x in jax.tree.leaves(opt) if getattr(x, "ndim", 0) > 0]
    assert len(mu) == len([x for x in jax.tree.leaves(opt1) if getattr(x, "ndim", 0) > 0])
    assert any(float(np.abs(np.asarray(x)).max()) > 0 for x in mu)  # the moments came in
    del optax


FLAGSHIP = tcfg.ExperimentConfig(preprocess=tcfg.PreprocessConfig(), model=tcfg.ModelConfig(),
                                train=tcfg.TrainConfig(), stats=tcfg.Stats(),
                                speakers={f"s{i}": [i, "M", "ja"] for i in range(16)})


def test_flagship_shard_sizes():
    """At the flagship width (ModelConfig(), 16 speakers) a rank of a model
    axis of 2 holds ~18.2M of the 34.7M parameters."""
    model = _meta_model(FLAGSHIP, ModelAxis(2, 1))
    held = sum(p.numel() for p in model.parameters())
    split = sum(p.numel() for n, p in model.named_parameters() if n in sharded_names(model))
    assert held + split == 34_676_818
    assert 18.0e6 < held < 18.2e6, held


@pytest.mark.parametrize("case", ["tiny-M2", "tiny-M4", "flagship-M2", "flagship-M4"])
def test_layers_split_as_masg_tpu_rules(case):
    """The tensors the layers report as split (`sharded_params`, read by
    `sharded_names`) are those masg_tpu's rules name (`PARAM_RULES`, its
    `_PARAM_RULES` under torch names), along the same dimension, where the
    axis divides the layer; at the tiny width's 2 heads on an axis of 4,
    attention alone stays whole."""
    width, m = case.split("-M")
    cfg = dp.tiny_config() if width == "tiny" else FLAGSHIP
    model = _meta_model(cfg, ModelAxis(int(m), 0))
    ruled = {k: rule_dim(k) for k in model.state_dict() if rule_dim(k) is not None}
    if cfg.model.transformer.encoder_head % int(m):  # attention splits by whole heads
        ruled = {k: d for k, d in ruled.items() if "slf_attn" not in k}
    assert len(ruled) > 0 and sharded_names(model) == ruled
