"""The port's test harness: what several tests/test_torch_port_*.py modules
share, the one CPU thread count of the port's tests, and masg_tpu's
references, each built once per process.

Nearly all of a parity test's time is masg_tpu's side. Flax's eager `init`
compiles some 300 small XLA programs, and each jitted train step compiles for
seconds to a minute. So `jax_variables` runs `init` under `jax.jit` (the same
variables bit for bit as the eager init on every module built through it; the
hidden-32 FastSpeech2 of the fs2 and e2e files, whose jitted init differs by an
ulp, keeps the eager one), and inits, optimizers and jitted steps are memoised
by what determines them: a module's fields, its dtype, x64, and the inputs'
shapes and dtypes. Every caller of a memoised init gets its own numpy copy, so
no test can change another test's reference. `jax_run` hands a step its state
in the form each step returns, so that a step compiles once and not again on
its second call.

A port test module imports what it uses from here (a fixture too, so that
pytest finds it by name) and imports no other port test module.

Importing this module loads no JAX: jax, flax and masg_tpu are imported in
the functions that build masg_tpu's references, so that the card's tests,
which run without tests/conftest.py and without JAX, import it too.
"""

import copy
import hashlib
import sys

import numpy as np
import pytest
import torch

from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax, ge2e_state_dict_from_jax
from masg_tpu_torch.models import FastSpeech2
from masg_tpu_torch.models import speaker_encoder as tse

# The port's tests run at 2 CPU threads, alone or under xdist: the f32 bars
# were set at this count.
torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# memoised masg_tpu references
# ---------------------------------------------------------------------------

_MEMO = {}


def _identity_dropout(self, x, deterministic=None, rng=None):
    return x


def _flax_dropout_off():
    """Whether `no_flax_dropout` is in force."""
    fnn = sys.modules.get("flax.linen")
    return fnn is not None and fnn.Dropout.__call__ is _identity_dropout


def memo(key, build):
    """`build()` once per process for each `key` and each state of
    `no_flax_dropout`: a step traced with flax's Dropout as the identity is
    never handed to a test that runs it live, nor the reverse."""
    key = (key, _flax_dropout_off())
    if key not in _MEMO:
        _MEMO[key] = build()
    return _MEMO[key]


def _x64():
    import jax

    return jax.dtypes.canonicalize_dtype(np.float64) == np.float64


def _is_array(x):
    import jax

    return isinstance(x, (np.ndarray, np.generic, jax.Array))


def digest(tree):
    """A key for a pytree of arrays by value."""
    import jax

    h = hashlib.sha1()
    for x in jax.tree.leaves(tree):
        a = np.asarray(x)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _key(kw):
    """A hashable key for keyword arguments: arrays by value, modules and
    everything else by their fields."""
    import jax

    return tuple(sorted((k, digest(v) if any(_is_array(x) for x in jax.tree.leaves(v))
                         else repr(v)) for k, v in kw.items()))


def jax_variables(module, rngs, *args, **kwargs):
    """`module.init(rngs, *args, **kwargs)` under `jax.jit`, memoised by the
    module's fields, the rngs, x64 and the arguments' shapes and dtypes:
    masg_tpu's inits draw nothing from the inputs' values. `rngs` is a PRNG
    key, a seed, or a dict of either by collection; arguments that are not
    arrays are static. Returns a numpy copy of the variables."""
    import flax.linen as fnn
    import jax

    as_key = lambda r: jax.random.PRNGKey(r) if isinstance(r, int) else r  # noqa: E731
    rngs = ({k: as_key(v) for k, v in rngs.items()} if isinstance(rngs, dict)
            else as_key(rngs))
    flat, tree = jax.tree.flatten((args, kwargs))
    arrays = [i for i, x in enumerate(flat) if _is_array(x)]
    key = ("init", repr(module), _x64(), digest(rngs), jax.tree.structure(rngs), tree,
           tuple((tuple(np.shape(x)), np.dtype(x.dtype).str) if i in arrays else repr(x)
                 for i, x in enumerate(flat)))

    def build():
        statics = list(flat)

        def init(rngs, values):
            full = list(statics)
            for i, v in zip(arrays, values):
                full[i] = v
            a, kw = jax.tree.unflatten(tree, full)
            return fnn.Module.init(module, rngs, *a, **kw)

        return jax.device_get(jax.jit(init)(rngs, [flat[i] for i in arrays]))

    return jax.tree.map(np.copy, memo(key, build))


def masg_tpu_engine(cfg, **kw):
    """masg_tpu's ServingEngine for `cfg`, its FastSpeech2 initialised through
    `jax_variables` in place of flax's eager init (the same variables bit for
    bit on tests/test_fastspeech2.py's tiny_config). The engine runs that
    init in `load_model` even when it is given `variables=`."""
    from masg_tpu.infer.serving import ServingEngine
    from masg_tpu.models import FastSpeech2 as JaxFastSpeech2

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxFastSpeech2, "init", jax_variables)
        return ServingEngine(cfg, **kw)


def jax_optimizer(opt_cfg, hidden, **kw):
    """masg_tpu's `make_optimizer`, one per argument set: a train state keeps
    its optimizer as static data, so a step reused with an equal optimizer
    from another call would trace and compile again."""
    from masg_tpu.train.optim import make_optimizer as jax_make_optimizer

    return memo(("optimizer", repr(opt_cfg), hidden, _key(kw)),
                lambda: jax_make_optimizer(opt_cfg, hidden, **kw))


def jax_step(make_step, model, **kw):
    """`jax.jit(make_step(model, **kw))`, one per (make_step, model, kw): a
    step built twice with the same arguments compiles once."""
    import jax

    key = ("step", make_step.__module__, make_step.__qualname__, repr(model), _key(kw))
    return memo(key, lambda: jax.jit(make_step(model, **kw)))


def jax_run(step_fn, state, batches, first=0, keep_after=None):
    """masg_tpu's jitted `step_fn` from `state` over `batches`, the i-th step
    drawing from PRNGKey(first + i): (each step's METRICS, the final state,
    the state after `keep_after` steps). The state goes in as strongly typed
    device arrays, as each step returns it (a fresh state's step counter is a
    weakly typed Python int, a fetched one a numpy scalar), so that a step
    compiles once for every state it is given; on the f64 trajectory this
    leaves every metric and the final state bit for bit as they were."""
    import jax
    import jax.numpy as jnp

    state = jax.tree.map(lambda x: jnp.asarray(x, jnp.result_type(x)), state)
    traj, kept = [], None
    for i, b in enumerate(batches):
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(first + i))
        traj.append({k: float(getattr(m, k)) for k in METRICS})
        if keep_after == i + 1:
            kept = jax.device_get(state)
    return traj, jax.device_get(state), kept


# ---------------------------------------------------------------------------
# the tiny FastSpeech2 of the train-step parity tests
# ---------------------------------------------------------------------------

B, L, T, HIDDEN = 4, 9, 40, 64
WARMUP = 10  # a short warm-up, so that the lr moves the weights
METRICS = ("total", "mel", "postnet_mel", "pitch", "energy", "duration", "speaker_prior",
           "dloss", "grad_norm")


def tiny_config(mod, grad_acc_step=1):
    """2 + 2 layers, hidden 64 (as masg_tpu/data/synthetic.py writes it), 4 speakers."""
    cfg = mod.ExperimentConfig(
        preprocess=mod.PreprocessConfig(), model=mod.ModelConfig(), train=mod.TrainConfig(),
        stats=mod.Stats(pitch=(-3.0, 3.0, 0.0, 1.0), energy=(-3.0, 3.0, 0.0, 1.0)),
        speakers={f"spk{i}": [i, "MF"[i % 2], "ja" if i < 2 else "en"] for i in range(4)})
    tr = cfg.model.transformer
    tr.encoder_layer = tr.decoder_layer = 2
    tr.encoder_hidden = tr.decoder_hidden = HIDDEN
    tr.conv_filter_size = 128
    cfg.model.variance_predictor.filter_size = 64
    opt = cfg.train.optimizer
    opt.warm_up_step, opt.grad_acc_step = WARMUP, grad_acc_step
    opt.betas, opt.eps, opt.weight_decay, opt.grad_clip_thresh = (0.9, 0.98), 1e-6, 0.0, 1.0
    return cfg


def port_tiny_config():
    """The port's copy of masg_tpu's tiny_config (tests/test_fastspeech2.py)."""
    from masg_tpu_torch.core.config import (ExperimentConfig, ModelConfig, PreprocessConfig,
                                            Stats, TrainConfig)

    cfg = ExperimentConfig(preprocess=PreprocessConfig(), model=ModelConfig(),
                           train=TrainConfig(), stats=Stats(pitch=(-2.0, 9.0, 0.0, 1.0),
                                                            energy=(-1.5, 8.0, 0.0, 1.0)),
                           speakers={f"spk{i}": [i, "M", "ja"] for i in range(4)})
    tr = cfg.model.transformer
    tr.encoder_layer = tr.decoder_layer = 2
    tr.encoder_hidden = tr.decoder_hidden = 64
    tr.conv_filter_size = 128
    cfg.model.variance_predictor.filter_size = 64
    return cfg


def make_batches(n, seed, ftype=np.float64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        texts = rng.integers(1, 100, size=(B, L)).astype(np.int32)
        src_lens = np.full(B, L, np.int32)
        src_lens[1] = L - 2
        texts[1, L - 2:] = 0
        durations = rng.integers(1, 4, size=(B, L)).astype(np.int32)
        durations[1, L - 2:] = 0
        meta = np.zeros((B, 4), ftype)
        meta[np.arange(B), rng.integers(0, 2, size=B)] = 1.0
        meta[np.arange(B), 2 + rng.integers(0, 2, size=B)] = 1.0
        out.append(dict(
            speakers=rng.integers(0, 4, size=B).astype(np.int32), texts=texts,
            src_lens=src_lens, accents=rng.integers(0, 5, size=(B, L)).astype(np.int32),
            durations=durations, mel_lens=durations.sum(1).astype(np.int32),
            mels=rng.normal(size=(B, T, 80)).astype(ftype),
            pitches=rng.normal(size=(B, L)).astype(ftype),
            energies=rng.normal(size=(B, L)).astype(ftype), speaker_meta=meta))
    return out


def _to64(tree):
    import jax

    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x),
                        tree)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def no_flax_dropout():
    """flax's Dropout as the identity. JDIT's always-on prenet sets
    `deterministic` in its constructor and rejects a second value at call
    time, so the patch takes any."""
    import flax.linen as fnn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", _identity_dropout)
        yield


def jax_init(cfg, batch, use_flash=False, dtype=None):
    """masg_tpu's FastSpeech2 for `cfg` and its initial params and BatchNorm
    statistics, from a train batch's shapes; `dtype` defaults to f32."""
    import jax.numpy as jnp
    from masg_tpu.models import FastSpeech2 as JaxFastSpeech2

    model = JaxFastSpeech2.from_config(cfg, dtype=dtype or jnp.float32, use_flash=use_flash)
    variables = jax_variables(
        model, 0, *(batch[k] for k in ("speakers", "texts", "src_lens")), T,
        mel_lens=batch["mel_lens"], p_targets=batch["pitches"], e_targets=batch["energies"],
        d_targets=batch["durations"], accents=batch["accents"],
        speaker_meta=batch["speaker_meta"])
    return model, variables["params"], variables["batch_stats"]


def jax_trajectory(cfg, batches, params, batch_stats, model, keep_after=None):
    """masg_tpu's jitted train step over `batches`: (metrics per step, final
    state, state after `keep_after` steps)."""
    from masg_tpu.train.state import create_train_state as jax_create_train_state
    from masg_tpu.train.step import make_train_step as jax_make_train_step

    tx = jax_optimizer(cfg.train.optimizer, HIDDEN)
    state = jax_create_train_state(model, {"params": params, "batch_stats": batch_stats}, tx)
    return jax_run(jax_step(jax_make_train_step, model), state, batches,
                   keep_after=keep_after)


def port_model(cfg, params, batch_stats, dtype, use_flash=False):
    m = FastSpeech2.from_config(cfg, use_flash=use_flash).to(dtype)
    m.load_state_dict(fs2_state_dict_from_jax(params, batch_stats, cfg), strict=True)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return m


def assert_traj(got, want, what, rtol=1e-5, atol=1e-8):
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for g, w in zip(got, want) for k in METRICS if w[k] != 0)
    print(f"[parity] {what}: {len(got)} steps, largest relative metric err {worst:.3g}")
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what}: step {i + 1} {k}")


def assert_params(model, cfg, params, batch_stats, what, rtol=1e-6, atol=1e-9):
    want = fs2_state_dict_from_jax(params, batch_stats, cfg)
    got = model.state_dict()
    names = {n for n, _ in model.named_parameters()}
    checked = [n for n in want if n in names or "running_" in n]
    worst = max(float((got[n].double() - want[n].double()).abs().max()) for n in checked)
    print(f"[parity] {what}: final parameters and BatchNorm statistics, max abs err {worst:.3g}")
    for n in checked:
        np.testing.assert_allclose(got[n].double().numpy(), want[n].double().numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what}: {n}")


# ---------------------------------------------------------------------------
# the adversarial trainers' GE2E discriminator
# ---------------------------------------------------------------------------

D_HIDDEN, D_LAYERS, D_PROJ = 32, 2, 16
TOTAL_STEP = 100


def adversarial_batches(n, seed, ftype=np.float64, jitter=False):
    """make_batches' batches with the reference's draws injected: a speaker
    shuffle (`reorder`) and, for ganlike, the label jitter (one chunk per row
    at T = 40)."""
    rng = np.random.default_rng(seed + 1000)
    out = make_batches(n, seed, ftype)
    for b in out:
        b["reorder"] = rng.permutation(B).astype(np.int32)
        if jitter:
            b["lang_jitter"] = rng.uniform(size=B).astype(ftype)
    return out


def jax_discriminator(dtype=None):
    """masg_tpu's GE2E discriminator and its params, f64 unless `dtype`."""
    import jax
    import jax.numpy as jnp
    from masg_tpu.models import speaker_encoder as jse

    dtype = dtype or jnp.float64
    jd = jse.SpeechEmbedder(n_mels=80, hidden=D_HIDDEN, n_layers=D_LAYERS, proj=D_PROJ,
                            dtype=dtype)
    p = jax_variables(jd, 3, jnp.zeros((2, 150, 80), dtype))["params"]
    rng = np.random.default_rng(5)
    # every parameter moved off its init, the LSTM biases off 0
    p = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype), p)
    return jd, p


def port_discriminator(params, dtype):
    td = tse.SpeechEmbedder(n_mels=80, hidden=D_HIDDEN, n_layers=D_LAYERS,
                            proj=D_PROJ).to(dtype)
    td.load_state_dict(ge2e_state_dict_from_jax(params), strict=True)
    return td


def jax_clf_trajectory(cfg, batches, params, bs, dparams, jd, model, featurization):
    """masg_tpu's jitted `--use_clf` step with the frozen discriminator `jd`
    over `batches`: (metrics per step, final state)."""
    from masg_tpu.train.state import create_train_state as jax_create_train_state
    from masg_tpu.train.step import make_train_step as jax_make_train_step

    tx = jax_optimizer(cfg.train.optimizer, HIDDEN)
    state = jax_create_train_state(model, {"params": params, "batch_stats": bs}, tx)
    step_fn = jax_step(jax_make_train_step, model, use_clf=True, discriminator=jd,
                       discriminator_params=dparams, total_step=TOTAL_STEP,
                       clf_featurization=featurization)
    traj, final, _ = jax_run(step_fn, state, batches)
    return traj, final


def port_disc_sd():
    """A seeded port discriminator of the data-parallel cases' width, every
    weight moved off its init: its f64 state dict in numpy."""
    from torch_dp_cases import DISC

    torch.manual_seed(3)
    d = tse.SpeechEmbedder(n_mels=80, **DISC).double()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():  # every weight off its init, the LSTM biases off 0
        for p in d.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return {k: v.numpy() for k, v in d.state_dict().items()}


# ---------------------------------------------------------------------------
# masg_tpu's 32-channel HiFi-GAN V1 vocoder
# ---------------------------------------------------------------------------


def masg_tpu_vocoder(generator):
    """masg_tpu's Vocoder over the weights of the port's 32-channel V1
    `generator`. Every such Vocoder shares one jitted function (the params
    are its argument), so a mel length compiles once for all weights."""
    from masg_tpu.infer.vocoder import DEFAULT_HIFIGAN_CONFIG, Vocoder
    from masg_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
    from masg_tpu.models.hifigan import convert_torch_state_dict

    voc = copy.copy(memo("masg_tpu V1 32", lambda: Vocoder(
        JaxGenerator(upsample_initial_channel=32), None)))
    voc.params = convert_torch_state_dict(
        {k: v.numpy() for k, v in generator.state_dict().items()},
        dict(DEFAULT_HIFIGAN_CONFIG, upsample_initial_channel=32))
    return voc
