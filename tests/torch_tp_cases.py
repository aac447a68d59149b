"""Jobs of the port's tensor-parallel tests (tests/test_torch_port_tensor_parallel.py),
run by a pool of 4 gloo ranks on the CPU (torch_dp_cases.RankPool).

The pool's world splits into meshes of n_data x n_model consecutive ranks
(two 2-rank meshes, 1 x 2 or 2 x 1, or one 2 x 2 or 1 x 4); each mesh runs
the spec the job gives it (`specs[rank // size]`), so two 2-rank runs take
one round. The meshes' groups are created once per shape, by every rank in
one order. A job also runs in the test process alone (world 1: one device, no group).
Results are host data only. torch and masg_tpu_torch only: a spawned rank
imports this module by name.
"""

from __future__ import annotations

import contextlib
import importlib
import sys

import torch
import torch.distributed as dist

import torch_dp_cases as dp
from masg_tpu_torch.parallel.mesh import DataMesh, shard_state, sharded_names, unshard_state

_MESHES = {}


class TPPool(dp.RankPool):
    """The 4-rank pool, whose jobs can start before the test process
    computes its one-device reference and be collected after."""

    def __init__(self, timeout_s: float = 60.0):
        super().__init__(4, timeout_s)

    def submit(self, fn, *args) -> None:
        for q in self.jobs:
            q.put((fn, args))
        self._pending = fn

    def collect(self, timeout_s: float = 60.0):
        """Every rank's result of the submitted job, in rank order."""
        jobs, self.jobs = self.jobs, [_Dropped()] * self.world
        try:  # RankPool.run's wait, its jobs already queued
            return self.run(self._pending, timeout_s=timeout_s)
        finally:
            self.jobs = jobs


class _Dropped:
    def put(self, item):
        pass


def mesh_of(rank: int, world: int, n_data: int, n_model: int):
    """This rank's DataMesh on a pool of `world` ranks split into meshes of
    n_data x n_model; None alone."""
    if world == 1:
        return None
    size = n_data * n_model
    key = (n_data, n_model)
    if key not in _MESHES:  # collective: every rank, in one order
        groups = {}
        for base in range(0, world, size):
            for m in range(n_model):
                ranks = list(range(base + m, base + size, n_model))
                groups["data", base, m] = dist.new_group(ranks) if n_data > 1 else None
            for d in range(n_data):
                ranks = list(range(base + d * n_model, base + (d + 1) * n_model))
                groups["model", base, d] = dist.new_group(ranks) if n_model > 1 else None
        _MESHES[key] = groups
    groups = _MESHES[key]
    base = rank // size * size
    d, m = divmod(rank - base, n_model)
    return DataMesh(n_data=n_data, rank=d, n_model=n_model, model_rank=m,
                    data_group=groups["data", base, m], model_group=groups["model", base, d])


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def operators(rank, world, x, w1, w2, b2, cot, cot_h):
    """A column-parallel layer, a row-parallel one and a gather, on a 1 x
    world mesh (alone: the whole layers): relu(f(x) W1ᵀ) W2ᵀ through g plus
    b2, and gather(f(x) W1ᵀ). Returns (out, d out·cot / d x, d / d W1's
    shard, d / d W2's shard, gathered h, d gathered·cot_h / d x, d / d W1's
    shard)."""
    mesh = mesh_of(rank, world, 1, world)
    axis = mesh.model_axis if mesh is not None else None
    cols = slice(None) if axis is None else slice(rank * len(w1) // world,
                                                  (rank + 1) * len(w1) // world)
    xt = torch.from_numpy(x).requires_grad_(True)
    a = torch.from_numpy(w1[cols]).requires_grad_(True)
    b = torch.from_numpy(w2[:, cols]).requires_grad_(True)
    h = torch.relu((xt if axis is None else axis.copy(xt)) @ a.T) @ b.T
    out = (h if axis is None else axis.reduce(h)) + torch.from_numpy(b2)
    (out * torch.from_numpy(cot)).sum().backward()
    res = [out.detach().numpy(), xt.grad.numpy(), a.grad.numpy(), b.grad.numpy()]
    xt.grad, a.grad = None, None
    h = (xt if axis is None else axis.copy(xt)) @ a.T
    hg = h if axis is None else axis.gather(h, dim=-1)
    (hg * torch.from_numpy(cot_h)).sum().backward()
    return res + [hg.detach().numpy(), xt.grad.numpy(), a.grad.numpy()]


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _build(spec, mesh):
    """The spec's FastSpeech2 (and discriminator) in f64 (bf16 storage: bf16)
    on this rank's mesh, its train state and step."""
    from masg_tpu_torch.models import FastSpeech2
    from masg_tpu_torch.models.ganlike import GANLike
    from masg_tpu_torch.models.speaker_encoder import SpeechEmbedder
    from masg_tpu_torch.train.state import create_train_state
    from masg_tpu_torch.train.step import make_ganlike_train_step, make_train_step

    variant = spec["variant"]
    cfg = dp.tiny_config(use_jdit=variant == "jdit", grad_acc_step=spec.get("acc", 1))
    cfg.model.transformer.encoder_head = cfg.model.transformer.decoder_head = spec.get("heads", 2)
    model = FastSpeech2.from_config(cfg, use_flash=False, mesh=mesh).to(torch.float64)
    init = spec["init"]
    if isinstance(init, list):  # per model rank: the shards of the bridge
        init = init[0 if mesh is None else mesh.model_rank]
        sd = {k: torch.from_numpy(v) for k, v in init.items()}
    else:
        axis = None if mesh is None else mesh.model_axis
        sd = shard_state({k: torch.from_numpy(v) for k, v in init.items()},
                         sharded_names(model), axis)
    model.load_state_dict(sd, strict=True)
    if not spec.get("dropout"):
        dp.no_dropout(model)
    storage = spec.get("storage", "f32")
    if storage != "f32":
        model.to(torch.bfloat16)
    disc = None
    if spec.get("disc") is not None:
        disc = SpeechEmbedder(n_mels=80, **dp.DISC).to(torch.float64)
        disc.load_state_dict({k: torch.from_numpy(v) for k, v in spec["disc"].items()})
    if variant == "ganlike":
        trained = GANLike(model, disc)
        step = make_ganlike_train_step(trained, total_step=100)
    else:
        trained = model
        step = make_train_step(model, use_clf=variant == "use_clf", use_jdit=variant == "jdit",
                               discriminator=disc, total_step=100)
    state = create_train_state(trained, cfg.train.optimizer, dp.HIDDEN, storage)
    return state, step


def _whole_state(state):
    """The trained module's whole state dict (gathered over the model group)."""
    axis = state.model_axis
    sd = state.model.state_dict()
    if axis is not None:
        sd = unshard_state(sd, sharded_names(state.model), axis)
    return {k: v.detach().double().numpy() for k, v in sd.items()}


def _whole_grads(state, step, batch, mesh, dtype):
    """{name: the gradient} of the step's objective on `batch` from the
    state as it is, summed over the data group and gathered over the model
    group. The run goes on as if it had not been taken: the BatchNorm
    statistics and torch's generator are put back, the gradients cleared."""
    from masg_tpu_torch.parallel.mesh import unshard_tensor
    from masg_tpu_torch.train.step import batch_to_device

    m = (mesh or DataMesh()).for_batch(len(batch["speakers"]))
    local = batch_to_device(m.shard_batch(batch), "cpu", dtype)
    buffers = {n: b.clone() for n, b in state.model.named_buffers()}
    with torch.random.fork_rng(devices=[]):
        step.loss_fn(state.model, local, state.step,
                     mesh=m if mesh is not None else None)[0].backward()
    with torch.no_grad():
        for n, b in state.model.named_buffers():
            b.copy_(buffers[n])
    m.reduce_grads(state.params())
    axis = state.model_axis
    split = sharded_names(state.model) if axis is not None else {}
    out = {}
    for n, p in state.model.named_parameters():
        if p.requires_grad and p.grad is not None:
            g = unshard_tensor(p.grad, split[n], axis) if n in split else p.grad
            out[n] = g.detach().double().numpy().copy()
        p.grad = None
    return out


def _replicated(state):
    """This rank's replicated parameters and buffers, as they are."""
    split = sharded_names(state.model) if state.model_axis is not None else {}
    return {k: v.detach().clone().numpy() if v.dtype != torch.bfloat16
            else v.detach().float().numpy()
            for k, v in state.model.state_dict().items() if k not in split}


def train(rank, world, specs):
    """Each mesh runs `specs[mesh index]`, the meshes of one size in rank
    order (a 1 x 2 and a 2 x 1 share a round): {"shape": (n_data, n_model),
    "variant", "init", optional "disc", "acc", "heads", "storage",
    "dropout", "batches", "save" (step, path: data rank 0's model group
    writes it) / "restore" (step, path)}. Returns (StepMetrics per step, the
    whole final state, this rank's replicated tensors, its shard size)."""
    from masg_tpu_torch.core.checkpoint import CheckpointManager
    from masg_tpu_torch.train.loop import step_seed
    from masg_tpu_torch.train.step import batch_to_device, make_eval_step

    size = specs[0]["shape"][0] * specs[0]["shape"][1]
    for other in specs:  # every rank creates every shape's groups, in one order
        assert other["shape"][0] * other["shape"][1] == size, "one mesh size a round"
        mesh_of(rank, world, *other["shape"])
    spec = specs[rank // size if world > 1 else 0]
    mesh = mesh_of(rank, world, *spec["shape"])
    state, step = _build(spec, mesh)
    dtype = next(state.model.parameters()).dtype
    if "restore" in spec:
        s, path = spec["restore"]
        state = CheckpointManager(path).restore(s, state)
    grads = _whole_grads(state, step, spec["batches"][0], mesh, dtype)
    traj = []
    for b in spec["batches"]:
        n = state.step + 1
        m = (mesh or DataMesh()).for_batch(len(b["speakers"]))
        local = batch_to_device(m.shard_batch(b), "cpu", dtype)
        seed = step_seed(0, n, m.rank if m.parts > 1 else 0)
        state, metrics = step(state, local, seed, m if mesh is not None else None)
        traj.append({k: float(getattr(metrics, k)) for k in dp.METRICS})
        if "save" in spec and spec["save"][0] == n and (mesh is None or mesh.lead_row):
            CheckpointManager(spec["save"][1]).save(n, state)
    held = sum(p.numel() for p in state.model.parameters())
    losses, eloss, _ = make_eval_step(state.fs2)(state, batch_to_device(b, "cpu", dtype))
    evaluated = [float(x) for x in (*losses, eloss)]
    return traj, _whole_state(state), _replicated(state), held, evaluated, grads


def full_init(use_jdit=False):
    """The tiny FastSpeech2's one-device f64 weights from seed 0."""
    from masg_tpu_torch.models import FastSpeech2

    torch.manual_seed(0)
    m = FastSpeech2.from_config(dp.tiny_config(use_jdit=use_jdit), use_flash=False)
    return {k: v.double().numpy() if v.is_floating_point() else v.numpy()
            for k, v in m.state_dict().items()}


def layout(rank, world, n_model):
    """`DataMesh.from_process_group` over the pool's world: (data rank,
    model rank, the sum of the global ranks over the data group, and over
    the model group, this rank's global rank after `replicate`)."""
    mesh = DataMesh.from_process_group(8, n_model=n_model)
    r = torch.tensor([float(rank)], dtype=torch.float64)
    over_data = float(mesh.sum(r)) if mesh.n_data > 1 else rank
    over_model = float(mesh.model_axis.reduce(r))
    mesh.replicate([r])
    return mesh.rank, mesh.model_rank, over_data, over_model, float(r)


def cli_main(rank, world, cli: str, argv):
    """`masg_tpu_torch.cli.<cli>.main(argv)` on every rank of the pool, as a
    `--multihost` process runs it once it has joined its group (the
    launcher's join left out): `build_experiment` takes the (world / M, M)
    mesh of the joined group. tensorboard logs through its stub (TensorFlow,
    where installed, takes ~14 s a process to import)."""
    sys.modules.setdefault("tensorflow", None)
    module = importlib.import_module(f"masg_tpu_torch.cli.{cli}")
    launch = module.launch_data_parallel
    module.launch_data_parallel = lambda run, args, batch_size: run(args, args.device)
    try:
        with postnet_dropout_off():
            module.main(argv)
    finally:
        module.launch_data_parallel = launch


@contextlib.contextmanager
def postnet_dropout_off():
    """PostNet's fixed 0.5 dropout at 0 for the PostNets built inside (the
    configs set every other dropout): a data rank's masks differ from one
    device's, so runs over 1 and 2 data ranks take one step only without."""
    from masg_tpu_torch.models import postnet

    init = postnet.PostNet.__init__

    def without_dropout(self, *a, **kw):
        init(self, *a, **kw)
        self.dropout.p = 0.0

    postnet.PostNet.__init__ = without_dropout
    try:
        yield
    finally:
        postnet.PostNet.__init__ = init
