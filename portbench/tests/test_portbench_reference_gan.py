"""The GAN step's plain reference (`reference/hifigan_gan.py`) against the
program's step (`masg_tpu_torch.train.vocoder`) at tiny widths on the CPU:
three steps from the same seeded weights and batches, the losses, the
first step's gradients, the parameters and the power iteration's u after
them. That the reference imports nothing of the program is checked with
the other references (`test_portbench_reference.py`)."""

import numpy as np
import torch

from portbench.drivers import gan
from portbench.reference import hifigan_gan as ref_gan
from portbench.tests import tiny_gan


def _batches(n=3, b=2):
    config = tiny_gan.config()
    seg = config["hifigan"]["segment_size"]
    g = np.random.default_rng(3)
    t = tiny_gan.cell()["traffic"]
    return [torch.from_numpy(gan.utterance(g, b * seg, 22050, t).reshape(b, seg).copy())
            for _ in range(n)]


def test_three_steps_match_the_program():
    from masg_tpu_torch.train import vocoder as tv

    config = tiny_gan.config()
    cfg = gan.program_config(config)
    spe = 2  # the rate decays after update 2, inside the three steps
    state = tv.init_vocoder_train_state(cfg, spe, seed=7)
    step = tv.make_vocoder_train_step(cfg)
    opening = gan.capture(state)
    params = gan.leaves(state)
    ys = _batches()
    losses, first = [], {}
    for i, y in enumerate(ys):
        _, m = step(state, y)
        losses.append([float(m.disc_loss), float(m.gen_loss)])
        if i == 0:  # the step leaves its gradients on the parameters
            first = {k: p.grad.clone() for k, p in params.items()}
    traj = ref_gan.Trajectory(opening.params, opening.sn_u, opening.moments, opening.count,
                              config, spe)
    want = [[float(x) for x in traj.step(y)] for y in ys]
    # round-off alone: the mels take other routes (torch.stft against unfold
    # and rfft), weight norm another order of operations (read: equal)
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    assert losses[0] != losses[2]
    assert set(first) == set(traj.grads[0])
    for k, g in first.items():
        # within 1e-5 of each leaf's largest entry (read: 1.1e-6)
        w = traj.grads[0][k]
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    for k, p in params.items():
        # a step moves a parameter by about the rate, 2e-4: 1e-6 is half a
        # per cent of one step (read: 6e-8)
        torch.testing.assert_close(p.detach(), traj.params[k].detach(), rtol=0, atol=1e-6)
        assert not torch.equal(p.detach(), opening.params[k])
    u = gan.sn_u(state)
    assert set(traj.sn_u) == set(u) and traj.sn_u
    for k, v in traj.sn_u.items():
        torch.testing.assert_close(u[k], v, rtol=0, atol=1e-6)  # unit vectors (read: 6e-8)
        assert v.numel() == 1 or not torch.equal(v, opening.sn_u[k])  # conv_post's u is [1]


def test_the_mel_basis_is_librosas():
    # librosa.filters.mel(22050, 1024, 80, 0, 8000)'s first rows and sums,
    # as published figures of the slaney basis: triangles of area-normed
    # height 2 / (f_hi - f_lo), so each row integrates to about 2 / bin width
    basis = ref_gan.mel_basis(22050, 1024, 80, 0, 8000)
    assert basis.shape == (80, 513) and basis.dtype == np.float32
    assert float(basis[:, 0].sum()) == 0.0  # 0 Hz lies at the first edge
    hz = np.linspace(0, 11025, 513)
    assert float(basis[:, hz > 8000].max()) == 0.0  # nothing above fmax
    peaks = hz[basis.argmax(1)]
    assert np.all(np.diff(peaks) >= 0)
    # below 1 kHz slaney is linear: 200/3 Hz between centres
    centres = ref_gan._mel_to_hz(np.arange(1, 16) * 1.0)
    np.testing.assert_allclose(np.diff(centres), 200.0 / 3)
