"""On a card: the control of each cell's comparison (the plain reference in
TF32, in the program's place) comes out as not correct at tiny widths.
Skips without a CUDA device. On a machine with one:

    python -m pytest -p no:cacheprovider -o addopts="" -m cuda portbench/tests
"""

import pytest
import torch

from portbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v1_synth_b16", "v2_synth_b16", "v1_train_fs2_b16",
                                  "v1_serve_poisson"])
def test_the_control_comes_out_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only there)")
    from portbench import control

    ctx = tiny.context(cell)
    readings = control.READINGS[ctx.cell["driver"]](ctx.cell, ctx.config, 12345, "cuda")
    assert any(v > ctx.cell["limits"][k] for k, v in readings.items()), readings
