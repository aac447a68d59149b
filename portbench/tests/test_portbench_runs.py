"""Each driver, at tiny sizes on the CPU through the test-only entry
(`python -m portbench.tests.tiny`), prints a result line of the contract's
shape and loads neither JAX nor the package the port was made from; with a
fault planted underneath, `correct` comes out false. The command itself
refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = str(harness.ROOT)
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _run(*args, cwd=ROOT):
    p = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=ENV, capture_output=True,
                       text=True, timeout=240)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.parametrize("cell,fault", [
    ("v1_synth_b16", None), ("v1_train_fs2_b16", None), ("v1_serve_poisson", None),
    ("v1_synth_b16", "wav"), ("v1_synth_b16", "duration"),
    ("v1_train_fs2_b16", "unchanged"), ("v1_train_fs2_b16", "half")])
def test_a_run_prints_the_contracts_line(cell, fault):
    rc, out, err = _run("portbench.tests.tiny", cell, *([fault] if fault else []))
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is (fault is None), line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), cell, "end_to_end")}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # each number compared, beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [x.split(":")[0] for x in tail] == [f"check {k}" for k in line["checks"]]


def test_forbidden_modules_are_found_by_whole_top_level_name():
    code = ("import sys, types; sys.modules['masg_tpu_torch_x'] = types.ModuleType('m');"
            "from portbench import harness; print(harness.forbidden_modules());"
            "sys.modules['masg_tpu.ops'] = types.ModuleType('m'); print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV, capture_output=True,
                       text=True, timeout=120)
    assert p.stdout.split("\n")[:2] == ["[]", "['masg_tpu']"], p.stderr


def test_the_command_refuses_without_a_card():
    rc, out, err = _run("portbench.run", "--workload", "v1_synth_b16", "--seed", "1",
                        "--seconds", "1", "--trace", "0")
    assert rc != 0 and out == "" and "CUDA" in err


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, out, _ = _run("portbench.run", "--workload", "v1_synth_b16", "--seed", "1",
                      "--seconds", "1", "--trace", "0", cwd=str(tmp_path))
    assert rc != 0 and out == ""
