"""The port's training CLI (``python -m repro_torch.launch.train``)
beside the reference's (``python -m repro.launch.train``): the same flags
print the same line shapes — ``[dedup] ...``, ``step N loss=... lr=...
gnorm=... tok/s=...``, ``done.`` — and the same ``[dedup]`` count (the
corpus is numpy, the join exact in both). The weights and batches come
from each framework's own generator, so the losses differ. Then the
port's ``--resume``: a run with a checkpoint at step 2 whose step-4
checkpoint is lost (a crash after step 2's save) resumes to the same
step-4 files, byte for byte, as a straight run."""
import filecmp
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.train import main

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "yi-9b", "--smoke", "--steps", "4", "--batch", "4",
        "--seq", "32", "--dedup"]
STEP = re.compile(r"^step +(\d+) loss=([\d.]+) lr=(\S+) gnorm=([\d.]+) "
                  r"tok/s=(\d+)$", re.M)


def _parse(out):
    dedup = re.findall(r"^\[dedup\] ScalLoPS SimHash stage: (\d+) "
                       r"near-duplicates dropped of (\d+) docs$", out, re.M)
    steps = [int(m.group(1)) for m in STEP.finditer(out)]
    assert out.rstrip().endswith("done."), out
    return dedup, steps


def test_both_train_clis_print_the_same_lines(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", mod, *ARGS, *extra],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for mod, extra in (("repro.launch.train", []),
                                ("repro_torch.launch.train",
                                 ["--device", "cpu"]))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(_parse(out))
    (jdedup, jsteps), (dedup, steps) = outs
    assert dedup == jdedup and len(dedup) == 1 and int(dedup[0][0]) > 0
    assert steps == jsteps == [0, 3]


def test_port_cli_resume_is_bitwise(tmp_path, capsys):
    base = ["--arch", "yi-9b", "--smoke", "--steps", "4", "--batch", "4",
            "--seq", "16", "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    main(base + ["--ckpt-dir", str(a)])
    main(base + ["--ckpt-dir", str(b), "--ckpt-every", "2"])
    assert sorted(p.name for p in b.iterdir()) == ["step_00000002",
                                                   "step_00000004"]
    shutil.rmtree(b / "step_00000004")            # lost in the "crash"
    capsys.readouterr()
    state = main(base + ["--ckpt-dir", str(b), "--resume"])
    out = capsys.readouterr().out
    assert "[resume] restored step 2" in out and int(state.step) == 4
    assert [int(m.group(1)) for m in STEP.finditer(out)] == [3]
    names = sorted(p.name for p in (a / "step_00000004").iterdir())
    _, diff, errs = filecmp.cmpfiles(a / "step_00000004", b / "step_00000004",
                                     names, shallow=False)
    assert not diff and not errs and len(names) > 50


def test_port_cli_float_inputs(capsys):
    state = main(["--arch", "hubert-xlarge", "--smoke", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert int(state.step) == 2
    assert len(STEP.findall(capsys.readouterr().out)) == 2


def test_port_cli_needs_the_card_unless_told():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "yi-9b", "--smoke", "--steps", "1"])
