"""The port's LM serving CLI (``python -m repro_torch.launch.serve``)
beside the reference's (``python -m repro.launch.serve``): the same flags
give the same printed lines — ``[prefill] BxP``, ``[decode] G-1 steps``
with a rate, then a (B, G) block of token ids in the vocabulary — and
both refuse an encoder-only arch with the same message. The weights come
from each framework's own generator, so the ids themselves differ."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.serve import main as j_main
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import main

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "recurrentgemma-2b", "--smoke", "--batch", "3",
        "--prompt-len", "20", "--gen", "6"]


def _parse(out: str):
    prefill = re.search(r"^\[prefill\] (\d+)x(\d+) in [\d.]+s$", out, re.M)
    decode = re.search(r"^\[decode\] (\d+) steps in [\d.]+s "
                       r"\(([\d.]+) tok/s\)$", out, re.M)
    assert prefill and decode, out
    block = out.split("generated token ids:", 1)[1]
    rows = [[int(v) for v in r.split()]
            for r in re.findall(r"\[([\d\s]+)\]", block)]
    return (tuple(map(int, prefill.groups())), int(decode.group(1)),
            float(decode.group(2)), rows)


def test_both_serve_clis_print_the_same_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", mod, *ARGS, *extra],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for mod, extra in (("repro.launch.serve", []),
                                ("repro_torch.launch.serve",
                                 ["--device", "cpu"]))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(_parse(out))
    vocab = get_smoke_config("recurrentgemma-2b").vocab_size
    for (shape, steps, rate, rows) in outs:
        assert shape == (3, 20) and steps == 5 and rate > 0
        assert len(rows) == 3 and all(len(r) == 6 for r in rows)
        assert all(0 <= v < vocab for r in rows for v in r)


def test_both_refuse_an_encoder_only_arch():
    msgs = []
    for fn in (j_main, main):
        with pytest.raises(SystemExit) as exc:
            fn(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"]
               if fn is main else ["--arch", "hubert-xlarge", "--smoke"])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == \
        "hubert-xlarge has no decode step: encoder-only: no decode step"


def test_port_cli_runs_in_process_and_returns_the_ids():
    ids = main(["--arch", "xlstm-1.3b", "--smoke", "--batch", "2",
                "--prompt-len", "24", "--gen", "4", "--device", "cpu"])
    assert ids.shape == (2, 4)
