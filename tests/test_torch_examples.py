"""The port's examples (``examples/torch_*.py``) as a user runs them: each
as its own process on the CPU (``--device cpu``) at the reduced config
for a few steps or requests; the finetune example resumes when run
again; the quickstart stays within the reference's 30-line budget."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(name, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, str(EXAMPLES / name), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    return done.stdout


def test_quickstart_fits_in_30_non_argparse_lines():
    """The rule of the reference's ``tests/test_api.py`` quickstart check."""
    body = (EXAMPLES / "torch_quickstart.py").read_text().split('"""')[2]
    n = 0
    for line in body.splitlines():
        s = line.strip()
        if (not s or s.startswith("#") or "argparse" in s
                or s.startswith("ap.") or s.startswith("args =")):
            continue
        n += 1
    assert n <= 30, f"torch_quickstart.py has {n} non-argparse code lines"


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_finetune_lora_wtacrs.py",
                                  "torch_serve_decode.py",
                                  "torch_distributed_dryrun.py"])
def test_examples_default_to_the_card(name):
    src = (EXAMPLES / name).read_text()
    assert 'ap.add_argument("--device", default="cuda")' in src
    assert "device=args.device" in src


def test_quickstart_trains():
    out = _run("torch_quickstart.py", "--steps", "3", "--per-layer")
    assert "step     0  loss" in out and "step     2  loss" in out
    assert out.rstrip().endswith("done.")


def test_finetune_resumes_when_run_again(tmp_path):
    args = ("--steps", "2", "--batch", "4", "--seq", "16", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "1", "--adaptive")
    first = _run("torch_finetune_lora_wtacrs.py", *args)
    assert "resumed" not in first and "§Budgets" in first
    again = _run("torch_finetune_lora_wtacrs.py", *args)
    assert "resumed from step 2" in again
    assert "2 steps; loss" in again      # the report covers the whole run


def test_serve_decode_serves_two_requests():
    out = _run("torch_serve_decode.py", "--requests", "2", "--gen", "6")
    assert "req 0: prompt[" in out and "req 1: prompt[" in out
    assert "served 2 ragged requests" in out and "## §Serving" in out


def test_distributed_dryrun_prints_the_roofline():
    """One rank of the reduced arch's 16x16 train cell traced on the meta
    device: its memory, flops and collectives, and the report's
    §Roofline."""
    out = _run("torch_distributed_dryrun.py", "--reduced", "--mesh",
               "single")
    assert "cell: qwen2.5-3b x train_4k x single" in out
    assert "per-device memory: args" in out and "collectives: {" in out
    assert "## §Roofline" in out and "dominant" in out
