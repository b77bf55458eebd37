"""``run.py``'s refusals: no result and a non-zero exit without a card,
and in a directory that holds only BENCHMARK.json and the benchmark's
own files."""
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "nemotron-4-15b.ft.wtacrs", "--seed", "4294967301",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(cwd), "TMPDIR": str(cwd)}
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
