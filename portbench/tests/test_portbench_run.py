"""The command's refusals: it prints no result and exits with another
code than 0 on a machine without the card the cell asks for, and in a
directory that holds only the benchmark's own files."""

import shutil
import subprocess
import sys

import torch

from portbench.tests.conftest import BENCH, ROOT

ARGS = ["--workload", "mistral-7b.chat-long", "--seed", str(2**31 + 3), "--seconds", "10",
        "--trace", "0"]


def command(cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        return                       # on the card this is the benchmark's run
    p = command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_the_benchmarks_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
