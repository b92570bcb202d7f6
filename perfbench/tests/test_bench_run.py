"""The command itself: without a card it fails and prints no result, as
it does in a directory that holds only BENCHMARK.json and the
benchmark's own files."""
import shutil
import subprocess
import sys

from perfbench import harness


def _run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "moe-chat-closed64", "--seed",
         str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = _run(harness.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_bare_directory_fails(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
