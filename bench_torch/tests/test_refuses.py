"""Without a card the benchmark prints no result and exits non-zero; so
does a checkout that holds only BENCHMARK.json and the benchmark's folder."""

import os
import shutil
import subprocess
import sys

from harness import catalog


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _run(catalog.ROOT, "bench_torch/run.py", "--workload", "demo64.flip", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.BENCH, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, 'bench_torch'); import run; "
            "sys.exit(run.main(['--workload', 'demo64.flip', '--seed', '1', '--seconds', '1', "
            "'--trace', '0'], dev=torch.device('cpu')))")
    proc = _run(tmp_path, "-c", code)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "fluidsimulation_tpu_torch" in proc.stderr
