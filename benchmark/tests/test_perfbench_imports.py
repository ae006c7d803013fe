"""No run imports JAX or the JAX package, compared by whole top-level
names (the port's name begins with the JAX package's); the plain
reference imports nothing of the port."""

import subprocess
import sys
import textwrap
from pathlib import Path

from benchmark import run as R

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffsensei_tpu_torch_probe", object())
    assert "diffsensei_tpu_torch_probe" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "diffsensei_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"diffsensei_tpu.models", "jaxlib"} <= set(R.forbidden_modules())


def test_reference_and_yardstick_import_nothing_of_the_program():
    got = _python("""
        import sys
        import benchmark.reference.nets, benchmark.reference.diffusion
        import benchmark.reference.data, benchmark.weights, benchmark.yardstick
        import benchmark.flops, benchmark.trace, benchmark.readers
        print(sorted({m.split('.')[0] for m in sys.modules} & {
            'diffsensei_tpu_torch', 'diffsensei_tpu', 'jax', 'jaxlib', 'flax'}))
    """)
    assert got == "[]"


def test_a_whole_run_loads_no_jax():
    got = _python("""
        import sys, time, torch
        torch.set_num_threads(2)
        from benchmark.tests import tiny
        from benchmark import run as R
        bench = R.load_bench()
        cfg, traffic = tiny.serve_cell("candidates_1024x4", num_samples=1)
        cell = {"name": "serve_candidates_1024x4", "chips": 1}
        ctx = R.Context(cell, cfg, traffic, 3, 0.1, 0, torch.device("cpu"), time.perf_counter())
        res = R.execute(ctx, bench)
        assert res["correct"], res
        print(R.forbidden_modules())
    """)
    assert got == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve_candidates_1024x4", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
