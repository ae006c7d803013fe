"""The harness finds cells, configurations, traffic and per-layer metrics by
name: one added as new files needs no edit to an existing file."""

import json
import shutil
from pathlib import Path

from benchmark import run as R

ROOT = Path(__file__).resolve().parents[2]


def test_benchmark_json_names_files_that_exist():
    bench = R.load_bench(ROOT)
    for w in bench["workloads"]:
        cell, cfg, traffic = R.cell_files(bench, w["name"], ROOT / "benchmark")
        assert traffic["kind"] in ("serve", "train")
        assert set(traffic["limits"])
    for m in bench["per_layer"]:
        mod = R.reader(m["name"], ROOT / "benchmark")
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["source"], m["moves"])


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = R.load_bench(ROOT)
    cfg = json.loads((here / "configs" / "diffsensei-sdxl-serve.json").read_text())
    cfg["sampler"]["num_inference_steps"] = 50
    (here / "configs" / "diffsensei-sdxl-serve-50.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "page_b1.json").read_text())
    traffic["sizes"] = [[512, 512]]
    (here / "traffic" / "page_512.json").write_text(json.dumps(traffic))
    (here / "metrics" / "unet_calls.serve.py").write_text(
        'LAYER = "Denoise loop"\nUNIT = "calls"\nSOURCE = "program_span"\n'
        'MOVES = "panels_per_s"\n\n\ndef read(run):\n'
        '    return len(run["layer"]["spans"].get("unet", [])) or None\n')
    bench["configs"].append({"name": "diffsensei-sdxl-serve-50", "source": "x",
                             "file": "benchmark/configs/diffsensei-sdxl-serve-50.json",
                             "reduced": [], "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "panels_per_s":
            m["workloads"].append("serve_page_512")
    bench["workloads"].append({"name": "serve_page_512", "config": "diffsensei-sdxl-serve-50",
                               "traffic": "page_512", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "unet_calls.serve", "unit": "calls", "better": "lower",
                               "source": "program_span", "layer": "Denoise loop",
                               "moves": "panels_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = R.load_bench(tmp_path)
    cell, cfg, traffic = R.cell_files(bench, "serve_page_512", here)
    assert cfg["sampler"]["num_inference_steps"] == 50 and traffic["sizes"] == [[512, 512]]
    names = [m["name"] for m in R.cell_metrics(bench, cell, trace=True)]
    assert "unet_calls.serve" in names          # no workloads key: every panels_per_s cell
    assert "b1_roofline_pct.serve" not in names  # listed for the cells it names
    assert [m["name"] for m in R.cell_metrics(bench, cell, trace=False)] == \
        ["panels_per_s", "setup_s"]
    run = {"layer": {"spans": {"unet": [1.0, 2.0]}}}
    assert R.reader("unet_calls.serve", here).read(run) == 2
    assert (here / "run.py").read_bytes() == (ROOT / "benchmark" / "run.py").read_bytes()
