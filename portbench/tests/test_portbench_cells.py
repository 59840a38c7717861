"""Each cell's traffic, window, metric arithmetic and check, rehearsed on
the CPU at 64² (``rehearsal.SMALL_*``), float32, against the plain
reference: the run is correct and reports the cell's metrics."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest

from rehearsal import ROOT, SEED, WORKLOADS, load_small


@pytest.mark.parametrize("workload", WORKLOADS)
def test_untraced_run_is_correct_and_reports_its_end_to_end_metrics(
        workload, cpu_threads):
    from portbench.run import run_cell
    cell = load_small(workload)
    out = run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    names = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == names
    assert "setup_s" in names and len(names) >= 2
    for m in out["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    # the compared numbers come last, each beside its limit
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_is_correct_and_profiles_its_window(cpu_threads):
    from portbench.run import run_cell
    cell = load_small("r34att.train.b8")
    out = run_cell(cell, SEED + 1, 0.5, True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    # no device on the CPU: the device metrics read nothing, and are left
    # out rather than reported as 0
    assert "mfu.train" not in out["metrics"]
    assert "device_idle.train" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())


def test_inputs_depend_on_the_seed_alone():
    import torch
    cell = load_small("r34att.train.b8")
    a, b, c = (cell.kind(cell.config, cell.traffic, s, "cpu")
               for s in (SEED, SEED, 2 ** 40 + 3))
    for d in (a, b, c):
        d.make_inputs()
    assert torch.equal(a.images, b.images) and torch.equal(a.masks, b.masks)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert not torch.equal(a.images, c.images)
    # every seed gives the same shapes
    assert a.images.shape == c.images.shape


def test_run_exits_without_a_result_on_a_host_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "r34att.train.b8", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_exits_without_a_result_beside_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "r34att.train.b8", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")


def test_benchmark_file_keeps_to_its_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        kind = json.loads(mix.read_text())["kind"]
        assert (ROOT / "portbench" / "traffic" / f"{kind}.py").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", names):
            assert "workloads" not in e2e[m["moves"]] \
                or w in e2e[m["moves"]]["workloads"]
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
