"""A configuration, a kind of traffic, a traffic mix, a cell and its
metrics are added as new files and entries, found by name, with no edit
to the harness: a scratch entry of each in a temporary copy of the
benchmark runs."""

from __future__ import annotations

import json
import shutil
import time

from rehearsal import IMAGES, ROOT, SEED

# a kind of its own: the training folds, reporting folds a second too
KIND = """from pathlib import Path

from portbench.spec import load_kind

Base = load_kind(Path(__file__).resolve().parents[1], "train_folds")


class Traffic(Base):
    def window(self, seconds, tracer, traced_units=0):
        res = super().window(seconds, tracer, traced_units)
        per_fold = self.context()["trained_per_unit"]
        res["metrics"]["folds_per_s"] = \\
            res["metrics"]["train_img_per_s"] / per_fold
        return res
"""


def test_new_files_make_a_new_cell_with_new_metrics(tmp_path, cpu_threads):
    from portbench.run import run_cell
    from portbench.spec import load_cell
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "portbench"
    cfg = json.loads((base / "configs" / "unet-r34-att.json").read_text())
    cfg.update(name="unet-r34-plain", use_attention=False)
    (base / "configs" / "unet-r34-plain.json").write_text(json.dumps(cfg))
    (base / "traffic" / "fold_count.py").write_text(KIND)
    mix = json.loads((base / "traffic" / "train_folds.json").read_text())
    mix.update(kind="fold_count", image_size=64, batch_size=2, n_images=4,
               n_val=2, epochs=1, trace_units=1, images=IMAGES)
    (base / "traffic" / "folds_small.json").write_text(json.dumps(mix))
    (base / "limits" / "r34plain.folds.small.json").write_text(json.dumps(
        {"numbers": {"loss_gap": 1e-3, "val_loss_gap": 1e-3,
                     "stats_gap_median": 1e-3}}))
    (base / "metrics" / "folds.traced.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    cell_name = "r34plain.folds.small"
    bench["configs"].append({
        "name": "unet-r34-plain", "source": "scratch",
        "file": "portbench/configs/unet-r34-plain.json", "reduced": [],
        "why": "scratch"})
    bench["workloads"].append({
        "name": cell_name, "config": "unet-r34-plain",
        "traffic": "folds_small", "chips": 1, "why": "scratch"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append(cell_name)
    bench["end_to_end"].append({
        "name": "folds_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": [cell_name]})
    bench["per_layer"].append({
        "name": "folds.traced", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "fused run",
        "moves": "folds_per_s", "workloads": [cell_name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(tmp_path, cell_name, config={"dtype": "float32"})
    assert not cell.config["use_attention"]
    assert cell.kind.__name__ == "Traffic" and cell.kind.__bases__
    assert {m["name"] for m in cell.end_to_end} == {
        "train_img_per_s", "folds_per_s", "setup_s"}
    traced = run_cell(cell, SEED, 0.3, True, "cpu", time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["folds.traced"]["value"] == 1.0
    plain = run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_img_per_s", "folds_per_s",
                                     "setup_s"}
    assert plain["metrics"]["folds_per_s"]["value"] > 0
