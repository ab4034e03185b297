"""A cell is found by name: a workload file and a BENCHMARK.json entry
added under a new name need no edit of any existing file."""

import json
import shutil

from h100_bench import harness


def test_new_workload_found_without_edits(tmp_path):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.BENCH_DIR / sub, tmp_path / "h100_bench" / sub)
    before = {p: p.read_bytes() for p in (tmp_path / "h100_bench").rglob("*.json")}
    new = {"name": "ss_f32_train_again", "config": "gns_taylor2d_ss_f32", "traffic": "train_prefetched",
           "chips": 1, "why": "a copy"}
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ss_f32_train" in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "h100_bench" / "workloads" / "ss_f32_train_again.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    cell = harness.find_cell("ss_f32_train_again", tmp_path / "BENCHMARK.json")
    assert cell.config["name"] == "gns_taylor2d_ss_f32"
    assert cell.traffic["runner"] == "train"
    assert cell.workload["limits"] == {"loss_gap": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert "edge_block_fwd_roofline.train" in {m["name"] for m in cell.per_layer}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert (harness.BENCH_DIR / "runners" / f"{cell.traffic['runner']}.py").exists()
        for m in cell.per_layer:
            assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
