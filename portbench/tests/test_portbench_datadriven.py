"""A configuration, a traffic mix and a per-layer metric added as files (and
entries in BENCHMARK.json) in a copy of the benchmark become a cell that
runs, without an edit to any file the benchmark already has."""

import hashlib
import json
import shutil

import portbench.run as run
from portbench import core
from portbench.tests.helpers import small_cell

NEW_METRIC = '''"""Maps the window delivered (a count)."""


def read(ctx):
    return float(ctx["window"]["maps"])
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_cell(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    cfg = core.load_json(pb / "configs" / "vinet-dhf1k.json")
    (pb / "configs" / "vinet-dhf1k-copy.json").write_text(json.dumps(cfg))
    mix = core.load_json(pb / "traffic" / "parity.json")
    (pb / "traffic" / "parity-short.json").write_text(json.dumps({**mix, "lengths": [70]}))
    (pb / "layer_metrics" / "maps_seen.short.py").write_text(NEW_METRIC)
    (pb / "limits" / "vinet-dhf1k-copy.parity-short.json").write_text(
        (pb / "limits" / "vinet-dhf1k.parity.json").read_text())
    spec["configs"].append({"name": "vinet-dhf1k-copy",
                            "source": "https://arxiv.org/abs/2012.06170",
                            "file": "portbench/configs/vinet-dhf1k-copy.json", "reduced": [],
                            "why": "a copy"})
    spec["workloads"].append({"name": "vinet-dhf1k-copy.parity-short", "config": "vinet-dhf1k-copy",
                              "traffic": "parity-short", "chips": 1, "why": "short videos"})
    spec["end_to_end"][0]["workloads"].append("vinet-dhf1k-copy.parity-short")
    spec["per_layer"].append({"name": "maps_seen.short", "unit": "maps", "better": "higher",
                              "source": "program_counter", "layer": "serving",
                              "moves": "maps_per_s",
                              "workloads": ["vinet-dhf1k-copy.parity-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())  # nothing edited

    cell = small_cell("vinet-dhf1k-copy.parity-short", root=tmp_path, trace=True, spec=spec)
    cell.traffic["lengths"] = [70]
    assert [m["name"] for m in cell.per_layer] == ["maps_seen.short"]
    out = run.measure(cell)
    assert out["correct"], out
    assert out["metrics"]["maps_seen.short"]["value"] >= 70


def test_metrics_follow_the_cells_entries():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        e2e, per_layer = core.cell_metrics(spec, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per_layer and all(m["moves"] in names for m in per_layer)
        for m in per_layer:
            assert (core.BENCH_DIR / "layer_metrics" / f"{m['name']}.py").is_file()
        assert (core.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
