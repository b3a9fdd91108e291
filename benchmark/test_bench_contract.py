"""The benchmark's definition: names, units, files found by name, metrics
reported where they say, and a new cell made of new files only.  CPU only.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry["name"]


@pytest.mark.parametrize("key,name", list(all_names()))
def test_names_use_the_allowed_characters(key, name):
    assert NAME.match(name), (key, name)


def test_keys_and_texts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_each_cell_finds_its_files_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "lib" / f"kind_{traffic['kind']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_traffic_limits_cover_each_kinds_numbers():
    sys.path.insert(0, str(HERE / "lib"))
    import kind_localize
    import kind_pixel_to_geo

    kinds = {"localize": set(kind_localize.NUMBERS),
             "pixel_to_geo": set(kind_pixel_to_geo.NUMBERS)
             | {"start_" + n for n in kind_localize.NUMBERS}}
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert set(traffic["limits"]) == kinds[traffic["kind"]]


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """Copy the benchmark, add a traffic mix and a per-layer metric as new
    files and a cell as a new entry, and run the new cell traced on the CPU:
    no file that was there changes."""
    for p in ("benchmark", "BENCHMARK.json"):
        src = ROOT / p
        (shutil.copytree if src.is_dir() else shutil.copy)(src, tmp_path / p)
    mix = json.loads((HERE / "traffic" / "engine.json").read_text())
    mix.update(scenes=1, warmup_requests=1, trace_requests=1)
    (tmp_path / "benchmark" / "traffic" / "engine_one.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "answers_traced.py").write_text(
        "def read(run):\n    return run.trace.requests if run.trace else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "kuliang1898.engine_one", "config": "kuliang1898",
                               "traffic": "engine_one", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "answers_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "requests_per_s",
                               "workloads": ["kuliang1898.engine_one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, 'benchmark'); import run; "
            "print(json.dumps(run.run_cell('kuliang1898.engine_one', 5, 0.1, True, "
            "device='cpu', cut={'candidates': 12})))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert result["metrics"]["answers_traced"]["value"] == 1
    for p in (HERE / "traffic").iterdir():
        assert (tmp_path / "benchmark" / "traffic" / p.name).read_bytes() == p.read_bytes()


def test_metric_readers_return_nothing_when_there_is_nothing_to_read():
    sys.path[:0] = [str(HERE / "lib"), str(HERE / "metrics"), str(HERE)]
    import importlib

    import run

    empty = run.Run(config={}, traffic={}, requests=0,
                    window_s=1.0, spans={}, counters={})
    for p in sorted((HERE / "metrics").glob("*.py")):
        assert importlib.import_module(p.stem).read(empty) is None, p.stem

