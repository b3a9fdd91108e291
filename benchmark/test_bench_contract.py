"""The benchmark's definition: names, units, files found by name, metrics
reported where they say, and a new cell made of new files only.  CPU only.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import importlib
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


def kind_modules() -> dict:
    """{kind: its module}, for every ``lib/kind_<kind>.py``."""
    sys.path.insert(0, str(HERE / "lib"))
    return {p.stem[len("kind_"):]: importlib.import_module(p.stem)
            for p in sorted((HERE / "lib").glob("kind_*.py"))}


def test_traffic_limits_cover_each_kinds_numbers():
    """Each kind states ``LIMITS``, every number its ``judge_run`` returns,
    and each cell's mix gives a limit to exactly those."""
    kinds = kind_modules()
    for name, mod in kinds.items():
        assert isinstance(getattr(mod, "LIMITS", None), tuple) and mod.LIMITS, name
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert set(traffic["limits"]) == set(kinds[traffic["kind"]].LIMITS), w["name"]


def copy_benchmark(dest: Path) -> dict:
    """Copy ``benchmark/`` and ``BENCHMARK.json`` into ``dest``; returns
    {path: bytes} of every file copied."""
    for p in ("benchmark", "BENCHMARK.json"):
        src = ROOT / p
        (shutil.copytree if src.is_dir() else shutil.copy)(src, dest / p)
    return {p: p.read_bytes() for p in dest.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def assert_only_added(dest: Path, before: dict) -> None:
    """No file of ``before`` changed but ``BENCHMARK.json``, which keeps
    every entry it had."""
    old = json.loads(before.pop(dest / "BENCHMARK.json"))
    new = json.loads((dest / "BENCHMARK.json").read_text())
    for key, value in old.items():
        assert (new[key][:len(value)] if isinstance(value, list) else new[key]) == value, key
    for p, data in before.items():
        assert p.read_bytes() == data, p


def run_traced_on_the_cpu(dest: Path, cell: str, cut: dict) -> dict:
    code = ("import json, sys; sys.path.insert(0, 'benchmark'); import run; "
            f"print(json.dumps(run.run_cell({cell!r}, 5, 0.1, True, "
            f"device='cpu', cut={cut!r})))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))  # a copy's, then the port's
    out = subprocess.run([sys.executable, "-c", code], cwd=dest, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """Copy the benchmark, add a traffic mix and a per-layer metric as new
    files and a cell as a new entry, and run the new cell traced on the CPU:
    no file that was there changes."""
    before = copy_benchmark(tmp_path)
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
    result = run_traced_on_the_cpu(tmp_path, "kuliang1898.engine_one", {"candidates": 12})
    assert result["correct"], result
    assert result["metrics"]["answers_traced"]["value"] == 1
    assert_only_added(tmp_path, before)


#: A kind of traffic that only this test knows: each request projects a
#: seeded batch of points through the port's ``ops.projection``, judged
#: against the same projection in NumPy.
TOY_KIND = '''
import numpy as np
import torch

LIMITS = ("pixel_gap_px",)


class Session:
    def __init__(self, cfg, traffic, seed, device, workdir, n_candidates=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device

    def next_input(self, i):
        rng = np.random.default_rng([self.seed, i])
        X = rng.uniform([-50, -50, 100], [50, 50, 300], (self.traffic["points"], 3))
        return X, rng.uniform(-5.0, 5.0, 3)

    def request(self, x):
        from ransac_tpu_torch.ops.projection import project_points

        X, t = x
        t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)
        pix, _ = project_points(t64(X), t64(np.eye(3)), t64(t), t64(self.cfg["K"]))
        return x, pix.cpu().numpy()

    def release(self):
        pass


def judge_run(session, answers, device):
    K = np.asarray(session.cfg["K"])
    out = []
    for (X, t), pix in answers:
        c = X + t
        ref = (c[:, :2] / c[:, 2:]) * K[[0, 1], [0, 1]] + K[:2, 2]
        out.append({"pixel_gap_px": float(np.abs(pix - ref).max())})
    return out
'''


def test_a_new_kind_is_new_files_only(tmp_path):
    """Copy the benchmark; add a kind, a configuration, a mix, a metric and
    their entries as new files and entries; run the new cell traced on the
    CPU and the copy's own contract suite (all but this test, which would
    recur): both pass, and no file that was there changes."""
    before = copy_benchmark(tmp_path)
    b = tmp_path / "benchmark"
    (b / "lib" / "kind_toy.py").write_text(TOY_KIND)
    (b / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "reduced": [], "K": [[800, 0, 320], [0, 800, 240], [0, 0, 1]]}))
    (b / "traffic" / "toy.json").write_text(json.dumps(
        {"kind": "toy", "points": 64, "warmup_requests": 1, "trace_requests": 2,
         "limits": {"pixel_gap_px": 1e-6}}))
    (b / "metrics" / "toy_traced.py").write_text(
        "def read(run):\n    return run.trace.requests if run.trace else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test", "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.toy", "config": "toy", "traffic": "toy",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "toy_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "toy",
                               "moves": "requests_per_s", "workloads": ["toy.toy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_traced_on_the_cpu(tmp_path, "toy.toy", {})
    assert result["correct"] and result["attempted"] > 2, result
    assert result["metrics"]["toy_traced"]["value"] == 2
    assert result["checks"]["pixel_gap_px"]["value"] <= 1e-6
    suite = b / "test_bench_contract.py"
    out = subprocess.run([sys.executable, "-m", "pytest", str(suite), "-q", "-p", "no:cacheprovider",
                          "-k", "not test_a_new_kind_is_new_files_only"],
                         cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:]
    assert " passed" in out.stdout and "deselected" in out.stdout, out.stdout[-2000:]
    assert_only_added(tmp_path, before)


def test_metric_readers_return_nothing_when_there_is_nothing_to_read():
    sys.path[:0] = [str(HERE / "lib"), str(HERE / "metrics"), str(HERE)]
    import importlib

    import run

    empty = run.Run(config={}, traffic={}, requests=0,
                    window_s=1.0, spans={}, counters={})
    for p in sorted((HERE / "metrics").glob("*.py")):
        assert importlib.import_module(p.stem).read(empty) is None, p.stem

