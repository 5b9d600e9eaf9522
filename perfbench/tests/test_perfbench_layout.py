"""Every entry of BENCHMARK.json resolves to its files, and no module
of the benchmark imports JAX or the JAX package."""

import ast
import json
from pathlib import Path

import pytest

from perfbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
FILES = sorted(run.HERE.rglob("*.py"))


def top_imports(path: Path):
    """Top-level module names a file imports (relative imports are
    inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(workload):
    c = run.cell(BENCH, workload)
    assert (run.HERE / "traffic" / f"{c.traffic['driver']}.py").is_file()
    assert (run.HERE / "reference" / f"{c.cfg['reference']}.py").is_file()
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    assert {m["name"] for m in c.e2e} >= {"setup_s"}
    assert len(c.e2e) >= 2 and c.per_layer
    if "metric" in c.traffic:
        assert c.traffic["metric"] in {m["name"] for m in c.e2e}


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    cfg = json.loads((run.ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader(metric):
    reader = run.load_module(run.HERE / "metrics" / f"{metric}.py", metric)
    empty = {"trace": None, "readings": {}, "peak_flops": 989e12}
    assert reader.read(empty) is None


def test_metric_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            want = e2e[m["moves"]]
            assert "workloads" not in want or w in want["workloads"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(run.HERE)))
def test_no_jax(path):
    assert not top_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((run.HERE / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_imports(path) & {"deeplearning4j_tpu_torch", "perfbench"}
    assert "deeplearning4j_tpu" not in path.read_text()


def test_forbidden_is_matched_whole(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "deeplearning4j_tpu_torch_x", object())
    assert "deeplearning4j_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deeplearning4j_tpu.nn", object())
    assert run.forbidden_modules() == ["deeplearning4j_tpu"]


def test_no_result_without_a_chip(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "3000000000", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
