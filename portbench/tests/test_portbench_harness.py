"""The benchmark's harness on the CPU: its files are found by name and
keep to the benchmark's contract, a tiny run of each traffic kind prints
the contract's last line, and nothing under ``portbench/`` imports JAX or
the JAX package.

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run as harness
from portbench.tests.contract import contract
from portbench.tests.tiny import REPO, make_root

PACKAGE = REPO / "portbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _cells():
    return [w["name"] for w in BENCH["workloads"]]


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def _cli(root, *args):
    """The run's command, started in ``root`` with the harness importable
    (``REPO``'s first, then whatever the path held)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


# --------------------------------------------------------------- the files


@pytest.mark.parametrize("cell", _cells())
def test_cell_files_found_by_name(cell):
    w = {c["name"]: c for c in BENCH["workloads"]}[cell]
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    json.loads((REPO / cfg["file"]).read_text())
    mix = json.loads((PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    assert (PACKAGE / "kinds" / f"{mix['kind']}.py").is_file()
    spec = json.loads((PACKAGE / "workloads" / f"{cell}.json").read_text())
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in _metrics()])
def test_metric_reader_found_by_name(metric):
    reader = harness.load_file_module(PACKAGE / "metrics" / f"{metric}.py")
    assert callable(reader.read)
    for target in getattr(reader, "SPANS", {}).values():
        assert target.split(":", 1)[0] in ("method", "forward", "function")


def test_benchmark_json_keeps_the_contract():
    assert (REPO / "BENCHMARK.json").stat().st_size < 64 * 1024
    contract(BENCH, PACKAGE)


def test_paths_hold_only_named_files():
    for path in PACKAGE.rglob("*"):
        if "__pycache__" in path.parts or path.suffix == ".pyc":
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _holds(got, want, where):
    """Every value of ``want`` is in ``got``; ``got`` may add an ``about``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) - set(want) <= {"about"}, where
        for k in want:
            assert k in got, (where, k)
            _holds(got[k], want[k], f"{where}.{k}")
    else:
        assert got == want, (where, got, want)


def test_tiny_root_keeps_the_pavia_values(tmp_path):
    """The tiny files of the Pavia configurations, of the cube and train
    mixes and of the three cells hold every value they held when the
    tiny derivation named the kinds and keys itself (``tiny_pavia.json``)."""
    make_root(tmp_path)
    kept = json.loads((PACKAGE / "tests" / "tiny_pavia.json").read_text())
    for rel, want in kept.items():
        _holds(json.loads((tmp_path / rel).read_text()), want, rel)


def test_tiny_derivation_imports_nothing_of_the_port(tmp_path):
    code = ("import sys\n"
            "from portbench.tests.tiny import make_root\n"
            f"make_root({str(tmp_path)!r})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'hsi_dmgasr_tpu_torch',"
            " 'hsi_dmgasr_tpu', 'jax'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


# ----------------------------------------------------------------- imports


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(where=PACKAGE):
    return sorted(p for p in where.rglob("*.py") if "__pycache__" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    """Compared by the whole top-level name: hsi_dmgasr_tpu_torch is the
    port, hsi_dmgasr_tpu the JAX package."""
    for path in _py_files():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _py_files(PACKAGE / "reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "math", "contextlib", "dataclasses",
                           "__future__"), (path, name)


def _strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_nothing_reads_the_old_benchmark():
    """The root bench.py, BENCH_*.json, MULTICHIP_*.json and BASELINE.json
    measured the JAX package; the harness names none of them."""
    old = re.compile(r"BENCH_|MULTICHIP_|BASELINE|BENCHMARKS\.md|bench\.py|chip_smoke")
    for path in _py_files():
        if "tests" in path.relative_to(PACKAGE).parts:
            continue
        for text in _strings(path):
            assert not old.search(text), (path, text)


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "hsi_dmgasr_tpu_torch_fake", sys)
    assert "hsi_dmgasr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hsi_dmgasr_tpu.fake", sys)
    assert "hsi_dmgasr_tpu" in harness.forbidden_modules()


# -------------------------------------------------------------------- runs


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would run")
    proc = _cli(REPO, "--workload", _cells()[0], "--seed", "2200000001", "--seconds", "1",
                "--trace", "0")
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_refuses_in_a_bare_checkout(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ cannot run."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", _cells()[0],
                           "--seed", "2", "--seconds", "1", "--device", "cpu"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"), limits=1e-3)


@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_contract_line(tiny, cell, trace):
    proc = _cli(tiny, "--workload", f"tiny_{cell}", "--seed", "3000000017", "--seconds", "0.5",
                "--trace", str(trace), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    group = "per_layer" if trace else "end_to_end"
    expected = {m["name"] for m in BENCH[group] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= expected
    if not trace:  # the host-clock metrics exist on the CPU too
        assert {"setup_s"} <= set(line["metrics"]) and len(line["metrics"]) >= 2
    else:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    checks = [ln for ln in proc.stderr.strip().splitlines() if ln.startswith("check ")]
    assert proc.stderr.strip().splitlines()[-len(checks):] == checks
    assert len(checks) == len(line["checks"])
