"""The benchmark's contract, as the rules that ``BENCHMARK.json`` and the
files it names must keep: ``contract(bench, package)`` asserts each of
them on a parsed ``BENCHMARK.json`` whose root holds ``package`` (the
``portbench`` directory)."""

from __future__ import annotations

import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    """1 to 200 characters on one line, with no tab."""
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def contract(bench, package):
    root = Path(package).parent
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench, indent=2).encode()) < 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"]), bench["paths"]
    configs, cells = bench["configs"], bench["workloads"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [c["name"] for c in configs]
    cell_names = [w["name"] for w in cells]
    metric_names = [m["name"] for m in metrics]
    for n in names + cell_names + metric_names:
        assert NAME.match(n), n
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    assert 1 <= len(cell_names) <= 24 and len(set(cell_names)) == len(cell_names)
    assert len(set(metric_names)) == len(metric_names)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)

    files = [c["file"] for c in configs]
    assert len(set(files)) == len(files)
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in bench["paths"]), c["file"]
        assert _line(c["why"]) and _line(c["source"])
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(isinstance(k, str) and NAME.match(k) for k in c["reduced"]), \
            f"{c['name']}: a key of reduced is not a name: {c['reduced']}"
        own = json.loads((root / c["file"]).read_text()).get("reduced")
        assert c["reduced"] == own, f"{c['name']}: reduced {c['reduced']} differs from its file's {own}"
        assert c["name"] in {w["config"] for w in cells}, f"{c['name']} is in no cell"

    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and w["config"] in names
        assert NAME.match(w["traffic"]), w["traffic"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), f"{four}: too many cells on four chips"

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cell_names) if "workloads" in m else True
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert _line(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cell_names:
        of = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in of and len(of) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])
