"""The probe: a copy of the benchmark takes a cell of a new shape by new
files and new ``BENCHMARK.json`` entries alone, and the benchmark's own
tests hold it.

The copy holds ``BENCHMARK.json`` and ``portbench/``; the probe adds, from
``portbench/tests/probe/``, a UNet-only configuration (no ``gae_widths``,
no training crop) that lists its cut in ``reduced``, a traffic mix of a
kind of its own (one forward of the port's UNet a call, checked against
the reference's UNet) with its tiny form and its planted fault, the cell,
its check's limits, an end-to-end and a per-layer metric. The benchmark's
tests then run in the copy, the copy first on the path and the repository
(the port) after it, on the new cell: the contract, the tiny root, the
tiny run at ``--trace 0`` and ``1``, the reference against the port, and
the planted fault. No file the copy had is changed, and ``BENCHMARK.json``
only gains the entries.

    python -m pytest -q portbench/tests/test_portbench_probe.py
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.tests.contract import contract
from portbench.tests.tiny import REPO, make_root

PACKAGE = REPO / "portbench"
PROBE = PACKAGE / "tests" / "probe"
CELL = "probe_unet.forward"
FILES = {"config.json": "portbench/configs/probe_unet.json",
         "traffic.json": "portbench/traffic/probe_forward.json",
         "kind.py": "portbench/kinds/probe_forward.py",
         "faults.py": "portbench/tests/faults/probe_forward.py",
         "cell.json": f"portbench/workloads/{CELL}.json",
         "probe_forward_s.py": "portbench/metrics/probe_forward_s.py",
         "unet_ms.probe.py": "portbench/metrics/unet_ms.probe.py"}
ENTRIES = {
    "configs": [{"name": "probe_unet", "source": "https://arxiv.org/abs/2104.07636",
                 "file": "portbench/configs/probe_unet.json", "reduced": ["model"],
                 "why": "SR3 faces 16->128 widths, pixel space, no GAE; val schedule 2000 -> 200"}],
    "workloads": [{"name": CELL, "config": "probe_unet", "traffic": "probe_forward", "chips": 1,
                   "why": "one UNet forward a call, 2 images of 128^2, closed loop: the UNet alone"}],
    "end_to_end": [{"name": "probe_forward_s", "unit": "s", "better": "lower", "bound": 0.05,
                    "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [{"name": "unet_ms.probe", "unit": "ms", "better": "lower",
                   "source": "device_trace", "layer": "probe UNet",
                   "moves": "probe_forward_s", "workloads": [CELL]}],
}
# the benchmark's tests that see the new cell, and what they count
SELECT = "probe or keeps_the_contract"
COUNTS = {"passed": 8, "skipped": 1}


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """(the copy's root, the digests of the files it was copied with)."""
    root = tmp_path_factory.mktemp("probe")
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(PACKAGE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    for name, rel in FILES.items():
        assert not (root / rel).exists(), rel
        shutil.copy(PROBE / name, root / rel)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for group, entries in ENTRIES.items():
        bench[group] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root, before


def test_a_cell_of_a_new_shape_by_new_files_alone(probe, tmp_path):
    root, before = probe
    bench = json.loads((root / "BENCHMARK.json").read_text())
    contract(bench, root / "portbench")
    tiny = make_root(tmp_path, source=root)
    cfg = json.loads((tiny / "portbench" / "configs" / "tiny_probe_unet.json").read_text())
    assert "gae_widths" not in cfg and cfg["model"]["unet"]["inner_channel"] == 8
    mix = json.loads((tiny / "portbench" / "traffic" / "probe_forward.json").read_text())
    assert (mix["size"], mix["batch"]) == (16, 1)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-k", SELECT, "portbench/tests/test_portbench_harness.py",
         "portbench/tests/test_portbench_reference.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    tail = proc.stdout[-4000:] + proc.stderr[-2000:]
    assert proc.returncode == 0, tail
    counts = {k: int(n) for n, k in re.findall(r"(\d+) (passed|skipped|failed|error)",
                                                proc.stdout.strip().splitlines()[-1])}
    assert counts == COUNTS, tail

    # BENCHMARK.json only gained the entries; every other file is as copied
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for group, entries in ENTRIES.items():
        assert bench[group][-len(entries):] == entries
        del bench[group][-len(entries):]
    assert bench == json.loads((REPO / "BENCHMARK.json").read_text())
    after = _digests(root)
    assert {rel: after.get(rel) for rel in before if rel != "BENCHMARK.json"} == \
        {rel: d for rel, d in before.items() if rel != "BENCHMARK.json"}


def _four_chip(bench, n):
    out = copy.deepcopy(bench)
    for w in out["workloads"][:n]:
        w["chips"] = 4
    return out


def test_contract_holds_the_four_chip_cap_and_the_cuts(probe):
    root, _ = probe
    package = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert len(bench["workloads"]) == 4
    contract(_four_chip(bench, 1), package)
    with pytest.raises(AssertionError, match="four chips"):
        contract(_four_chip(bench, 2), package)
    for reduced, why in (([], "differs from its file"), (["model", "datasets"], "differs"),
                         (["x" * 201], "not a name")):
        bad = copy.deepcopy(bench)
        bad["configs"][-1]["reduced"] = reduced
        with pytest.raises(AssertionError, match=why):
            contract(bad, package)
