"""A benchmark root at tiny widths for the CPU tests: ``BENCHMARK.json``
and the files of its cells, derived from the repository's own, with the
widths, the chain and the cubes cut so that a run takes seconds on the
CPU (the cells' names get a ``tiny_`` prefix)."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _cut(cfg, inner, groups, feats, steps):
    cfg["gae_widths"]["n_feats"] = feats
    cfg["model"]["unet"].update(inner_channel=inner, norm_groups=groups,
                                channel_multiplier=[1, 2], attn_res=[8], res_blocks=1)
    cfg["model"]["diffusion"]["image_size"] = 16
    if steps:
        for phase in ("train", "val"):
            cfg["model"]["beta_schedule"][phase]["n_timestep"] = steps
    cfg["datasets"]["train"].update(l_resolution=4, batch_size=2)
    return cfg


def make_root(root, size=16, inner=8, groups=4, feats=8, limits=None):
    """Write the tiny root under ``root`` and return it. ``limits``
    overrides the checks' limits of every cell."""
    root = Path(root)
    for d in ("configs", "traffic", "workloads"):
        (root / "portbench" / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {}
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        steps = None if cfg["model"]["diffusion"].get("t_start") else 3
        cfg = _cut(cfg, inner, groups, feats, steps)
        names[c["name"]] = f"tiny_{c['name']}"
        c["name"], c["file"] = names[c["name"]], f"portbench/configs/tiny_{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    mixes = {"cube": {"kind": "cube", "size": size, "batch": 1, "pool": 2},
             "train": {"kind": "train", "scenes": 2, "scene_size": 2 * size}}
    for name, mix in mixes.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for w in bench["workloads"]:
        spec = json.loads((REPO / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        if "check" in spec:
            spec["check"] = {"calls": 2, "within": 3}
        if limits is not None:
            spec["limits"] = {k: limits for k in spec["limits"]}
        w["name"], w["config"] = f"tiny_{w['name']}", names[w["config"]]
        (root / "portbench" / "workloads" / f"{w['name']}.json").write_text(json.dumps(spec))
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [f"tiny_{n}" for n in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
