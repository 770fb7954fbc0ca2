"""A benchmark root at tiny widths for the CPU tests: ``BENCHMARK.json``
and the files of its cells, derived from a benchmark root's own (the
repository's by default), with the widths, the chain and the inputs cut so
that a run takes seconds on the CPU (the cells' and configurations' names
get a ``tiny_`` prefix).

Everything about a cell comes from its files: a configuration is cut only
in the parts it has, and each traffic mix, and each cell's check, is cut by
its kind's ``tiny(mix, size)`` and ``tiny_check(spec)``
(``portbench/kinds/<kind>.py``). This module imports nothing of the port."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.run import load_file_module

REPO = Path(__file__).resolve().parents[2]


def _cut(cfg, inner, groups, feats):
    """The configuration at tiny widths: the UNet's widths, ``image_size``
    and (for a chain not entered at ``t_start``) its schedules, the GAE's
    ``n_feats`` and the training crop, each where the configuration has
    it."""
    unet = cfg.get("model", {}).get("unet")
    if unet is not None:
        unet.update(inner_channel=inner, norm_groups=groups, channel_multiplier=[1, 2],
                    attn_res=[8], res_blocks=1)
        diffusion = cfg["model"]["diffusion"]
        diffusion["image_size"] = 16
        if not diffusion.get("t_start"):
            for sched in cfg["model"].get("beta_schedule", {}).values():
                sched["n_timestep"] = 3
    if "gae_widths" in cfg:
        cfg["gae_widths"]["n_feats"] = feats
    if "train" in cfg.get("datasets", {}):
        cfg["datasets"]["train"].update(l_resolution=4, batch_size=2)
    return cfg


def make_root(root, size=16, inner=8, groups=4, feats=8, limits=None, source=REPO):
    """Write the tiny root of the benchmark root ``source`` under ``root``
    and return it. ``limits`` overrides the checks' limits of every cell."""
    root, source = Path(root), Path(source)
    for d in ("configs", "traffic", "workloads"):
        (root / "portbench" / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((source / "BENCHMARK.json").read_text())
    names = {}
    for c in bench["configs"]:
        cfg = _cut(json.loads((source / c["file"]).read_text()), inner, groups, feats)
        names[c["name"]] = f"tiny_{c['name']}"
        c["name"], c["file"] = names[c["name"]], f"portbench/configs/tiny_{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        mix = json.loads((source / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        kind = load_file_module(source / "portbench" / "kinds" / f"{mix['kind']}.py")
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(kind.tiny(mix, size)))
        spec = json.loads((source / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        spec = kind.tiny_check(spec)
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
