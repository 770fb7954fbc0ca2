"""Where the fused Block kernel's time goes: ablations of its K loop, on the card.

    python -m hsi_dmgasr_tpu_torch.tools.fused_conv_ablation

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
It builds ``csrc/fused_conv.cu`` as it is and with parts of its K loop
taken out (one nvcc per variant, all at once), and times each variant's
launch alone, replayed in a CUDA graph, at three main-path signatures of
the fused Block (B=9). A variant without its copies or its barrier
computes garbage: only its time means anything. Each ablation is a set of
exact edits of the source; the script stops if one no longer applies.
Prints one line per variant and signature, and writes
``chiprun_out/fused_conv_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import build
from ..kernels import fused_conv as fc

ROOT = Path(__file__).resolve().parents[2]

_LOADS = ("    if (st + STAGES - 1 < TT) load_stage(st + STAGES - 1);\n", "")
_BARRIER = ("    cp_async_wait<STAGES - 2>();\n    __syncthreads();", "")
_ACTIVATION = ("    if (c1 < J) transform(st);\n", "")
_MMA = ("      warp_step<MT, NT, SPLIT>(acc, act_s",
        "      if (TT < 0) warp_step<MT, NT, SPLIT>(acc, act_s")

# name -> edits of the source; each part of a K step taken out in turn
ABLATIONS = {
    "full": (),
    "without activation": (_ACTIVATION,),
    "without MMAs": (_MMA,),
    "MMAs and barrier": (_LOADS, _ACTIVATION),
    "MMAs only": (_LOADS, _BARRIER, _ACTIVATION),
    "copies and barrier": (_MMA, _ACTIVATION),
}

# (x shape, C2, Cout, time bias, residual, stats_in, stats_in2, stats, proj),
# as chip_smoke.py records them
SIGNATURES = (
    ((9, 128, 128, 256), 0, 256, False, True, True, False, True, False),
    ((9, 512, 512, 64), 0, 64, True, False, False, False, True, False),
    ((9, 64, 64, 1024), 0, 512, True, False, False, False, True, True),
)


def build_variant(name, edits, out_dir):
    src = (build.CSRC / "fused_conv.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {name!r}: edit no longer applies: {old!r}")
        src = src.replace(old, new)
    stem = name.replace(" ", "_")
    cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for ablation {name!r}:\n{proc.stderr[-4000:]}")
    return so


def main():
    if not torch.cuda.is_available():
        print("fused_conv_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(ABLATIONS)) as pool:
        libs = dict(zip(ABLATIONS, pool.map(
            lambda kv: build_variant(kv[0], kv[1], out_dir), ABLATIONS.items())))
    card = cs.card_line()
    print(card)
    cases = [(sig, *cs.make_inputs(sig, "cuda", 7)) for sig in SIGNATURES]
    rows = []
    for name, so in libs.items():
        build._LIBS["fused_conv"] = ctypes.CDLL(str(so))
        for sig, args, kw in cases:
            packed = fc.pack_conv3x3(args[3], kw.get("res_kernel"))
            ms = cs.graph_ms(cs.bare_launch(fc, args, kw, packed))
            bound_ms, _ = cs.bound(sig)
            rows.append({"variant": name, "signature": cs.describe(sig), "kernel_ms": ms,
                         "bound_ms": bound_ms})
            print(f"{name:<20} {cs.describe(sig):<40} kernel alone {ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "fused_conv_ablation.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
