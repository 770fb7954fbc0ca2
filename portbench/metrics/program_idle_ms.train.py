"""Device idle milliseconds per traced training step that begin while the
host is inside one of the program's ``train.*`` spans: the gaps between
the union of the device operations in torch.profiler's raw events, each
put under the innermost program span (a CPU range of the profiler)
containing its start, over the steps of the traced part of the window.
Prints every span's idle milliseconds a step on standard error."""

import sys
import time

from portbench import program_spans

program_spans.start()


def read(run):
    names = {s["name"] for s in program_spans.recorded()}
    profile = getattr(run, "profile", None)
    if not names or profile is None:
        return None
    t0 = time.perf_counter()
    device, ranges = program_spans.profile_intervals(profile.profiler.kineto_results.events(),
                                                     names)
    if not device:
        return None
    by_name, under = program_spans.idle_by_span(device, ranges, "train.")
    steps = run.traced_calls
    table = {k: round(v / 1e6 / steps, 4)
             for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    print(f"portbench: program idle ms a step by innermost span ({steps} steps, "
          f"read in {time.perf_counter() - t0:.1f} s): {table}", file=sys.stderr)
    return under / 1e6 / steps
