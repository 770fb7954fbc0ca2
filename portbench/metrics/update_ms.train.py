"""Device milliseconds per training step in the update: the program's
``train.update`` spans (``train/ddpm_model.py:apply_gradients``: Adam, the
lr schedule, the EMA), by their CUDA events."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.per_call(run, ["train.update"])
