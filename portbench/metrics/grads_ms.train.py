"""Device milliseconds per training step in the UNet's forward and
backward: the program's ``train.grads`` spans
(``train/ddpm_model.py:compute_grads``: the loss's draws, the forward, the
loss and its backward), by their CUDA events."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.per_call(run, ["train.grads"])
