"""Seconds from the start of the process to the first timed call: imports,
the kernels' build or load, weights and inputs made from the seed, the
program built and every shape the traffic uses warmed up."""


def read(run):
    return run.setup_s
