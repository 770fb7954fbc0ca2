"""Device milliseconds per training step making its latents: the
program's ``train.crops`` (``DeviceSceneCache.sample``), ``train.degrade``
(the bicubic down and up on the card) and ``train.encode`` (both GAE
encodes) spans, by their CUDA events."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.per_call(run, ["train.crops", "train.degrade", "train.encode"])
