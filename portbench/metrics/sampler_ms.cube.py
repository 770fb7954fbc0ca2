"""Device milliseconds per cube call in the sampler itself: the program's
``sampler.chain`` spans (``train/ddpm_model.py:_run_chain``, all chunks)
less their ``unet.forward`` children, by their CUDA events: the chain's
draws, the posterior's arithmetic and its glue between forwards."""

from portbench import program_spans

program_spans.start()


def read(run):
    total = program_spans.self_ms(program_spans.in_window(run), "sampler.chain", "unet.forward")
    return None if total is None else total / run.n_calls
