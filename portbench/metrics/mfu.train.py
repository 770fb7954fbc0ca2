"""The whole training step's share of the card's dense bf16 peak, %: the
analytic operations of the calls the traced part of the window finished
(``roofline.train_step_flops``) over its seconds x the peak."""

from portbench import roofline


def read(run):
    if run.device.type != "cuda":
        return None
    return roofline.peak_share(run.work_flops * run.traced_calls, run.traced_s, run.device_name)
