"""Beta schedules, the SR3 and DDPM diffusions and their samplers."""

from .gaussian import DDPMDiffusion, GaussianDiffusion, split_generator
from .schedules import DiffusionSchedule, make_beta_schedule

__all__ = ["DDPMDiffusion", "DiffusionSchedule", "GaussianDiffusion", "make_beta_schedule",
           "split_generator"]
