from .sampler import DiffusionSampler, SamplerConfig
from .schedule import (Schedule, named_beta_schedule, space_timesteps,
                       spaced_schedule, train_schedule)

__all__ = ["DiffusionSampler", "SamplerConfig", "Schedule",
           "named_beta_schedule", "space_timesteps", "spaced_schedule",
           "train_schedule"]
