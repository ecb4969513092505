from .logger import SAVED_MSG, Logger
from .smoothing import moving_average
from .tracker import LossTracker

__all__ = ["SAVED_MSG", "Logger", "moving_average", "LossTracker"]
