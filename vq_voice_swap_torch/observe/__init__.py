from .logger import SAVED_MSG, Logger, read_log
from .smoothing import moving_average
from .spans import span
from .tracker import LossTracker

__all__ = ["SAVED_MSG", "Logger", "read_log", "moving_average", "LossTracker", "span"]
