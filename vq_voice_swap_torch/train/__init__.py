from .ema import EMA
from .loops import DiffusionTrainLoop, TrainLoop, VQVAETrainLoop
from .state import Optimizer, build_optimizer, prefix_predicate
from .steps import TrainStep, VQUpdateRule

__all__ = [
    "EMA",
    "DiffusionTrainLoop",
    "TrainLoop",
    "VQVAETrainLoop",
    "Optimizer",
    "build_optimizer",
    "prefix_predicate",
    "TrainStep",
    "VQUpdateRule",
]
