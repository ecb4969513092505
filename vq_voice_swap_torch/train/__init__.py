from .ema import EMA
from .loops import (ClassifierTrainLoop, DiffusionTrainLoop, EncoderPredictorTrainLoop,
                    TrainLoop, VQVAEAddClassesTrainLoop, VQVAETrainLoop, VQVAEUncondTrainLoop)
from .state import Optimizer, build_optimizer, prefix_predicate
from .steps import TrainStep, VQUpdateRule

__all__ = [
    "EMA",
    "ClassifierTrainLoop",
    "DiffusionTrainLoop",
    "EncoderPredictorTrainLoop",
    "TrainLoop",
    "VQVAEAddClassesTrainLoop",
    "VQVAETrainLoop",
    "VQVAEUncondTrainLoop",
    "Optimizer",
    "build_optimizer",
    "prefix_predicate",
    "TrainStep",
    "VQUpdateRule",
]
