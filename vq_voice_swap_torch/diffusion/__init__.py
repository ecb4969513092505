from .process import Diffusion, broadcast_to_batch, input_grad
from .schedules import CosSchedule, ExpSchedule, Schedule, make_schedule
from .warp import make_warp

__all__ = [
    "Diffusion",
    "broadcast_to_batch",
    "input_grad",
    "Schedule",
    "ExpSchedule",
    "CosSchedule",
    "make_schedule",
    "make_warp",
]
