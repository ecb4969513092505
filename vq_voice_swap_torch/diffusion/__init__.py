from .process import Diffusion, broadcast_to_batch
from .schedules import CosSchedule, ExpSchedule, Schedule, make_schedule

__all__ = [
    "Diffusion",
    "broadcast_to_batch",
    "Schedule",
    "ExpSchedule",
    "CosSchedule",
    "make_schedule",
]
