"""The training step's share of the card's peak over the window: three
times the least time of the forward's convolutions and dense layers at
the peak of the type they run in (``counts.py``), for every step, over the
window's wall time, in %."""


def read(window):
    info = window.info
    if not info.get("steps"):
        return None
    return 100.0 * info["steps"] * info["peak_s_per_step"] / info["wall_s"]
