"""The swap's share of the card's peak over the window: the least time of
its batches' convolutions and dense layers, each at the published peak of
the type it runs in (``counts.py``), over the window's wall time, in %."""


def read(window):
    info = window.info
    if not info.get("batches"):
        return None
    return 100.0 * info["batches"] * info["peak_s_per_batch"] / info["wall_s"]
