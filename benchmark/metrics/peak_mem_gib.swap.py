"""The device's peak memory over the window
(``torch.cuda.max_memory_reserved`` after a reset at its start: what the
process holds of the card, a captured CUDA graph's private pool included),
in GiB."""


def read(window):
    peak = window.info.get("peak_bytes")
    return peak / 2**30 if peak else None
