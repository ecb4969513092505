"""Host ms a train step that the window spent taking its batches from the
program's loader (``next()`` and ``prepare_batch``), timed by the driver
around those calls."""


def read(window):
    info = window.info
    if not info.get("steps") or "data_wait_s" not in info:
        return None
    return 1e3 * info["data_wait_s"] / info["steps"]
