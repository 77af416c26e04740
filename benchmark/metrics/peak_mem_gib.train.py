"""Layer: the device. The allocator's peak (``max_memory_allocated``) over
set-up and the window, in GiB: the step graph's memory is allocated at
its capture, in set-up, so the window's peak alone leaves the step out.
The same quantity as the result's ``memory_peak_bytes``."""


def read(run):
    peaks = [p for p in (run.setup_peak_bytes, run.window_peak_bytes) if p]
    if run.kind != "train" or not peaks:
        return None
    return max(peaks) / 2 ** 30
