"""Device times of a call on a CUDA card, by CUDA events.

:func:`cuda_ms` times back-to-back runs; :func:`queued_ms` times runs the
host enqueued while a sleep kernel held the card, so that a launch's host
time (a few hundred microseconds for a ctypes launch or a loop of small
torch calls) stays out of the device time. ``chip_smoke.py`` and the scripts
under ``pctd_tpu_torch/tools/`` time kernels with them. Imports torch only.
"""
import time

import torch

#: cycles of ``torch.cuda._sleep`` ahead of the first queued try (~10 ms)
SLEEP_CYCLES = 20_000_000
#: tries of :func:`queued_ms`; each sleeps at least twice as long as the last
QUEUE_TRIES = 4


def cuda_ms(fn, n: int) -> float:
    """Mean ms of ``fn`` over ``n`` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def queued_ms(fn, n: int):
    """(mean ms of ``fn`` over ``n`` runs by CUDA events, whether the host
    enqueued them all while a sleep kernel held the card), after one
    warm-up: the runs go in behind ``torch.cuda._sleep``, so the events time
    the device's work and not a launch's host time. The host's pace varies
    on a shared machine: a try whose enqueueing outlasted its sleep is run
    again behind a sleep twice as long as that enqueueing took, up to
    ``QUEUE_TRIES`` tries; the flag is that of the last try."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(QUEUE_TRIES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        s0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - s0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        sleep_ms = ev[0].elapsed_time(ev[1])
        ms = ev[1].elapsed_time(ev[2]) / n
        if host_ms < sleep_ms:
            return ms, True
        cycles = int(cycles * max(2.0, 2.0 * host_ms / sleep_ms))
    return ms, False
