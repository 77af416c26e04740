"""``utils.cuda_timing.queued_ms`` on a simulated card: the timed runs go in
behind a sleep kernel, a try whose enqueueing outlasts its sleep is run again
behind a longer sleep, and the flag says whether the last try was queued.
The card, its events and the host's clock are stand-ins, so this runs on the
CPU."""
import pytest

from pctd_tpu_torch.utils import cuda_timing

#: the simulated card's clock for ``torch.cuda._sleep``, cycles a ms
CYCLES_PER_MS = 2_000_000


class _Card:
    """A card that runs its queue with no gaps, and a host clock: an event
    reads the card's time, a sleep adds cycles / CYCLES_PER_MS ms of device
    work, and a timed call adds ``device_ms`` to the card and ``host_ms(i)``
    (i = the call's index) to the host's clock."""

    def __init__(self, monkeypatch, device_ms, host_ms):
        self.device = 0.0
        self.host = 0.0
        self.calls = 0
        self.sleeps = []
        self.device_ms, self.host_ms = device_ms, host_ms
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self):
                self.t = card.device

            def elapsed_time(self, other):
                return other.t - self.t

        def sleep(cycles):
            card.sleeps.append(cycles)
            card.device += cycles / CYCLES_PER_MS

        monkeypatch.setattr(cuda_timing.torch.cuda, "Event", Event)
        monkeypatch.setattr(cuda_timing.torch.cuda, "_sleep", sleep)
        monkeypatch.setattr(cuda_timing.torch.cuda, "synchronize",
                            lambda: None)
        monkeypatch.setattr(cuda_timing.time, "perf_counter",
                            lambda: card.host / 1e3)

    def fn(self):
        self.device += self.device_ms
        self.host += self.host_ms(self.calls)
        self.calls += 1


def _first_sleep_ms():
    return cuda_timing.SLEEP_CYCLES / CYCLES_PER_MS


@pytest.mark.parametrize("n", [1, 3, 10])
def test_a_host_within_the_first_sleep_takes_one_try(monkeypatch, n):
    per_call = 0.5 * _first_sleep_ms() / n
    card = _Card(monkeypatch, 0.25, lambda i: per_call)
    ms, queued = cuda_timing.queued_ms(card.fn, n)
    assert queued and ms == pytest.approx(0.25)
    assert card.sleeps == [cuda_timing.SLEEP_CYCLES]
    assert card.calls == 1 + n          # the warm-up and the timed runs


@pytest.mark.parametrize("slower", [1.5, 4.0])
def test_a_slow_host_gets_a_sleep_twice_its_enqueueing(monkeypatch, slower):
    n = 3
    card = _Card(monkeypatch, 0.5, lambda i: slower * _first_sleep_ms() / n)
    ms, queued = cuda_timing.queued_ms(card.fn, n)
    assert queued and ms == pytest.approx(0.5)
    first, second = card.sleeps
    assert first == cuda_timing.SLEEP_CYCLES
    assert second == int(first * max(2.0, 2.0 * slower))
    assert card.calls == 1 + 2 * n


def test_a_host_that_never_keeps_up_is_reported(monkeypatch):
    n = 2
    # each call's host time grows tenfold, past every doubled sleep
    card = _Card(monkeypatch, 1.0,
                 lambda i: _first_sleep_ms() * 10.0 ** i)
    ms, queued = cuda_timing.queued_ms(card.fn, n)
    assert not queued and ms == pytest.approx(1.0)
    assert len(card.sleeps) == cuda_timing.QUEUE_TRIES
    assert all(b >= 2 * a for a, b in zip(card.sleeps, card.sleeps[1:]))
