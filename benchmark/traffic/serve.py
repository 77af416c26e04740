"""The serving driver: requests of the four latent-control workflows
arrive at the program's ``Sampler`` at a rate fixed in the mix
(``rate_per_s``, evenly spaced: an open loop), and are answered one at a
time in arrival order, as the JSON-lines daemon answers them. A request
is timed from its arrival to its grid in hand, so the wait behind
earlier requests counts. Every request that arrives in the window is
answered: the window ends with the last answer.

The mix file names the route and the batching (``frame_decoder``,
``fixed_batch``), the share of each workflow, the sizes (``windows``:
2-bar windows a request, spread log-uniformly or linearly between
``min`` and ``max``; an interpolation takes ``pairs`` and decodes
``int_count`` points a pair), each workflow's options, and the deck:
``deck`` requests with every share, size and option fixed by the mix,
in a fixed shuffled order, with contents drawn from the seed, sent round
and round. Every seed thus sends the same sizes at the same times, so
the queueing in front of each request is the mix's, not the seed's.
Set-up warms each workflow (``warm``: ``each_kind``, its smallest and
largest request; ``each_size``, every request of the deck once, where
the rows of a request are a shape of their own).

After the window the traffic driver keeps a sample of answered requests drawn
from the seed, the deck's longest among them (``check_requests``), and
the plain reference reads the widest gap by which a served token's logit
lies below the reference's best (``logit_gap``)."""
from __future__ import annotations

import contextlib
import math
import sys
import time
from typing import List

import numpy as np
import torch

from benchmark import harness, port
from benchmark.reference import serve as ref_serve
from benchmark.reference.model import Reference, make_weights

KINDS = ("swap", "posterior_sample", "prior_sample", "interp")
#: the mix cut to a few tiny requests, and the configuration at the
#: program's CPU-test widths: the size of the benchmark's CPU tests
TINY_MIX = {"deck": 4, "check_requests": 4, "trace_requests": 2,
            "windows": {"min": 2, "max": 4, "spread": "log"},
            "interp": {"pairs": {"min": 1, "max": 2}, "int_count": 3,
                       "what": ["chord", "texture", "both"]}}
tiny_config = port.tiny_config


def _split(total: int, shares: dict) -> dict:
    """``total`` requests over the kinds in proportion to their shares
    (largest remainders)."""
    raw = {k: total * shares.get(k, 0.0) for k in KINDS}
    n = {k: int(math.floor(v)) for k, v in raw.items()}
    for k in sorted(KINDS, key=lambda k: n[k] - raw[k])[:total - sum(
            n.values())]:
        n[k] += 1
    return n


def _quantiles(spec: dict, m: int) -> List[int]:
    """m sizes at the mid-quantiles of the size spread of ``spec``."""
    lo, hi = spec["min"], spec["max"]
    q = (np.arange(m) + 0.5) / m
    if spec.get("spread", "linear") == "log":
        v = lo * (hi / lo) ** q
    else:
        v = lo + (hi - lo) * q
    return [int(round(x)) for x in v]


def songs(rng: np.random.Generator, n: int, T: int, density: float,
          max_dur: int):
    """Synthetic 2-bar windows: (duration matrices (n, T, 128), expanded
    chords (n, T/4, 36)), sparse onsets with durations 1..max_dur, chords
    of a root one-hot, a chroma and a bass one-hot."""
    pr = np.zeros((n, T, 128), np.float32)
    on = rng.random((n, T, 128)) < density
    pr[on] = rng.integers(1, max_dur + 1, int(on.sum()))
    s = T // 4
    c = np.zeros((n, s, 36), np.float32)
    rows, steps = np.arange(n)[:, None], np.arange(s)[None, :]
    c[rows, steps, rng.integers(0, 12, (n, s))] = 1.0
    c[..., 12:24] = rng.integers(0, 2, (n, s, 12))
    c[rows, steps, 24 + rng.integers(0, 12, (n, s))] = 1.0
    return pr, c


def make_deck(mix: dict, T: int, rng: np.random.Generator) -> List[dict]:
    """The mix's deck of requests, in its fixed order, with contents drawn
    from ``rng``."""
    counts = _split(mix["deck"], mix["workflows"])
    deck = []
    for kind in KINDS:
        n = counts[kind]
        if not n:
            continue
        opts = mix.get(kind, {})
        sizes = (_quantiles(opts["pairs"], n) if kind == "interp"
                 else _quantiles(mix["windows"], n))
        for i, size in enumerate(sizes):
            args = {k: v[i % len(v)] for k, v in opts.items()
                    if isinstance(v, list)}
            if kind == "interp":
                args["int_count"] = opts["int_count"]
            deck.append({"kind": kind, "args": args, "windows": size,
                         "rows": size * args.get("int_count", 1)})
    deck = [deck[i] for i in np.random.default_rng(0).permutation(len(deck))]
    for req in deck:
        n = req["windows"]
        req["pr1"], req["c1"] = songs(rng, n, T, mix["onset_density"],
                                      mix["max_duration"])
        if req["kind"] in ("swap", "interp"):
            req["pr2"], req["c2"] = songs(rng, n, T, mix["onset_density"],
                                          mix["max_duration"])
    return deck


def send(sampler, req: dict, seed: int, device) -> np.ndarray:
    """One request through the Sampler's workflow; the grid as numpy."""
    kind, a = req["kind"], req["args"]
    if kind == "swap":
        fix_chd = a["fix"] == "chord"
        return sampler.swap(req["pr1"], req["pr2"], req["c1"], req["c2"],
                            fix_rhy=not fix_chd, fix_chd=fix_chd)
    if kind == "interp":
        return sampler.interp(
            req["pr1"], req["c1"], req["pr2"], req["c2"],
            interp_chd=a["what"] in ("chord", "both"),
            interp_rhy=a["what"] in ("texture", "both"),
            int_count=a["int_count"])
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "posterior_sample":
        return sampler.posterior_sample(gen, req["pr1"], req["c1"],
                                        scale=a["scale"])
    return sampler.prior_sample(
        gen, req["pr1"], req["c1"],
        sample_chd=a["sample"] in ("chord", "both"),
        sample_rhy=a["sample"] in ("texture", "both"), scale=a["scale"])


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, tracer=None):
        self.cell, self.mix, self.w = cell, cell.mix, cell.widths
        self.seed, self.device, self.tracer = seed, device, tracer
        self.rng_check = np.random.default_rng(
            harness.sub_seed(seed, "check"))
        self.send_base = harness.sub_seed(seed, "sends") >> 8
        self.sample, self.longest = [], None

    def setup(self) -> None:
        self.weights = make_weights(self.w, harness.sub_seed(self.seed,
                                                             "weights"),
                                    self.device)
        served = {k: v.clone() for k, v in self.weights.items()}
        self.sampler = port.Sampler(
            port.params_tree(served), port.model_config(self.cell.config),
            frame_decoder=self.mix["frame_decoder"],
            fixed_batch=self.mix["fixed_batch"], device=self.device)
        self.deck = make_deck(self.mix, self.w.T, np.random.default_rng(
            harness.sub_seed(self.seed, "requests")))
        if self.mix["warm"] == "each_size":
            warm = self.deck
        else:
            warm = []
            for kind in KINDS:
                mine = [r for r in self.deck if r["kind"] == kind]
                if mine:
                    warm += [min(mine, key=lambda r: r["rows"]),
                             max(mine, key=lambda r: r["rows"])]
        for i, req in enumerate(warm):
            send(self.sampler, req, i, self.device)
        if self.tracer is not None:
            self.tracer.warm()

    def _keep(self, i: int, req: dict, seed: int, grid) -> None:
        """Reservoir sample of the answered requests, from the seed; the
        deck's longest request is kept at its first answer."""
        item = (dict(req, seed=seed), grid)
        k = self.mix["check_requests"]
        if len(self.sample) < k:
            self.sample.append(item)
        else:
            j = int(self.rng_check.integers(0, i + 1))
            if j < k:
                self.sample[j] = item
        if self.longest is None and req["rows"] == self.max_rows:
            self.longest = item

    def run_window(self, run) -> None:
        seconds, tracer = run.seconds, self.tracer
        n_trace = self.mix["trace_requests"] if tracer is not None else 0
        self.max_rows = max(r["rows"] for r in self.deck)
        gap = 1.0 / self.mix["rate_per_s"]
        start, i, answered = run.window_t0, 0, 0
        close = start + seconds
        while i == 0 or start + i * gap < close:
            req = self.deck[i % len(self.deck)]
            arrival = start + i * gap
            wait = arrival - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            traced = i < n_trace
            if traced and i == 0:
                tracer.start()
            seed = self.send_base + i
            with tracer.span() if traced else contextlib.nullcontext():
                t0 = time.perf_counter()
                try:
                    grid = send(self.sampler, req, seed, self.device)
                    ok = True
                except Exception as e:          # a failed request is missing
                    print(f"request {i} ({req['kind']}, {req['rows']} rows) "
                          f"failed: {type(e).__name__}: {e}", file=sys.stderr,
                          flush=True)
                    ok = False
                t1 = time.perf_counter()
            if traced and i == n_trace - 1:
                tracer.stop()
            run.requests.append(harness.Request(arrival, t0, t1, req["rows"],
                                                req["kind"], traced, ok))
            if ok:
                self._keep(answered, req, seed, grid)
                answered += 1
            i += 1
        if 0 < i < n_trace:
            tracer.stop()
        run.window_s = run.requests[-1].t1 - start

    def release(self) -> None:
        del self.sampler

    def _served(self):
        return self.sample + ([self.longest] if self.longest else [])

    def check(self) -> dict:
        """{"logit_gap": (the widest gap of the sampled served tokens, its
        limit)}."""
        harness.reference_precision()
        ref = Reference(self.weights, self.w)
        gap = ref_serve.served_gap(ref, self._served(), self.device)
        return {"logit_gap": (gap, self.cell.limits.get("logit_gap",
                                                        float("nan")))}

    def control(self, emulate: bool = False) -> float:
        """The lower-precision control's gap on the same sample (TF32 on
        the card; emulated TF32 elsewhere)."""
        harness.reference_precision()
        ref = Reference(self.weights, self.w)
        if emulate:
            ctrl = Reference(self.weights, self.w, tf32="emulate")
            ctx = contextlib.nullcontext
        else:
            ctrl, ctx = ref, harness.tf32_on
        return ref_serve.control_gap(ref, ctrl, self._served(), self.device,
                                     ctx)

