"""Seeded request-arrival traces for the cluster simulator.

A copy of ``repro/cluster/traces.py`` (numpy only), held equal to it by
``tests/test_torch_cluster.py``.

A trace is a list of :class:`Request` rows sorted by arrival time, rids
assigned in arrival order.  Three generator families:

* :func:`poisson_trace` — memoryless arrivals (exponential gaps at
  ``rate_rps``), the open-loop baseline every queueing result assumes;
* :func:`bursty_trace` — Poisson *burst epochs*, each delivering a whole
  batch of back-to-back requests — the flash-crowd shape that separates
  backlog-aware routing policies from round-robin;
* :func:`replay_trace` — replay a recorded trace (JSON rows), so measured
  production arrivals drive the same simulator.

Everything is driven by one ``numpy`` Generator seeded explicitly: the
same seed produces the bit-identical request sequence (arrival floats
included), which is what makes simulated runs replayable and the
determinism tests meaningful.  Poisson gaps are sampled as
``exp(1) / rate``, so the SAME seed at a different rate yields exactly
time-scaled arrivals — the makespan-monotonicity property tests rely on
this coupling.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np

__all__ = ["Request", "poisson_trace", "bursty_trace", "replay_trace",
           "trace_to_json", "save_trace", "make_trace"]


@dataclass(frozen=True)
class Request:
    """One serving request: arrival time plus its two phase extents."""

    rid: int
    arrival_s: float
    prompt_tokens: int
    new_tokens: int

    def to_json(self) -> dict:
        return {"rid": self.rid, "arrival_s": self.arrival_s,
                "prompt_tokens": self.prompt_tokens,
                "new_tokens": self.new_tokens}


def _lengths(rng: np.random.Generator, n: int,
             bounds: Tuple[int, int]) -> np.ndarray:
    lo, hi = bounds
    if lo > hi:
        raise ValueError(f"bad length bounds {bounds}: lo > hi")
    return rng.integers(lo, hi + 1, size=n)


def _finish(arrivals, prompts, news) -> List[Request]:
    order = np.argsort(arrivals, kind="stable")
    return [
        Request(rid=i, arrival_s=float(arrivals[j]),
                prompt_tokens=int(prompts[j]), new_tokens=int(news[j]))
        for i, j in enumerate(order)
    ]


def poisson_trace(
    n: int,
    *,
    rate_rps: float,
    seed: int,
    prompt_tokens: Tuple[int, int] = (8, 64),
    new_tokens: Tuple[int, int] = (4, 16),
) -> List[Request]:
    """``n`` Poisson arrivals at ``rate_rps`` requests/second.

    Gaps are ``standard exponential / rate``, so the same seed at two
    rates gives exactly time-scaled arrival sequences (same request
    shapes) — higher rate compresses the identical workload.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.standard_exponential(n) / rate_rps
    arrivals = np.cumsum(gaps)
    return _finish(arrivals, _lengths(rng, n, prompt_tokens),
                   _lengths(rng, n, new_tokens))


def bursty_trace(
    n: int,
    *,
    rate_rps: float,
    burst: int = 4,
    seed: int = 0,
    prompt_tokens: Tuple[int, int] = (8, 64),
    new_tokens: Tuple[int, int] = (4, 16),
) -> List[Request]:
    """``n`` requests arriving in bursts of ``burst`` at Poisson epochs.

    The aggregate rate stays ``rate_rps`` (burst epochs fire at
    ``rate_rps / burst``); every request in a burst shares the epoch's
    arrival instant, which is exactly the simultaneous-arrival window the
    max-flow placement policy solves jointly.
    """
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    rng = np.random.default_rng(seed)
    n_epochs = (n + burst - 1) // burst
    gaps = rng.standard_exponential(n_epochs) / (rate_rps / burst)
    epochs = np.cumsum(gaps)
    arrivals = np.repeat(epochs, burst)[:n]
    return _finish(arrivals, _lengths(rng, n, prompt_tokens),
                   _lengths(rng, n, new_tokens))


def replay_trace(rows: Union[str, Path, Sequence[dict]]) -> List[Request]:
    """Rebuild a trace from recorded rows (a JSON file path or the parsed
    list) — ``arrival_s``/``prompt_tokens``/``new_tokens`` per row; rids
    are reassigned in arrival order so replays are self-consistent."""
    if isinstance(rows, (str, Path)):
        rows = json.loads(Path(rows).read_text())
    if isinstance(rows, dict):
        rows = rows["requests"]
    arrivals = np.asarray([float(r["arrival_s"]) for r in rows])
    prompts = np.asarray([int(r["prompt_tokens"]) for r in rows])
    news = np.asarray([int(r["new_tokens"]) for r in rows])
    return _finish(arrivals, prompts, news)


def trace_to_json(trace: Sequence[Request]) -> dict:
    return {"requests": [r.to_json() for r in trace]}


def save_trace(trace: Sequence[Request], path: Union[str, Path]) -> None:
    Path(path).write_text(json.dumps(trace_to_json(trace), indent=1))


def make_trace(spec: str, *, n: int, seed: int,
               prompt_tokens: Tuple[int, int] = (8, 64),
               new_tokens: Tuple[int, int] = (4, 16)) -> List[Request]:
    """Parse a CLI trace spec into a trace.

    ``"poisson:RATE"`` / ``"bursty:RATE[,BURST]"`` build the seeded
    generators; anything else is a path to a recorded JSON trace
    (:func:`replay_trace` — ``n``/``seed`` are ignored for replays).
    """
    kw = dict(prompt_tokens=prompt_tokens, new_tokens=new_tokens)
    if spec.startswith("poisson:"):
        return poisson_trace(n, rate_rps=float(spec.split(":", 1)[1]),
                             seed=seed, **kw)
    if spec.startswith("bursty:"):
        parts = spec.split(":", 1)[1].split(",")
        burst = int(parts[1]) if len(parts) > 1 else 4
        return bursty_trace(n, rate_rps=float(parts[0]), burst=burst,
                            seed=seed, **kw)
    return replay_trace(spec)
