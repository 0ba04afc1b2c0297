"""The one traffic generator: a cell's ``traffic`` parameters and the run's
seed in, the calls of a closed loop out.

Traffic comes in rounds.  Every round holds the same requests (sizes)
grouped into the same calls, so every seed asks for the
same work: the round's requests, sorted by size, are dealt into its calls
as cards are dealt (call ``c`` takes the ``c``-th, ``c + n``-th, ...
smallest of ``n`` calls), so each call mixes short and long requests as
arrivals would.  The seed orders the calls and the requests within each,
picks each request's content and each call's sampling seed.  Calls alternate
between greedy and sampled (``greedy_every``: call ``i`` of a round is
greedy when ``i % greedy_every == 0``), and the call holding the round's
longest request comes first, so the check of greedy answers always holds
the longest one.

Kind ``mels``: ``frames: [min, max]`` frame counts spread evenly over
``per_round`` requests; contents cut or repeated from the ``sources`` mels
at an offset drawn from the seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass
class Request:
    index: int                       # in the order of submission
    size: int                        # frames
    mel: np.ndarray


@dataclass
class Call:
    index: int
    requests: List[Request]
    greedy: bool
    seed: int


def _round_sizes(params: dict) -> List[int]:
    if params["kind"] != "mels":
        raise ValueError(f"unknown traffic kind {params['kind']!r}")
    lo, hi = params["frames"]
    return [int(round(v)) for v in np.linspace(lo, hi, params["per_round"])]


def calls(params: dict, seed: int, sources: List[np.ndarray]
          ) -> Iterator[Call]:
    """The endless stream of calls for ``seed`` (a 32-bit numpy seed)."""
    batch = params["batch"]
    greedy_every = params["greedy_every"]
    sizes = _round_sizes(params)
    if len(sizes) % batch:
        raise ValueError(f"a round of {len(sizes)} is not whole calls of "
                         f"{batch}")
    per_round = len(sizes) // batch
    if per_round % greedy_every:
        raise ValueError("a round's calls do not start on a greedy call")
    ranked = sorted(sizes)
    groups = [ranked[c::per_round] for c in range(per_round)]
    rng = np.random.default_rng(seed)
    n_req = n_call = 0
    while True:
        # the group holding the longest request first, the others shuffled
        order = [per_round - 1] + list(rng.permutation(per_round - 1))
        for c, g in enumerate(order):
            reqs = []
            for j in rng.permutation(batch):
                size = groups[g][j]
                src = sources[int(rng.integers(len(sources)))]
                idx = (int(rng.integers(len(src))) + np.arange(size)) % len(
                    src)
                reqs.append(Request(n_req, size, np.ascontiguousarray(
                    src[idx])))
                n_req += 1
            yield Call(n_call, reqs, c % greedy_every == 0,
                       int(rng.integers(2 ** 31)))
            n_call += 1
