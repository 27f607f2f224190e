"""The one traffic generator: reads a mix from ``traffic/<name>.json`` and
turns it into the stream of requests one client sends, each when the last is
answered (a closed loop).  Every request has the configuration's own size.

A mix file holds:

- ``op``: what each request asks of the system, ``"prove"`` (one proof of
  the configuration's circuit) or ``"commit"`` (one commitment of a fresh
  multilinear polynomial);
- ``inputs``: how many distinct inputs the client cycles through
  (``"fresh"`` for a new one every request, or a count: a pool made in
  set-up, request i taking input (i + 1) mod count, so no two requests in a
  row share one and the warm-up takes input 0);
- ``check_sample``: how many of the window's requests the reference checks
  (``null``: all of them), drawn from the seed;
- ``traced_requests``: how many whole requests at the start of a traced
  run's window the profiler records.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Iterator, List, Optional, Union

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("op", "inputs", "check_sample", "traced_requests")


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    op: str
    inputs: Union[str, int]
    check_sample: Optional[int]
    traced_requests: int


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    input_index: int  # the pool's index, or the request's own for fresh inputs


def load(name: str, root: str = HERE) -> Traffic:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        d = json.load(f)
    unknown = sorted(set(d) - set(KEYS))
    if unknown:  # a mix that asks for what this generator does not drive
        raise ValueError(f"traffic {name}: keys this generator does not read: {unknown}")
    t = Traffic(name=name, op=d["op"], inputs=d["inputs"], check_sample=d.get("check_sample"),
                traced_requests=int(d["traced_requests"]))
    if not (t.inputs == "fresh" or (isinstance(t.inputs, int) and t.inputs >= 2)):
        raise ValueError(f"traffic {name}: inputs is 'fresh' or a pool of 2 or more")
    return t


def stream(traffic: Traffic) -> Iterator[Request]:
    pooled = traffic.inputs != "fresh"
    i = 0
    while True:
        yield Request(i, (i + 1) % traffic.inputs if pooled else i)
        i += 1


def sample(traffic: Traffic, seed: int, count: int) -> List[int]:
    """The indices of the window's requests that the reference checks."""
    if traffic.check_sample is None or traffic.check_sample >= count:
        return list(range(count))
    return sorted(random.Random(seed ^ 0x5EED).sample(range(count), traffic.check_sample))
