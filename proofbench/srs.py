"""The multilinear KZG SRS of a configuration, made by the program's own
setup from the configuration's ``srs_seed`` and kept in the benchmark's
cache directory (git-ignored, inside the checkout), so that later runs of
any cell with the same k and seed load it.

The file is the program's parameters object as ``torch.save`` writes it (a
tuple subclass is rebuilt from its items, past its own ``__new__``): the
benchmark names none of the program's classes or fields.  A file that no
longer loads, or whose tables no longer commit as the trapdoor says they
must (the program's layout changed under it), is made again.  The reference
never reads this file: it works every commitment out from the trapdoor
(reference/mlkzg.py)."""

from __future__ import annotations

import os
import pickle
import random
import types

from .reference import mlkzg
from .reference.field import BN254_R, MONT_R

PROBE_INDEX = 0x5A5A5A5A  # the evaluation the probe sets, its low k bits


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, tuple) and type(obj) is not tuple:
            return _tuple_of, (type(obj), tuple(obj))
        return NotImplemented


def _tuple_of(cls, items):
    return tuple.__new__(cls, items)


PICKLE = types.SimpleNamespace(Pickler=_Pickler, Unpickler=pickle.Unpickler, load=pickle.load,
                               __name__="pickle")


def path(cache_dir: str, k: int, srs_seed: int) -> str:
    return os.path.join(cache_dir, f"mlkzg_bn254_k{k}_seed{srs_seed}.pt")


def load_or_setup(cache_dir: str, k: int, srs_seed: int, pcs, setup, device):
    """The program's parameters for 2^k; ``setup(rng)`` makes them where the
    cache holds no copy that fits the program (``fits``)."""
    import torch

    file = path(cache_dir, k, srs_seed)
    if os.path.exists(file):
        try:
            param = torch.load(file, map_location=device, weights_only=False, pickle_module=PICKLE)
            if fits(pcs, param, k, srs_seed, device):
                return param
        except Exception:  # noqa: BLE001 - a file the program's classes no longer read
            pass
    param = setup(random.Random(srs_seed))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = file + ".partial"
    try:
        torch.save(param, tmp, pickle_module=PICKLE)
        os.replace(tmp, file)
    except (pickle.PicklingError, TypeError, AttributeError):
        # parameters that no longer pickle: every run makes them, and its
        # setup_s shows it
        if os.path.exists(tmp):
            os.remove(tmp)
    return param


def fits(pcs, param, k: int, srs_seed: int, device) -> bool:
    """Whether the program, committing with `param`, gives eq(s, b) G for
    the polynomial that is 1 at b and 0 elsewhere: one commitment of 2^k,
    the size every request has, judged by the trapdoor."""
    import numpy as np
    import torch
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    b = PROBE_INDEX & ((1 << k) - 1)
    one = np.frombuffer((MONT_R % BN254_R).to_bytes(32, "little"), dtype=np.int32)
    evals = torch.zeros((1 << k, 8), dtype=torch.int32, device=device)
    evals[b] = torch.from_numpy(one.copy()).to(device)
    pp, _ = pcs.trim(param, 1 << k, 1)
    point = pcs.commit(pp, MLPoly(BN254_FR, evals))
    answer = None if point.is_identity() else (int(point.x), int(point.y))
    return answer == mlkzg.commit_one_hot(mlkzg.trapdoor(k, srs_seed), b)
