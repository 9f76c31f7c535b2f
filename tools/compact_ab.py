"""The trainer's stable compaction three ways, timed in one process on one
CUDA device.

    python tools/compact_ab.py [--rounds 3]

``parallel/train.py::_compact`` moves the ids a merge kept to the front
of the shard, in order, and the holes (-1) behind them, once per merge.
The JAX reference does it with one payload sort on index keys because
TPU scatters are slow.  On the card three forms compute the same thing:

* ``sort``: the reference's keys (``i`` for kept ids, ``n + i`` for
  holes), ``torch.sort``, and a gather of the ids by the sorted order;
* ``argsort``: a stable ``torch.argsort`` of the one-byte hole mask and
  a gather (the port's ``_compact``);
* ``scatter``: an inclusive cumsum of the kept mask gives every element
  its destination, and one scatter moves it.

Each is held equal to ``_compact`` on every input, then each round
times them in the order sort, argsort, scatter, scatter, argsort, sort
with ``scripts/common.py::cuda_time``.  Inputs: a shard of ``N`` =
2^22 ids (the 4 MB training corpus has 4,000,000) as the start of
training leaves one (2 % holes spread through it) and as its end does
(a 40 % pad tail, 0.5 % holes in the rest).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hutoken_tpu_torch.parallel.train import _compact  # noqa: E402
from hutoken_tpu_torch.scripts.common import card_label, cuda_time  # noqa: E402

N = 1 << 22


def by_sort(new: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(new.shape[0], dtype=torch.int32, device=new.device)
    keys = torch.where(new != -1, idx, new.shape[0] + idx)
    return new.index_select(0, torch.sort(keys).indices)


def by_scatter(new: torch.Tensor) -> torch.Tensor:
    keep = new != -1
    kept = torch.cumsum(keep, 0, dtype=torch.int32)
    idx = torch.arange(new.shape[0], dtype=torch.int32, device=new.device)
    dst = torch.where(keep, kept - 1, kept[-1] + idx - kept)
    return torch.empty_like(new).scatter_(0, dst.long(), new)


FORMS = {"sort": by_sort, "argsort": _compact, "scatter": by_scatter}


def shard(n: int, holes: float, live: float, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, 5256, (n,), generator=g, device="cuda", dtype=torch.int32)
    ids[torch.rand(n, generator=g, device="cuda") < holes] = -1
    ids[int(n * live):] = -1
    return ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compact_ab: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    label = card_label()
    print(label)
    for what, holes, live in (("start", 0.02, 1.0), ("end", 0.005, 0.6)):
        new = shard(N, holes, live, seed=len(what))
        want = _compact(new)
        for name, fn in FORMS.items():
            if not torch.equal(fn(new), want):
                raise RuntimeError(f"compact_ab: {name} differs from _compact ({what})")
        order = list(FORMS) + list(reversed(FORMS))
        for r in range(args.rounds):
            ms = {name: [] for name in FORMS}
            for name in order:
                ms[name].append(cuda_time(lambda: FORMS[name](new)))
            print(f"[{label}] compact {N} ids at the {what} of training ({holes:.1%} holes, "
                  f"{1 - live:.0%} pad tail), round {r}: "
                  + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
