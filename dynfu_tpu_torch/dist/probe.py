"""Which collectives gloo runs on CUDA tensors, on this machine.

    python3 -m dynfu_tpu_torch.dist.probe [--ranks 2]

Two local ranks on cuda:0 (gloo, as when ranks share a card) try each
collective the sharded engine uses (dist/spmd.py: all_gather, of float64,
int64 and uint8 tensors; torch.distributed's broadcast and all_reduce
beside them) and check the result; prints one JSON line, rank 0's.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from dynfu_tpu_torch.dist import runtime


def _try(fn):
    try:
        return bool(fn())
    except Exception as e:  # noqa: BLE001 - the probe reports what failed
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _probe() -> dict:
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)

    def gather(dtype):
        t = torch.full((4,), r + 1, dtype=dtype, device=dev)
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t)
        return all(bool((o == i + 1).all()) and o.is_cuda
                   for i, o in enumerate(out))

    def reduce():
        t = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == n * (n + 1) / 2).all())

    def bcast():
        t = torch.full((4,), float(r), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 0).all())

    res = {f"all_gather_{str(d).split('.')[-1]}": _try(lambda d=d: gather(d))
           for d in (torch.float64, torch.int64, torch.uint8)}
    res.update(all_reduce=_try(reduce), broadcast=_try(bcast),
               backend=dist.get_backend(), ranks=n,
               torch=torch.__version__)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    res = runtime.spawn(_probe, args.ranks, backend="gloo", inline=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
