"""One rank of the cross-rank hop exchange K12 (``parallel/rdma_exchange.py::
rank_exchange_rdma``, ``csrc/rank_exchange.cu``), held against its plain
versions and timed.

Every rank of one EP group of ``world`` ranks makes every shard's wire
buffers [TW, H] from one numpy seed and takes its own; then, for each caps
and dtype of the job:

* the exchange both ways against the one-process plain version
  (``_ring_move`` of all the shards' buffers) and against gloo's
  point-to-point move of the same buffer (``ep_pack._rank_ring_move``),
  bit for bit;
* the autograd backward against the inverse exchange of the cotangents;
* ``calls`` exchanges back to back (every third one inverse), each on the
  last one's output with no host sync between them, against the same
  chain of plain moves: both slots of a plan over many epochs;
* with ``time`` (the card): the median host ms of one synchronized
  exchange over ``calls`` calls for the cross-rank K12 and gloo's move,
  and, on rank 0 while the others wait at a barrier, the one-process K12
  (``ring_exchange_rdma``) on all the shards' buffers;
* with ``missing`` (the card): a new plan that every rank makes, then one
  more exchange that shard ``missing`` never calls, each wait bounded by
  ``timeout_s``: a rank that has that shard as a source must raise at its
  next synchronizing read, naming it.

Then it closes its plans.  On the CPU the wrapper takes gloo's move, so
there the checks hold the routing and the semantics, not the kernel.

  python -m cgr_mpnn_3d_tpu_torch.tools.k12_ranks '<job json>'

runs one rank: the job's ``init`` (``file://...`` or ``tcp://host:port``),
``world`` and ``rank`` join the gloo group, the rest is :func:`run`'s job
(``caps``, ``dtypes``, ``H``, ``seed``, ``calls``, ``time``, ``missing``,
``timeout_s``, ``device``, ``outputs``); it prints ``RESULT <json>``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

__all__ = ["buffers", "run", "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def buffers(seed: int, n: int, tw: int, H: int) -> np.ndarray:
    """Every shard's buffer [n, TW, H] (float32) from ``seed``."""
    return np.random.default_rng(seed).normal(size=(n, tw, H)).astype(
        np.float32)


def _tensors(a: np.ndarray, dtype, device) -> list:
    return [torch.from_numpy(b).to(dtype).to(device) for b in a]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, calls: int, device) -> float:
    """Median host ms of one call of ``fn``, the card synchronized before
    and after each."""
    fn()
    times = []
    for _ in range(calls):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _case(job: dict, caps: tuple, dtype, comm, device) -> dict:
    import torch.distributed as dist
    from ..parallel import ep_pack
    from ..parallel import rdma_exchange as rx
    n, k, H = len(comm.ranks), comm.shard, job.get("H", 400)
    seed, calls = job.get("seed", 0), job.get("calls", 200)
    bufs = _tensors(buffers(seed, n, sum(caps), H), dtype, device)
    cots = _tensors(buffers(seed + 1, n, sum(caps), H), dtype, device)
    mine = bufs[k]
    # the bytes bound's count: TW rows read and written twice a rank
    case = {"bytes": 2 * mine.numel() * mine.element_size(),
            "max_abs_err": 0.0}
    for inverse, way in ((False, "fwd"), (True, "inv")):
        got = rx.rank_exchange_rdma(mine, caps, inverse, comm)
        gloo = ep_pack._rank_ring_move(mine, caps, inverse, comm)
        want = rx._ring_move(bufs, caps, inverse)[k]
        case[f"{way}_equal"] = torch.equal(got, want)
        case[f"{way}_gloo_equal"] = torch.equal(got, gloo)
        case["max_abs_err"] = max(case["max_abs_err"], float(
            (got.float() - want.float()).abs().max()))
        if job.get("outputs"):
            case[way] = got.float().cpu().tolist()
    leaf = mine.clone().requires_grad_()
    rx.rank_exchange_rdma(leaf, caps, False, comm).backward(cots[k])
    case["bwd_equal"] = torch.equal(leaf.grad,
                                    rx._ring_move(cots, caps, True)[k])
    if job.get("outputs"):
        case["bwd"] = leaf.grad.float().cpu().tolist()
    x, xs = mine, list(bufs)
    with torch.no_grad():
        for j in range(calls):
            x = rx.rank_exchange_rdma(x, caps, j % 3 == 2, comm)
            xs = rx._ring_move(xs, caps, j % 3 == 2)
    case["chain_equal"] = torch.equal(x, xs[k])
    case["chain_calls"] = calls
    if job.get("time"):
        with torch.no_grad():
            case["rank_k12_ms"] = _median_ms(
                lambda: rx.rank_exchange_rdma(mine, caps, False, comm),
                calls, device)
            case["gloo_ms"] = _median_ms(
                lambda: ep_pack._rank_ring_move(mine, caps, False, comm),
                calls, device)
            dist.barrier(group=comm.group)
            if k == 0:
                case["one_process_k12_ms"] = _median_ms(
                    lambda: rx.ring_exchange_rdma(bufs, caps), calls, device)
            dist.barrier(group=comm.group)
    return case


def _missing(job: dict, comm, device) -> dict:
    """A new plan (a row width no other case has), then one exchange that
    shard ``job["missing"]`` does not call."""
    from ..parallel import rdma_exchange as rx
    caps = tuple(job["caps"][0])
    n, k, limit = len(comm.ranks), comm.shard, job.get("timeout_s", 2.0)
    buf = _tensors(buffers(job.get("seed", 0) + 2, n, sum(caps),
                           job.get("H", 400) + 8), torch.float32, device)[k]
    rx.rank_exchange_rdma(buf, caps, False, comm, timeout_s=limit)
    _sync(device)
    rx.check_errors()
    out = {"called": k != job["missing"], "raised": False}
    if out["called"]:
        t0 = time.perf_counter()
        try:
            got = rx.rank_exchange_rdma(buf, caps, False, comm,
                                        timeout_s=limit)
            got.sum().item()              # the next synchronizing read
            rx.check_errors()
        except RuntimeError as e:
            out.update(raised=True, message=str(e))
        out["seconds"] = time.perf_counter() - t0
    return out


def run(job: dict) -> dict:
    """This rank's checks (see the module doc) on the initialized process
    group, its plans closed at the end."""
    from ..parallel import multihost
    from ..parallel import rdma_exchange as rx
    device = torch.device(job.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    comm = multihost.ep_comm(multihost.layout(1, multihost.world_size()))
    before = (rx.rank_launches, rx.rank_bwd_launches)
    res = {"rank": multihost.rank(), "shard": comm.shard,
           "device": str(device), "cases": {}}
    for caps in job["caps"]:
        for name in job["dtypes"]:
            res["cases"][f"{tuple(caps)} {name}"] = _case(
                job, tuple(caps), DTYPES[name], comm, device)
    if job.get("missing") is not None:
        res["missing"] = _missing(job, comm, device)
    res["launches"] = [rx.rank_launches - before[0],
                       rx.rank_bwd_launches - before[1]]
    rx.close()
    return res


def main(argv=None) -> int:
    job = json.loads((sys.argv[1:] if argv is None else argv)[0])
    from ..parallel import multihost
    multihost.initialize(job["init"], job["world"], job["rank"],
                         timeout_s=job.get("group_timeout_s", 120))
    print("RESULT " + json.dumps(run(job)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
