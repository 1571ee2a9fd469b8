"""Multi-process training over ``torch.distributed`` (gloo): the counterpart
of ``cgr_mpnn_3d_tpu/parallel/multihost.py``.

Every rank runs the same program (``cli/train.py`` calls :func:`initialize`
before it touches a device), packs and moves only the data of its own
cells of the ``[n_dp, n_ep]`` grid, and sums the step's loss and gradients
with the other ranks::

    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    multihost.initialize()                 # no-op in a single process
    lay = multihost.layout(n_dp, n_ep)     # this rank's cells
    ...
    multihost.all_reduce_sum_([sse, *grads])   # one collective a step

**Launch.**  :func:`initialize` reads torchrun's variables (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) or the JAX
CLI's (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), so a launcher written for the JAX CLI starts the port
unchanged; where both are set they must agree.  The group is gloo's, with a
finite timeout: a rank whose peer died raises instead of waiting.  Each
rank's device is ``cuda:{LOCAL_RANK % device_count()}`` (the JAX names:
``JAX_PROCESS_ID``), so two ranks on a one-card machine share ``cuda:0``.

**Layouts.**  Ranks lie row-major over the ``[n_dp, n_ep]`` grid, as the
JAX mesh lays out its processes (each process's devices contiguous), and
:func:`layout` takes two of them:

* ``groups`` (a): ``W`` divides ``n_dp``; rank r holds the dp groups
  ``[r·n_dp/W, (r+1)·n_dp/W)``, each with all its ``n_ep`` shards, and runs
  those shards in this process (``ep_pack.run_lockstep``);
* ``shards`` (b): ``W = n_dp·n_ep``; rank r holds shard ``r % n_ep`` of
  group ``r // n_ep``, and its EP collectives cross processes
  (``ep_pack.run_distributed`` over :func:`ep_comm`'s group).

JAX takes any mesh that covers every process; any other layout raises here,
and :func:`check_launch` does so from the environment before any
rendezvous, so a lone misconfigured process fails at once.  ``parallel/
mesh.py::make_mesh`` has no counterpart: its checks are :func:`layout`'s.

**What crosses ranks, and how.**  Under layout (b) with ``--ep_rdma``
every hop exchange of the EP forward and backward goes from card memory
to card memory through the cross-rank K12 (``rdma_exchange.
rank_exchange_rdma``: peer copies through CUDA IPC with signals in device
memory, ranks sharing one card or on peer cards); without it the
exchanges are gloo's point-to-point moves (``ep_pack._rank_ring_move``).
The group sums of the EP forward, the flat layout's all-to-alls, the
step's all-reduce of [SSE, gradients], the config fingerprint and the
barriers stay on gloo, which stages CUDA tensors through host memory;
NCCL across cards is ROADMAP.md section 1.5 step 3.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["LAUNCH_ENV", "Launch", "Layout", "EPComm", "launch_env",
           "env_world_size", "initialize", "group_timeout_s", "is_primary",
           "rank", "world_size", "local_rank", "host_shard",
           "sync_global_devices", "layout", "local_cells", "check_launch",
           "ep_comm", "all_reduce_sum_", "all_reduce_host_",
           "all_gather_rows", "cuda_index"]

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")
JAX_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
LAUNCH_ENV = TORCHRUN_ENV + JAX_ENV
DEFAULT_TIMEOUT_S = 600.0

_local_rank = 0
_timeout_s = DEFAULT_TIMEOUT_S
_ep_comms: dict = {}


class Launch(NamedTuple):
    """A multi-process launch: where the ranks meet, how many, which one."""
    init_method: str
    world_size: int
    rank: int
    local_rank: int


def _int(env, key: str) -> int:
    try:
        return int(env[key])
    except ValueError:
        raise ValueError(f"{key}={env[key]!r} is not an integer") from None


def env_world_size(environ=None) -> int:
    """The number of processes the environment asks for (1 without a
    launch); read before any rendezvous, so that :func:`check_launch` can
    refuse a layout at once.  ``JAX_COORDINATOR_ADDRESS`` without
    ``JAX_NUM_PROCESSES`` raises (the port has no TPU metadata to ask)."""
    env = os.environ if environ is None else environ
    sizes = {}
    if env.get("WORLD_SIZE"):
        sizes["WORLD_SIZE"] = _int(env, "WORLD_SIZE")
    if env.get("JAX_NUM_PROCESSES"):
        sizes["JAX_NUM_PROCESSES"] = _int(env, "JAX_NUM_PROCESSES")
    elif env.get("JAX_COORDINATOR_ADDRESS"):
        raise ValueError(
            "JAX_COORDINATOR_ADDRESS without a process count: set "
            "JAX_NUM_PROCESSES and JAX_PROCESS_ID too (or torchrun's "
            "WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)")
    if len(set(sizes.values())) > 1:
        raise ValueError(f"the launch variables disagree on the number of "
                         f"processes: {sizes}")
    return max(sizes.values(), default=1)


def launch_env(environ=None) -> Launch | None:
    """The launch the environment describes, or None for one process.
    torchrun's contract needs ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
    beside ``WORLD_SIZE`` > 1, the JAX CLI's all three of its variables;
    an incomplete one, or two that disagree, raises."""
    env = os.environ if environ is None else environ
    world = env_world_size(env)
    if world <= 1:
        return None
    found = []
    if env.get("WORLD_SIZE"):
        need = ("RANK", "MASTER_ADDR", "MASTER_PORT")
        missing = [k for k in need if not env.get(k)]
        if missing:
            raise ValueError(f"WORLD_SIZE={world} without {missing}: "
                             f"torchrun's launch sets WORLD_SIZE, "
                             f"{', '.join(need)}")
        r = _int(env, "RANK")
        found.append(Launch(
            f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", world, r,
            _int(env, "LOCAL_RANK") if env.get("LOCAL_RANK") else r))
    if env.get("JAX_NUM_PROCESSES"):
        missing = [k for k in JAX_ENV if not env.get(k)]
        if missing:
            raise ValueError(f"JAX_NUM_PROCESSES={world} without {missing}: "
                             f"the JAX CLI's launch sets {', '.join(JAX_ENV)}")
        r = _int(env, "JAX_PROCESS_ID")
        found.append(Launch(f"tcp://{env['JAX_COORDINATOR_ADDRESS']}", world,
                            r, r))
    if len(found) == 2 and found[0][:3] != found[1][:3]:
        raise ValueError(f"torchrun's variables ({found[0]}) and the JAX "
                         f"CLI's ({found[1]}) describe different launches")
    if not 0 <= found[0].rank < world:
        raise ValueError(f"rank {found[0].rank} outside a world of {world}")
    return found[0]


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the gloo process group of a multi-process launch; a no-op in a
    single process and when already joined.  The arguments default to the
    environment's launch (:func:`launch_env`); ``timeout_s`` bounds every
    collective, so a rank whose peer died raises."""
    global _local_rank, _timeout_s
    import torch.distributed as dist
    if dist.is_initialized():
        return
    local = rank
    if init_method is None:
        launch = launch_env()
        if launch is None:
            return
        init_method, world_size, rank, local = launch
    if world_size is None or rank is None:
        raise ValueError("initialize(init_method=...) needs world_size and "
                         "rank")
    if world_size <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _local_rank, _timeout_s = local, timeout_s
    if torch.cuda.is_available():
        # the kernels' wrappers launch on the current device
        torch.cuda.set_device(cuda_index())


def group_timeout_s() -> float:
    """The process group's timeout (``initialize``'s ``timeout_s``), which
    also bounds the cross-rank K12's waits on a peer."""
    return _timeout_s


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This rank's index on its machine (``LOCAL_RANK``, or the rank)."""
    return _local_rank


def cuda_index() -> int:
    """This rank's card: its local rank modulo the cards of the machine."""
    return local_rank() % max(1, torch.cuda.device_count())


def host_shard(n_rows: int, process_id: int | None = None,
               num_processes: int | None = None) -> np.ndarray:
    """Disjoint, near-equal row split for this rank's input pipeline."""
    pid = rank() if process_id is None else process_id
    nproc = world_size() if num_processes is None else num_processes
    return np.arange(pid, n_rows, nproc)


def sync_global_devices(tag: str = "barrier") -> None:
    """A barrier over every rank (e.g. after the primary wrote a
    checkpoint); ``tag`` names it, as in JAX."""
    import torch.distributed as dist
    del tag
    if world_size() > 1:
        dist.barrier()


@dataclass(frozen=True)
class Layout:
    """Which cells of the ``[n_dp, n_ep]`` grid rank ``rank`` of ``world``
    holds (see the module doc): ``kind`` is "one" (a single process),
    "groups" (a) or "shards" (b)."""
    n_dp: int
    n_ep: int
    world: int
    rank: int
    kind: str

    @property
    def groups(self) -> range:
        """This rank's dp groups."""
        if self.kind == "shards":
            g = self.rank // self.n_ep
            return range(g, g + 1)
        per = self.n_dp // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def shards(self) -> range:
        """This rank's EP shards of each of its groups."""
        if self.kind == "shards":
            k = self.rank % self.n_ep
            return range(k, k + 1)
        return range(self.n_ep)

    @property
    def cells(self) -> list[tuple[int, int]]:
        return [(g, k) for g in self.groups for k in self.shards]


def layout(n_dp: int, n_ep: int, world: int | None = None,
           rank_: int | None = None, ep_rdma: bool = False) -> Layout:
    """This rank's :class:`Layout` of the ``[n_dp, n_ep]`` grid over
    ``world`` ranks (default: the process group's).  ``n_dp·n_ep = 1`` on
    several ranks, and any layout but (a) and (b), raise ValueError.
    ``ep_rdma`` is taken under both: under (b) its exchanges cross ranks
    through the cross-rank K12."""
    del ep_rdma                                 # taken under every layout
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    if world <= 1:
        return Layout(n_dp, n_ep, 1, 0, "one")
    if n_dp * n_ep <= 1:
        raise ValueError(
            f"{world}-process run needs a multi-device mesh: pass --dp/--ep "
            f"so that dp*ep covers all {world} processes")
    if n_dp % world == 0:
        return Layout(n_dp, n_ep, world, rank_, "groups")
    if n_dp * n_ep == world:
        return Layout(n_dp, n_ep, world, rank_, "shards")
    raise ValueError(
        f"dp={n_dp} x ep={n_ep} over {world} processes: the port takes two "
        f"layouts, (a) whole dp groups a rank ({world} must divide dp={n_dp}) "
        f"or (b) one EP shard a rank (dp*ep = {n_dp * n_ep} must equal "
        f"{world}); ROADMAP.md section 3")


def local_cells(n_dp: int, n_ep: int) -> list[tuple[int, int]]:
    """This rank's (dp, ep) cells (JAX ``local_mesh_cells``)."""
    return layout(n_dp, n_ep).cells


def check_launch(n_dp: int, n_ep: int, ep_rdma: bool = False) -> Layout:
    """The layout this environment's launch would take, worked out before
    any rendezvous: raises for a layout the port does not take and for an
    incomplete or conflicting launch environment."""
    world = env_world_size()
    layout(n_dp, n_ep, world, 0, ep_rdma)       # the layout's errors first
    launch = launch_env()
    return layout(n_dp, n_ep, world, launch.rank if launch else 0, ep_rdma)


class EPComm(NamedTuple):
    """The EP group of a layout (b) rank: its ranks in shard order, this
    rank's shard, and the process group (None: every rank)."""
    ranks: tuple[int, ...]
    shard: int
    group: object


def ep_comm(lay: Layout) -> EPComm:
    """This rank's :class:`EPComm` under layout (b).  Every rank makes
    every group's process group, in group order, the first time (a
    collective: all ranks call it together, as the trainer does when it is
    built)."""
    import torch.distributed as dist
    key = (lay.n_dp, lay.n_ep, lay.world)
    if key not in _ep_comms:
        groups = [tuple(g * lay.n_ep + k for k in range(lay.n_ep))
                  for g in range(lay.n_dp)]
        handles = ([None] if lay.n_dp == 1
                   else [dist.new_group(list(r)) for r in groups])
        _ep_comms[key] = (groups, handles)
    groups, handles = _ep_comms[key]
    g = lay.rank // lay.n_ep
    return EPComm(groups[g], lay.rank % lay.n_ep, handles[g])


def all_reduce_sum_(tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over every rank, in place, through ONE collective
    over one flat buffer (the step's SSE and every gradient together).
    The tensors share one dtype and device."""
    import torch.distributed as dist
    if world_size() <= 1 or not tensors:
        return
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce_sum_ takes one dtype, got {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_host_(flat)
    parts = flat.split([t.numel() for t in tensors])
    with torch.no_grad():
        torch._foreach_copy_(tensors, [p.view_as(t)
                                       for p, t in zip(parts, tensors)])


def all_reduce_host_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_reduce`` (sum) of ``t`` in place over ``group``, a card's
    tensor through host memory (gloo's collectives run on the host)."""
    import torch.distributed as dist
    if t.device.type == "cpu":
        dist.all_reduce(t, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, group=group)
    return t.copy_(host)


def all_gather_rows(row: np.ndarray) -> np.ndarray:
    """Every rank's float64 ``row``, [world, len(row)], in rank order."""
    import torch.distributed as dist
    t = torch.as_tensor(np.asarray(row, np.float64)).reshape(-1)
    if world_size() <= 1:
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()
