"""The data-parallel mesh of the port: ranks of ``torch.distributed`` in
place of the reference's devices (the pure data-parallel counterpart of
``repro/launch/mesh.py`` ``make_host_mesh``).

The reference runs its data-parallel step as one process over a device
mesh of axes ``("pod", "data")`` (``make_train_step_dp``).  Here each
device is a process, a *rank*, and an axis is a process group:

* the world group: every rank;
* with ``pods`` > 1, the fast group (the ranks of one pod, the reference's
  "data" axis) and the pod group (the ranks at one position in every pod,
  its "pod" axis), laid out as the reference linearises its devices:
  ``rank = pod * n_fast + fast``.  Every rank creates every subgroup, in
  the same order (``torch.distributed`` requires it).

The backend follows the device the caller names: NCCL for ``cuda``, gloo
for ``cpu``.  Gloo on a card is taken only when asked for by name
(``backend="gloo"``): gloo then cannot exchange the card's tensors in
every collective, so ``core/collectives.py`` stages each buffer through
host memory, and the mesh logs that it does.  ``cuda`` means the card of
the rank's ``LOCAL_RANK``; a rank with no card of its own raises, unless
the caller asks for ranks to share cards (``share_device=True``, which
NCCL refuses).  Every process group gets a timeout, so a rank whose peer
hung or died fails within it instead of waiting for ever.

``init_mesh`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or takes an explicit
``(rank, world, init_method)``, as the tests do with a ``file://`` store;
``single_mesh`` is world 1 with no process group at all (the CLI's
``--dp`` without torchrun).  ``spawn`` starts ranks of a function on one
host with such a store, for the tests and ``launch/dp_check.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import tempfile
import time
from multiprocessing.connection import wait
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("repro_torch.mesh")

# seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 120.0
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class DPMesh:
    """The ranks of one data-parallel run.  ``group`` is None only for
    ``single_mesh`` (world 1, nothing to exchange); ``fast_group`` and
    ``pod_group`` are None unless ``pods`` > 1."""
    rank: int
    world: int
    pods: int
    device: torch.device
    group: Optional[Any] = None
    fast_group: Optional[Any] = None
    pod_group: Optional[Any] = None

    @property
    def n_fast(self) -> int:
        return self.world // self.pods

    @property
    def pod(self) -> int:
        return self.rank // self.n_fast

    @property
    def exchange_order(self) -> list:
        """The ranks in the order of the reference's compressed exchange,
        which runs over its axes ("data", "pod"): position p is the rank
        of fast index p // pods in pod p % pods."""
        return [(p % self.pods) * self.n_fast + p // self.pods
                for p in range(self.world)]

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def staged(self) -> bool:
        """Whether each exchange goes through host memory (gloo, card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if self.group is None:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group()
            self.group = self.fast_group = self.pod_group = None

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.world} (pod {self.pod} of "
                f"{self.pods}), {self.backend or 'no process group'} on "
                f"{self.device}" + (", staged through host memory"
                                    if self.staged else ""))


def single_mesh(device="cuda") -> DPMesh:
    """World 1 without a process group: the exchange is the identity."""
    return DPMesh(0, 1, 1, _device(device, 0, share=False))


def _device(device, local_rank: int, *, share: bool) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        raise ValueError(f"device {device!r}: name the type ('cuda'); each "
                         "rank takes the card of its LOCAL_RANK")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda': no CUDA device")
    if local_rank >= n and not share:
        raise ValueError(
            f"LOCAL_RANK {local_rank} has no card of its own ({n} visible); "
            "ranks share cards only when asked (share_device=True)")
    return torch.device("cuda", local_rank % n)


def init_mesh(device="cuda", *, pods: int = 1, backend: Optional[str] = None,
              share_device: bool = False, rank: Optional[int] = None,
              world: Optional[int] = None, init_method: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DPMesh:
    """Join the process group and build the mesh.  Without ``rank`` the
    ranks come from torchrun's environment (``init_method`` "env://");
    with it, ``world`` and ``init_method`` must be given (one host:
    ``LOCAL_RANK`` is the rank)."""
    if rank is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                               "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise ValueError(f"init_mesh: {missing} not set (run under "
                             "torchrun, or pass rank, world, init_method)")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank, init_method = int(os.environ["LOCAL_RANK"]), "env://"
    else:
        if world is None or init_method is None:
            raise ValueError("init_mesh: an explicit rank needs world and "
                             "init_method")
        local_rank = rank
    if pods < 1 or world % pods:
        raise ValueError(f"world {world} is not a multiple of pods {pods}")
    dev = _device(device, local_rank, share=share_device)
    backend = backend or _BACKEND[dev.type]
    if backend == "nccl" and (dev.type != "cuda" or share_device):
        raise ValueError(f"NCCL needs one card a rank (device {device!r}, "
                         f"share_device={share_device}); name gloo instead")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = DPMesh(rank, world, pods, dev, group=dist.group.WORLD)
    if pods > 1:
        nf = world // pods
        mesh.fast_group, _ = dist.new_subgroups_by_enumeration(
            [[p * nf + f for f in range(nf)] for p in range(pods)])
        mesh.pod_group, _ = dist.new_subgroups_by_enumeration(
            [[p * nf + f for p in range(pods)] for f in range(nf)])
    logger.info("data-parallel mesh: %s", mesh.describe())
    return mesh


def _rank_main(fn, rank, world, init_file, mesh_kw, args, threads):
    if torch.device(mesh_kw.get("device", "cuda")).type == "cpu":
        # ranks on the host's cores share the caller's threads
        torch.set_num_threads(threads)
    mesh = init_mesh(rank=rank, world=world,
                     init_method=f"file://{init_file}", **mesh_kw)
    try:
        fn(mesh, *args)
    finally:
        mesh.close()


def spawn(fn: Callable, world: int, *, args: Sequence = (),
          wait_s: float = 300.0, **mesh_kw) -> None:
    """Run ``fn(mesh, *args)`` in ``world`` new processes (the ``spawn``
    start method), each a rank of one process group over a ``file://``
    store in a new temporary directory; ``mesh_kw`` go to ``init_mesh``
    (``device``, ``pods``, ``backend``, ``share_device``, ``timeout_s``).
    ``fn`` must be importable by name.  CPU ranks share the caller's
    PyTorch threads (``torch.get_num_threads() // world``, at least one
    each).  Waits at most ``wait_s`` in all
    and kills every rank still running then, or as soon as one rank has
    failed (its peers would wait out their collectives' timeout); raises
    unless every rank exited 0."""
    ctx = torch.multiprocessing.get_context("spawn")
    threads = max(1, torch.get_num_threads() // world)
    t_end = time.monotonic() + wait_s
    with tempfile.TemporaryDirectory(prefix="repro_dp_") as tmp:
        init_file = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init_file, mesh_kw,
                                   tuple(args), threads))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            running = list(procs)
            while running and time.monotonic() < t_end and not any(
                    p.exitcode for p in procs):
                wait([p.sentinel for p in running],
                     timeout=t_end - time.monotonic())
                running = [p for p in running if p.is_alive()]
        finally:
            killed = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
        codes = [p.exitcode for p in procs]
    if any(c for r, c in enumerate(codes) if r not in killed):
        raise RuntimeError(f"rank exit codes {codes} (ranks {killed} killed "
                           "after another failed)")
    if killed:
        raise TimeoutError(f"ranks {killed} of {world} still ran after "
                           f"{wait_s} s and were killed")
