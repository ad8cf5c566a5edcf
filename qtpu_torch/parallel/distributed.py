"""Multi-process bring-up on ``torch.distributed`` (port of
qtpu/parallel/distributed.py).

The port's rank model differs from qtpu's: qtpu runs one SPMD program per
process over a mesh that may span several local devices; the port runs
**one process per rank and one device per rank** — ``cuda:local_rank``, or
the CPU when the caller asks for it, as the tests do.

``initialize_from_env`` reads qtpu's variables — ``QTPU_COORDINATOR``
(``host:port``, or an ``init_method`` URL such as ``file:///tmp/rdzv`` or
``tcp://host:port``), ``QTPU_NUM_PROCESSES`` and ``QTPU_PROCESS_ID`` — and
calls ``torch.distributed.init_process_group``; without them it is a
no-op, and it is idempotent.  The backend is an argument,
``QTPU_DIST_BACKEND`` overrides it, and without either it is ``nccl`` when
every rank of the host has a card of its own and ``gloo`` otherwise (ranks
sharing a card, or on the CPU): NCCL refuses two ranks on one card
("Duplicate GPU detected").  The choice is reported (``backend()``), not
made silently: ``serve.cli.build_engine`` puts it in its ``info``.

``local_batch_to_global`` and ``process_local_devices`` are the rank-model
counterparts of qtpu's: the batch a model group runs is the concatenation
of its ranks' local rows, and a rank owns one device.  qtpu's
``enable_overlap_flags`` (libtpu's latency-hiding scheduler flags) has no
counterpart (ROADMAP.md A13).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# a collective's deadline: well past any round's (the serving engine's own
# watchdog, round_timeout_s, reports a stuck round long before)
TIMEOUT = datetime.timedelta(seconds=600)


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def local_rank() -> int:
    """This process's rank on its host: ``QTPU_LOCAL_RANK``, else its
    process id (one host)."""
    env = os.environ.get("QTPU_LOCAL_RANK")
    if env is not None:
        return int(env)
    return dist.get_rank() if dist.is_initialized() else int(
        os.environ.get("QTPU_PROCESS_ID", "0"))


def default_backend(num_processes: int) -> str:
    """``nccl`` when each of the host's ranks has a card of its own,
    ``gloo`` otherwise."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if n and n >= num_processes else "gloo"


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        backend: Optional[str] = None) -> bool:
    """Multi-process bring-up; returns True if more than one process runs.

    Resolution order: explicit arguments > ``QTPU_COORDINATOR`` /
    ``QTPU_NUM_PROCESSES`` / ``QTPU_PROCESS_ID`` > single-process no-op;
    ``QTPU_DIST_BACKEND`` > ``backend`` > :func:`default_backend`.  Safe to
    call more than once."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("QTPU_COORDINATOR")
    if coordinator is None:
        return False
    num_processes = int(num_processes
                        or os.environ.get("QTPU_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("QTPU_PROCESS_ID", "0"))
    backend = (os.environ.get("QTPU_DIST_BACKEND") or backend
               or default_backend(num_processes))
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < num_processes:
            raise ValueError(
                f"nccl needs a card per rank ({num_processes} ranks, "
                f"{cards} cards; NCCL refuses two ranks on one card): use "
                "backend='gloo' (QTPU_DIST_BACKEND=gloo)")
        torch.cuda.set_device(int(os.environ.get(
            "QTPU_LOCAL_RANK", process_id)) % cards)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator),
        world_size=num_processes, rank=process_id,
        timeout=TIMEOUT)
    return num_processes > 1


def shutdown() -> None:
    """Leave the world cleanly: a barrier, so that no rank tears its group
    down while a peer still talks to it, then ``destroy_process_group``
    while the interpreter is whole.  A rank that exits with its gloo group
    alive tears the group down during the interpreter's exit, and there it
    can abort ("terminate called without an active exception", SIGABRT)
    once its peer has closed the connection.  No-op without a world."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def backend() -> Optional[str]:
    """The process group's backend, or None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """This rank's device: with several processes ``cuda`` (the default)
    means ``cuda:local_rank`` (modulo the host's cards, so ranks may share
    one under gloo); in one process it stays ``cuda``, the current card;
    ``"cpu"`` is the CPU.  Raises without a card unless the CPU is asked
    for."""
    from qtpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def process_local_devices(device=None):
    """The devices this process owns: one, its rank's (the rank model)."""
    return [rank_device(device)]


def local_batch_to_global(local: torch.Tensor, mesh) -> torch.Tensor:
    """The batch this rank's model group runs: the group's local rows in
    rank order (an all-gather over ``model``).  Every rank of the group
    calls it with equal shapes; with ``tp`` = 1 it is ``local``."""
    from qtpu_torch.parallel import collectives
    from qtpu_torch.parallel.mesh import MODEL_AXIS

    group = mesh.group(MODEL_AXIS)
    if group is None:
        return local
    return collectives.all_gather(local, group, dim=0)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def broadcast_tree(tree, device) -> dict:
    """Rank 0's nested dict of tensors on every rank, on ``device`` (over a
    CPU gloo group, whatever the world's backend)."""
    from qtpu_torch.serve.fused_ops import tree_to_device

    obj = [_to_cpu(tree) if rank() == 0 else None]
    dist.broadcast_object_list(obj, src=0,
                               group=dist.new_group(backend="gloo"))
    return tree_to_device(obj[0], device)
