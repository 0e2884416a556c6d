"""The ``(data, model)`` mesh of training processes, one process a rank.

Port of the JAX package's ``parallel/mesh.py``.  There one SPMD program
runs over a device mesh; here every rank is a process with one device
(``torch.distributed``), and the mesh says which rows of the global batch
are its own and which seed index its decoder masks fold in.  Ranks lie
data-major, as JAX's ``devices.reshape(data, model)``: rank ``d * model +
m`` is data shard d, model index m.

``Mesh`` carries the process group.  On a mesh of one (a single process,
with or without a group) every collective of ``parallel.collectives`` is
the identity and launches nothing.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from multilingual_text_to_speech_tpu_torch.device import resolve_device

# a hang in a collective raises after this long instead of blocking
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True, eq=False)
class Mesh:
    """``data`` x ``model`` ranks; this process is ``rank``, on
    ``device``; ``group`` is the process group (None in a process
    without one) and ``backend`` its transport (``"nccl"`` or ``"gloo"``).
    ``replicas`` is the number of ranks that share each row of a training
    batch (``model`` where the batch divides only ``data``, else 1): the
    batch-norm count of the global batch counts a shared row once."""

    data: int
    model: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None
    replicas: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    def shard_rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` rows, by the two
        schemes of JAX ``Decoder._mesh_shard_batch``: a batch that divides
        the mesh gives every rank its own ``batch / size`` rows; one that
        divides only ``data`` gives each data shard its rows, shared by its
        ``model`` ranks.  Any other batch raises, as JAX's ``device_put``
        of a batch sharded over ``data`` does."""
        if self.size == 1:
            return slice(0, batch)
        if batch % self.size == 0:
            per, index = batch // self.size, self.rank
        elif batch % self.data == 0:
            per, index = batch // self.data, self.data_index
        else:
            raise ValueError(f"a batch of {batch} rows divides neither the "
                             f"{self.data}x{self.model} mesh nor its data "
                             "axis")
        return slice(index * per, (index + 1) * per)

    def seed_index(self, batch: int) -> Optional[int]:
        """The index this rank folds into its decoder seeds for a global
        batch of ``batch`` rows (JAX ``fold_in(key, idx)``): ``d * model +
        m`` where every rank has rows of its own, ``d`` where the model
        ranks share a data shard; None on a mesh of one, whose seeds are
        the step's own."""
        if self.size == 1:
            return None
        self.shard_rows(batch)
        return self.rank if batch % self.size == 0 else self.data_index


def make_mesh(hp=None, *, world: Optional[int] = None,
              rank: Optional[int] = None, device=None) -> Mesh:
    """The mesh of ``world`` ranks (the default process group's size and
    rank once ``torch.distributed`` is initialized, else 1 and 0), shaped
    as JAX ``make_mesh``: ``hp.mesh_model_parallel`` ranks a data shard
    and ``hp.mesh_data_parallel`` shards, -1 meaning ``world / model``;
    ``data * model`` must equal ``world``; ``hp.batch_size`` sets
    ``replicas``.  ``hp.parallelization = False``
    pins training to one device, as in JAX: a single process then, and a
    raise where more were started.  ``device`` is this rank's: the card
    unless given (``device.resolve_device``: ``None`` raises without one),
    the CPU only for ``device="cpu"``."""
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world = dist.get_world_size(group) if world is None else world
        rank = dist.get_rank(group) if rank is None else rank
    world = 1 if world is None else world
    rank = 0 if rank is None else rank
    if hp is not None and not getattr(hp, "parallelization", True) \
            and world > 1:
        raise ValueError(
            f"hp.parallelization is False: training runs on one device, "
            f"but {world} processes were started")
    model = getattr(hp, "mesh_model_parallel", 1) if hp is not None else 1
    data = getattr(hp, "mesh_data_parallel", -1) if hp is not None else -1
    if data == -1:
        data = world // model
    assert data * model == world, (
        f"mesh {data}x{model} does not match {world} processes")
    device = resolve_device(device)
    backend = dist.get_backend(group) if group is not None else None
    batch = getattr(hp, "batch_size", 0) if hp is not None else 0
    replicas = model if batch % world and batch % data == 0 else 1
    return Mesh(data, model, rank, device, group, backend, replicas)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (``Mesh.shard_rows``) of every array of a collated
    global ``Batch`` (None stays None)."""
    rows = mesh.shard_rows(len(batch.utterances))
    return type(batch)(*(None if x is None else x[rows] for x in batch))


def shard_seeds(seeds, index: int):
    """Seeds of shard ``index``: a pure function of the step's two uint32
    ``seeds`` and the index (splitmix64 of both), for ranks whose dropout
    and zoneout masks must differ."""
    mask = (1 << 64) - 1

    def mix(z):
        z = (z + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return z ^ (z >> 31)

    z = mix(mix((int(seeds[0]) << 32) | int(seeds[1])) ^ index)
    return z >> 32, z & 0xFFFFFFFF


def init_distributed(cpu: bool = False,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK %
    device_count`` unless ``cpu``.  The transport is NCCL where every local
    rank has a card of its own, else gloo (ranks on the CPU, or sharing a
    card: NCCL refuses two ranks on one device); the kernels run on the
    card either way.  A failed join raises."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(
            f"data parallel needs the environment of torch.distributed.run "
            f"(missing {', '.join(missing)}): start one process a rank "
            f"with python -m torch.distributed.run --nproc_per_node N")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", "0"))
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --cpu to train data "
                "parallel on the CPU")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        # every rank on this host a card of its own
        own = int(env.get("LOCAL_WORLD_SIZE", world)) <= cards
        backend = "nccl" if own else "gloo"
    address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    dist.init_process_group(
        backend, init_method=address,
        world_size=world, rank=rank, timeout=timeout,
        device_id=device if backend == "nccl" else None)
    print(f"rank {rank}/{world} on {device}, backend {backend}", flush=True)
    return device
