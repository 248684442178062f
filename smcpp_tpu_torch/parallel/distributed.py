"""Multi-process execution on torch.distributed.

Port of smcpp_tpu/parallel/distributed.py.  JAX forms one mesh over every
device of every process; the PyTorch idiom is one process per device, so the
port's mesh is a process group in which rank r owns one device: the GPU
``cuda:LOCAL_RANK``, or the CPU when the job asks for it (``--device cpu``).

* The backend follows the device: NCCL for CUDA, gloo for the CPU.  NCCL
  refuses two ranks on one card ("Duplicate GPU detected"), so a job that
  must put two ranks on one card names gloo in ``SMCPP_TPU_DIST_BACKEND``;
  nothing picks gloo for a CUDA job otherwise, and a failed NCCL start
  raises.
* The setup collectives of host-local ingestion (parallel/hostlocal.py) run
  over a second, gloo-backed group on CPU tensors (the world group itself
  when it is gloo), so host data never round-trips through the card.
* Launching: ``--coordinator HOST:PORT --num-processes N --process-id I`` on
  each process (``init_method tcp://HOST:PORT``), or torchrun, whose
  environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) is the
  counterpart of JAX's JAX_COORDINATOR_ADDRESS trigger.  With the flags the
  local device is LOCAL_RANK when the environment gives it, else the process
  id modulo the host's card count.
* A process with none of these forms no group: ``num_processes == 1`` is a
  no-op and every path runs as a single process.

The group's ``timeout`` (TIMEOUT, 600 s) makes a dead peer fail the job's
collectives instead of hanging them.
"""

import atexit
import datetime
import logging
import os

import torch
import torch.distributed as dist

from .mesh import Mesh

logger = logging.getLogger(__name__)

BACKEND_ENV = "SMCPP_TPU_DIST_BACKEND"
TIMEOUT = datetime.timedelta(seconds=600)

# The live group of this process (None: a single process).  A process joins
# at most one job, as a JAX process initializes jax.distributed once.
_mesh = None


def current():
    "The Mesh of the live process group, or None in a single process."
    return _mesh


def _backend(device):
    """The world group's backend: NCCL for a CUDA device, gloo for the CPU,
    unless SMCPP_TPU_DIST_BACKEND names one."""
    name = os.environ.get(BACKEND_ENV)
    if name is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if name not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV} must be 'nccl' or 'gloo' (got {name!r})")
    if name == "nccl" and device.type != "cuda":
        raise ValueError(f"{BACKEND_ENV}=nccl needs a CUDA device (got {device})")
    return name


def _rank_device(device, local_rank):
    "This rank's device: a bare 'cuda' becomes cuda:local_rank."
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device="cuda", init_method=None):
    """Join the job's process group and return this rank's Mesh (None for a
    single process).

    With ``coordinator_address`` (HOST:PORT) the group forms over TCP from
    ``num_processes`` and ``process_id``, which must both be given; without
    it, from torchrun's environment.  ``init_method`` (a torch.distributed
    URL such as ``file:///path``, for a job on one host) takes the place of
    the coordinator.  A misconfiguration raises: a job that asked for
    several processes never runs as one."""
    global _mesh
    if num_processes == 1:
        return None
    if _mesh is not None:
        logger.debug("process group already initialized")
        return _mesh
    env = os.environ
    if coordinator_address is not None or init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator needs --num-processes and --process-id"
            )
        world, rank = int(num_processes), int(process_id)
        init = init_method or f"tcp://{coordinator_address}"
        local_rank = int(env.get("LOCAL_RANK", rank))
    else:
        missing = [k for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise RuntimeError(
                "no --coordinator and an incomplete torchrun environment "
                f"(missing {', '.join(missing)})"
            )
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        if world == 1:
            return None
        init = "env://"
        local_rank = int(env.get("LOCAL_RANK", rank))
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    dev = _rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = _backend(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    try:
        host = (dist.group.WORLD if backend == "gloo"
                else dist.new_group(backend="gloo", timeout=TIMEOUT))
        mesh = Mesh(dist.group.WORLD, host, rank, world, dev)
        mesh.handshake()
    except BaseException:
        dist.destroy_process_group()
        raise
    _mesh = mesh
    atexit.register(shutdown)
    logger.info(
        "process group initialized: rank %d / %d on %s (%s backend, host "
        "collectives over gloo)", rank, world, dev, backend,
    )
    return _mesh


def maybe_initialize_from_args(args):
    """CLI entry (``Command.main``): join a process group when the command
    line (``--coordinator``, ``--num-processes``, ``--process-id``) or
    torchrun's environment (WORLD_SIZE) asks for several processes.  Every
    process then runs the same driver; the managers shard the E-step over
    the group and reduce its statistics."""
    flags = [getattr(args, k, None)
             for k in ("coordinator", "num_processes", "process_id")]
    device = getattr(args, "device", "cuda")
    if any(f is not None for f in flags):
        if flags[0] is None and flags[1] != 1:
            raise ValueError(
                "--num-processes / --process-id need --coordinator HOST:PORT"
            )
        return initialize(*flags, device=device)
    if "WORLD_SIZE" in os.environ:
        return initialize(device=device)
    return None


def shutdown(barrier=False):
    """Leave the process group.  ``barrier``: first wait for every rank (a
    monitored barrier on the gloo host group, which names a rank that never
    arrives), so that no rank tears its connections down while a peer still
    uses them; the CLI does this when a command ends normally.  At exit
    (registered by ``initialize``) the group is destroyed without waiting:
    after a failure the peers may never arrive."""
    global _mesh
    mesh, _mesh = _mesh, None
    if mesh is None or not dist.is_initialized():
        return
    if barrier:
        dist.monitored_barrier(group=mesh.host_group, timeout=TIMEOUT)
    dist.destroy_process_group()
