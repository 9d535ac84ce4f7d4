"""The tensor-parallel process group (counterpart of the ``tp`` half of
``skypilot_tpu/parallel/mesh.py`` and of ``tp_mesh`` in
``skypilot_tpu/infer/engine.py``).

JAX serves ``tp > 1`` as one process over ``tp`` local devices; PyTorch's
idiom is one process per GPU, so the port's ``tp`` is ``tp`` ranks of one
``torch.distributed`` group. :func:`tp_group` joins it and returns a
:class:`TPGroup`: the rank, the world, the model's process group, a second
``gloo`` group for host bytes, and the rank's device. At world size 1
nothing is initialized and every collective is skipped.

The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless the caller
names one (``backend='gloo'`` puts two ranks on one card, a correctness
run); nothing picks a backend quietly. The reference's layout rules hold:
``tp`` no larger than the devices, and ranks striped evenly over hosts
(:func:`check_layout`). The training axes (``dp``, ``fsdp``) are not
ported here.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import Any, Optional

import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One rank's view of the tensor-parallel group. ``pg`` carries the
    model's collectives, ``host_pg`` (always ``gloo``) the lockstep
    driver's host bytes, so that an NCCL group never carries Python
    data. Both are None at world size 1."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device('cpu')
    backend: Optional[str] = None
    pg: Any = None
    host_pg: Any = None

    @property
    def staged(self) -> bool:
        """Whether the model's collectives stage CUDA tensors through the
        host (``gloo`` over tensors on a card)."""
        return self.backend == 'gloo' and self.device.type == 'cuda'

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this group's collectives:
        NCCL's run on the stream, gloo's on the host."""
        return self.world == 1 or self.backend == 'nccl'


def single(device='cpu') -> TPGroup:
    """The world-size-1 group: no process group, every collective the
    identity."""
    return TPGroup(device=torch.device(device))


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def check_layout(tp: int, n_hosts: int, devices_per_host: int) -> int:
    """The reference's ``tp_mesh`` rules over ``n_hosts`` hosts of
    ``devices_per_host`` devices each: ``tp`` no larger than the devices,
    and (multi-host) a multiple of the host count so every host owns an
    equal part. Returns the ranks each host runs."""
    total = n_hosts * devices_per_host
    if tp > total:
        raise ValueError(f'tp={tp} but only {total} devices')
    if tp % n_hosts:
        raise ValueError(
            f'multi-host replica: tp={tp} must be a multiple of the '
            f'process count ({n_hosts}) so every host owns an equal part '
            f'of the mesh')
    return tp // n_hosts


def rank_device(device_type: str, local_index: int) -> torch.device:
    """Local rank ``local_index``'s device: ``cuda:<local index>``, or
    the CPU."""
    if device_type == 'cuda':
        return torch.device('cuda', local_index)
    return torch.device(device_type)


def tp_group(rank: int, world: int, address: Optional[str] = None,
             device='cpu', backend: Optional[str] = None) -> TPGroup:
    """Join the ``world``-rank group at ``address`` (``host:port`` of rank
    0's TCP store) as ``rank`` on ``device``, with ``backend`` (default:
    :func:`default_backend`), and make the host-bytes ``gloo`` group
    beside it. World size 1 initializes nothing."""
    device = torch.device(device)
    if world == 1:
        return single(device)
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got '
                         f'{backend!r}')
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'nccl needs a CUDA device, got {device}')
    if address is None:
        raise ValueError('a tp group of more than one rank needs the '
                         'rendezvous address (host:port)')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f'tcp://{address}',
                            world_size=world, rank=rank)
    pg = dist.group.WORLD
    host_pg = dist.new_group(backend='gloo')
    return TPGroup(rank=rank, world=world, device=device, backend=backend,
                   pg=pg, host_pg=host_pg)


def destroy(group: TPGroup) -> None:
    """Leave the group (a no-op at world size 1)."""
    if group.world > 1 and dist.is_initialized():
        dist.destroy_process_group()
