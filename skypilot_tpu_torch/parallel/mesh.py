"""Process groups: serving's tensor-parallel group, training's
``dp`` x ``fsdp`` x ``tp`` mesh and the meshes of named axes (counterpart of
``skypilot_tpu/parallel/mesh.py`` and of ``tp_mesh`` in
``skypilot_tpu/infer/engine.py``).

JAX runs a mesh as one process over its local devices; PyTorch's idiom
is one process per GPU, so the port's mesh is ``dp * fsdp * tp`` ranks of
one ``torch.distributed`` world.

- Serving: :func:`tp_group` joins a ``tp``-rank world and returns a
  :class:`TPGroup`: the rank, the world, the model's process group, a
  second ``gloo`` group for host bytes, and the rank's device. At world
  size 1 nothing is initialized and every collective is skipped. The
  reference's layout rules hold: ``tp`` no larger than the devices, and
  ranks striped evenly over hosts (:func:`check_layout`).
- Meshes of named axes: :func:`axes_mesh` joins the world of an
  :class:`AxesShape` (rank order ``np.arange(n).reshape(sizes)``, as the
  reference's ``Mesh(devices.reshape(sizes), axes)``) and returns an
  :class:`AxesMesh`: a :class:`TPGroup` along each axis and along each
  combination asked for. The groups are made with ``dist.new_group``,
  every rank creating every group in the same order (as ``new_group``
  requires); an axis of size 1 gets no group, and a combination in which
  one axis alone is larger than 1 is that axis' group. The reference's
  layouts for sequence, pipeline and expert parallelism are
  :data:`SP_AXES`, :data:`PP_AXES` and :data:`EP_AXES` (the MoE's data
  axes: ``fsdp`` x ``ep``).
- Training: :func:`make_mesh`, :func:`auto_mesh`,
  :func:`make_multislice_mesh` and :func:`mesh_from_hosts` choose a
  :class:`MeshShape` by the reference's rules, raising its ValueErrors;
  it is the :class:`AxesShape` over ``('dp', 'fsdp', 'tp')``, so rank
  ``r`` sits at ``(r // (fsdp * tp), (r // tp) % fsdp, r % tp)``.
  :func:`train_mesh` joins it through :func:`axes_mesh` and returns a
  :class:`TrainMesh`: the rank's coordinates, one :class:`TPGroup` per
  axis plus ``data``, the ``dp`` x ``fsdp`` ranks that share the rank's
  ``tp`` coordinate (the batch's axes), and a ``gloo`` group of the whole
  world for host values.

The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless the caller
names one (``backend='gloo'`` puts several ranks on one card, a
correctness run whose collectives stage through the host); nothing picks
a backend quietly. :func:`host_env` reads the environment the agent
injects on every host of a multi-host job; :func:`run_local_ranks` starts
one host's ranks, one process each, for the server, ``train.run`` and
``train.run_vision``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import socket
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

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


# ---------------------------------------------------------------------------
# The multi-host environment
# ---------------------------------------------------------------------------
# What the agent injects on every host of a multi-host job
# (skypilot_tpu/runtime/distributed_env.py).
COORDINATOR_ENV = 'JAX_COORDINATOR_ADDRESS'
NUM_PROCESSES_ENV = 'JAX_NUM_PROCESSES'
PROCESS_ID_ENV = 'JAX_PROCESS_ID'


def host_env() -> Tuple[int, int, Optional[str]]:
    """(hosts, this host's id, the coordinator ``host:port``) from the
    agent's environment; (1, 0, None) on a single host."""
    n = int(os.environ.get(NUM_PROCESSES_ENV, '1'))
    if n <= 1:
        return 1, 0, None
    return n, int(os.environ[PROCESS_ID_ENV]), os.environ[COORDINATOR_ENV]


def run_local_ranks(lead: Callable, follower: Callable,
                    args_for: Callable[[int], tuple], count: int,
                    name: str, first: int = 0) -> List[int]:
    """A host's ``count`` local ranks: ``follower(*args_for(i))`` in a
    spawned process for each ``i`` in 1..count-1, then
    ``lead(*args_for(0))`` in this process. If the lead raises, the
    followers are terminated and the error goes on; else each is joined
    and its exit code logged as ``<name>-<first + i> exited <code>``.
    Returns the followers' exit codes: the caller exits non-zero if any
    is."""
    import torch.multiprocessing as mp
    ctx = mp.get_context('spawn')
    followers = [ctx.Process(target=follower, args=args_for(i),
                             name=f'{name}-{first + i}')
                 for i in range(1, count)]
    for proc in followers:
        proc.start()
    try:
        lead(*args_for(0))
    except BaseException:
        for proc in followers:
            proc.terminate()
        raise
    codes = []
    for proc in followers:
        proc.join()
        codes.append(proc.exitcode)
        logger.info('%s exited %s', proc.name, proc.exitcode)
    return codes


# ---------------------------------------------------------------------------
# Meshes of named axes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AxesShape:
    """Named axes and their sizes. Rank ``r`` sits where ``r`` sits in
    ``np.arange(size).reshape(sizes)``: the last axis varies fastest, as
    the reference's ``Mesh(devices.reshape(sizes), axes)`` places its
    devices."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for k in self.sizes:
            n *= k
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on each axis."""
        out = {}
        for axis, n in zip(reversed(self.axes), reversed(self.sizes)):
            out[axis] = rank % n
            rank //= n
        return {axis: out[axis] for axis in self.axes}

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (:meth:`coords`' inverse)."""
        rank = 0
        for axis, n in zip(self.axes, self.sizes):
            rank = rank * n + coords[axis]
        return rank

    def groups(self, names: Tuple[str, ...]) -> List[List[int]]:
        """Every group of the ranks that differ only along the axes
        ``names``, each in rank order (so along several axes the first of
        the mesh's order varies slowest), the groups in the order of
        their first rank."""
        unknown = set(names) - set(self.axes)
        if unknown:
            raise ValueError(f'unknown mesh axes {sorted(unknown)}')
        by_rest: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axes if a not in names)
            by_rest.setdefault(key, []).append(r)
        return list(by_rest.values())


def group_name(names: Tuple[str, ...]) -> str:
    """The key of the group along ``names`` in :attr:`AxesMesh.groups`
    (``'fsdp+ep'``)."""
    return '+'.join(names)


@dataclasses.dataclass(frozen=True)
class AxesMesh:
    """One rank's view of a mesh of named axes: its shape, rank, device
    and backend, and a :class:`TPGroup` for each axis, and for each
    combination of axes that was asked for, of more than one rank
    (``groups[group_name(names)]``)."""
    shape: AxesShape
    rank: int = 0
    device: torch.device = torch.device('cpu')
    backend: Optional[str] = None
    groups: Dict[str, TPGroup] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return self.shape.size

    def coord(self, axis: str) -> int:
        return self.shape.coords(self.rank)[axis]

    def group(self, *names: str) -> TPGroup:
        """The group along ``names`` (the world-size-1 group where they
        span one rank)."""
        return self.groups.get(group_name(names)) or single(self.device)


def _join(world: int, rank: int, address: Optional[str],
          device: torch.device, backend: Optional[str]) -> str:
    """Join the ``world``-rank world at ``address`` as ``rank`` on
    ``device``; returns the backend (default: :func:`default_backend`)."""
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got '
                         f'{backend!r}')
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'nccl needs a CUDA device, got {device}')
    if address is None:
        raise ValueError('a mesh of more than one rank needs the '
                         'rendezvous address (host:port)')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f'tcp://{address}',
                            world_size=world, rank=rank)
    return backend


def axes_mesh(shape: AxesShape, rank: int, address: Optional[str] = None,
              device='cpu', backend: Optional[str] = None,
              combined: Tuple[Tuple[str, ...], ...] = ()) -> AxesMesh:
    """Join the ``shape.size``-rank world at ``address`` (``host:port`` of
    rank 0's TCP store) as ``rank`` on ``device`` with ``backend``
    (default: :func:`default_backend`) and make one group along each axis
    and along each tuple of axes in ``combined`` with ``dist.new_group``,
    every rank creating every group in the same order (as ``new_group``
    requires). An axis of size 1 gets no group; a combination in which one
    axis alone is larger than 1 is that axis' group. Size 1 initializes
    nothing."""
    device = torch.device(device)
    if shape.size == 1:
        return AxesMesh(shape=shape, device=device)
    backend = _join(shape.size, rank, address, device, backend)
    sizes = dict(zip(shape.axes, shape.sizes))
    groups = {}
    for names in [(a,) for a in shape.axes] + list(combined):
        live = tuple(a for a in names if sizes[a] > 1)
        if len(live) == 1 and live != names:
            if live[0] in groups:
                groups[group_name(names)] = groups[live[0]]
            continue
        for ranks in shape.groups(names):
            if len(ranks) == 1:
                continue
            pg = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[group_name(names)] = TPGroup(
                    rank=ranks.index(rank), world=len(ranks), device=device,
                    backend=backend, pg=pg)
    return AxesMesh(shape=shape, rank=rank, device=device, backend=backend,
                    groups=groups)


def destroy_mesh(mesh) -> None:
    """Leave the world of a :class:`TrainMesh` or an :class:`AxesMesh` (a
    no-op at size 1)."""
    if mesh.size > 1 and dist.is_initialized():
        dist.destroy_process_group()


# The reference's layouts for ring attention, the GPipe pipeline and the
# MoE (``Mesh(devices, ('sp',))``, ``Mesh(devices.reshape(dp, pp), ('dp',
# 'pp'))``, ``Mesh(devices.reshape(fsdp, tp, ep), ('fsdp', 'tp', 'ep'))``).
SP_AXES = ('sp',)
PP_AXES = ('dp', 'pp')
EP_AXES = ('fsdp', 'tp', 'ep')


# ---------------------------------------------------------------------------
# The training mesh
# ---------------------------------------------------------------------------
AXES = ('dp', 'fsdp', 'tp')
# The batch's axes, the training mesh's ``data`` group.
DATA_AXES = ('dp', 'fsdp')


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """The sizes of the three axes; ``size`` ranks in all. The mesh is
    :attr:`named`, the :class:`AxesShape` over :data:`AXES`."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def named(self) -> AxesShape:
        return AxesShape(AXES, (self.dp, self.fsdp, self.tp))

    @property
    def size(self) -> int:
        return self.named.size

    @property
    def shape(self) -> Dict[str, int]:
        """``{'dp': .., 'fsdp': .., 'tp': ..}``, as ``Mesh.shape``."""
        return dict(zip(AXES, self.named.sizes))

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """Rank ``rank``'s (dp, fsdp, tp) coordinates."""
        return tuple(self.named.coords(rank).values())

    def rank_of(self, dp: int, fsdp: int, tp: int) -> int:
        """The rank at coordinates (dp, fsdp, tp)."""
        return self.named.rank_of(dict(dp=dp, fsdp=fsdp, tp=tp))

    def axis_groups(self, axis: str) -> List[List[int]]:
        """Every group of ranks along ``axis`` (``'data'``: ``dp`` and
        ``fsdp`` together, dp-major), each in rank order, the groups
        ordered by the other coordinates."""
        return self.named.groups(DATA_AXES if axis == 'data' else (axis,))


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
              n_devices: int = 1) -> MeshShape:
    """The reference's ``make_mesh`` over ``n_devices`` ranks: the axes
    must multiply to exactly that many."""
    want = dp * fsdp * tp
    if want != n_devices:
        raise ValueError(
            f'mesh {dp}x{fsdp}x{tp}={want} != {n_devices} devices')
    return MeshShape(dp, fsdp, tp)


def auto_mesh(n_devices: int, *, tp: Optional[int] = None) -> MeshShape:
    """All-FSDP with an optional ``tp`` factor (the reference's
    default)."""
    tp = tp or 1
    if n_devices % tp != 0:
        raise ValueError(f'tp={tp} does not divide {n_devices} devices')
    return make_mesh(dp=1, fsdp=n_devices // tp, tp=tp, n_devices=n_devices)


def mesh_from_hosts(n_hosts: int, devices_per_host: int, *,
                    tp: Optional[int] = None, dp: int = 1) -> MeshShape:
    """The reference's ``mesh_from_slice`` rule over ``n_hosts`` hosts of
    ``devices_per_host`` GPUs: ``tp`` defaults to one host's devices
    (NVLink inside a host), ``fsdp`` takes the rest."""
    total = n_hosts * devices_per_host
    if tp is None:
        tp = min(devices_per_host, total)
    if total % (tp * dp) != 0:
        raise ValueError(f'dp={dp} * tp={tp} must divide {total} chips')
    return make_mesh(dp=dp, fsdp=total // (tp * dp), tp=tp, n_devices=total)


def make_multislice_mesh(num_slices: int, n_devices: int, *,
                         fsdp: Optional[int] = None,
                         tp: int = 1) -> MeshShape:
    """The reference's multislice mesh: ``dp`` spans the slices (ranks
    slice-major, as the agent numbers the hosts), ``fsdp`` and ``tp`` stay
    inside one."""
    if n_devices % num_slices != 0:
        raise ValueError(
            f'{n_devices} devices do not split into {num_slices} slices')
    per_slice = n_devices // num_slices
    if fsdp is None:
        if per_slice % tp != 0:
            raise ValueError(f'tp={tp} must divide {per_slice} '
                             f'devices/slice')
        fsdp = per_slice // tp
    if fsdp * tp != per_slice:
        raise ValueError(
            f'fsdp={fsdp} * tp={tp} != {per_slice} devices per slice')
    return make_mesh(dp=num_slices, fsdp=fsdp, tp=tp, n_devices=n_devices)


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """One rank's view of the training mesh: its shape, rank, device and
    backend, a :class:`TPGroup` for each axis it belongs to
    (``groups['dp' | 'fsdp' | 'tp' | 'data']``; the world-size-1 group
    for an axis of size 1), and ``host_pg``, a ``gloo`` group of the whole
    world for host values (the checkpoint's decisions), never an NCCL
    one."""
    shape: MeshShape = MeshShape()
    rank: int = 0
    device: torch.device = torch.device('cpu')
    backend: Optional[str] = None
    groups: Dict[str, TPGroup] = dataclasses.field(default_factory=dict)
    host_pg: Any = None

    @property
    def size(self) -> int:
        return self.shape.size

    @property
    def coords(self) -> Tuple[int, int, int]:
        return self.shape.coords(self.rank)

    def group(self, axis: str) -> TPGroup:
        return self.groups.get(axis) or single(self.device)

    def data_index(self) -> int:
        """This rank's row block of the batch: dp-major over dp x fsdp."""
        d, f, _ = self.coords
        return d * self.shape.fsdp + f


def single_mesh(device='cpu') -> TrainMesh:
    """The one-device mesh: no process group."""
    return TrainMesh(device=torch.device(device))


def train_mesh(shape: MeshShape, rank: int, address: Optional[str] = None,
               device='cpu', backend: Optional[str] = None) -> TrainMesh:
    """Join the world as :func:`axes_mesh` does over ``shape.named``, with
    ``data`` the group along :data:`DATA_AXES`, and add ``host_pg``. Size
    1 initializes nothing."""
    device = torch.device(device)
    if shape.size == 1:
        return single_mesh(device)
    m = axes_mesh(shape.named, rank, address, device, backend,
                  combined=(DATA_AXES,))
    groups = dict(m.groups)
    data = groups.pop(group_name(DATA_AXES), None)
    if data is not None:
        groups['data'] = data
    host_pg = (dist.group.WORLD if m.backend == 'gloo'
               else dist.new_group(backend='gloo'))
    return TrainMesh(shape=shape, rank=rank, device=device,
                     backend=m.backend, groups=groups, host_pg=host_pg)
