"""The device mesh: the ``data``, ``model``, ``pipe``, ``seq`` and
``expert`` axes over a ``torch.distributed`` group.

Port of ``deeplearning4j_tpu/parallel/mesh.py``.  The reference's mesh
is a grid of JAX devices with five named axes; the port's is a thin
object over an initialized process group: one process a device, laid
out as the reference's ``make_mesh`` lays out its devices (:39-71),
row-major over ``(data, model, pipe, seq, expert)``, so the ranks of
one model group are contiguous (rank ``g`` of a ``data=D x model=M``
mesh sits at data index ``g // M``, model index ``g % M``; of a
``data=D x pipe=P`` mesh at data index ``g // P``, pipe index
``g % P``).  Each axis has a process group of its own
(``Mesh.groups``), created identically on every rank, and so have the
token group ``("data", "expert")`` an expert-parallel batch shards over
and the sequence group ``("data", "seq")`` a sequence-parallel loss
sums over.  A rank holds the row slice of each global batch for its
data index, the model-, pipe- and expert-axis slices of the params for
its indices there (``parallel/tensor_parallel.shard_tree``) and, on a
``seq`` axis, its index's block of every sequence; the collectives of
``parallel/collectives.py`` run over an axis's group.

- :func:`initialize_distributed` starts the group with
  ``torch.distributed.init_process_group``: NCCL for CUDA, gloo for the
  CPU, with a ``file://``, ``tcp://`` or ``env://`` rendezvous.
- :func:`make_mesh` wraps the group as a :class:`Mesh`.  Its ``shape``
  maps each of the five axis names to its size, so code written against
  the reference's ``mesh.shape[...]`` reads it unchanged.
- The padding contract is the reference's: a global batch that does not
  divide by the data degree is zero-padded at its tail
  (:func:`pad_rows`) and the padded rows are masked out of the loss.

The elastic re-mesh after a device loss (:292-365): in the port a device
is a rank, so a lost device is a lost rank.  :func:`elastic_plan` is the
reference's plan as a pure function of the mesh's shape, its ranks and
the lost ones; :func:`elastic_remesh` builds the smaller mesh with
``make_mesh(..., ranks=survivors)``, which only the survivors call: it
makes their groups with ``use_local_synchronization``, so no lost rank
takes part (the old groups are abandoned, never destroyed: a destroy
may wait on the dead peer).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"

ALL_AXES = (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, EXPERT_AXIS)

#: the token group of an expert-parallel batch (``Mesh.groups`` key)
TOKEN_AXES = (DATA_AXIS, EXPERT_AXIS)

#: the sequence group a sequence-parallel loss sums over (``Mesh.groups``
#: key; the reference's ``psum(..., (DATA_AXIS, SEQ_AXIS))``, bert.py:395)
SEQ_TOKEN_AXES = (DATA_AXIS, SEQ_AXIS)

#: the two-axis groups a mesh makes, beside one group an axis
PLANES = (TOKEN_AXES, SEQ_TOKEN_AXES)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism degrees. ``data=-1`` means "absorb remaining
    devices" (the reference's :39-68)."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        for name in ("model", "pipe", "seq", "expert"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} degree must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.data != -1 and self.data < 1:
            raise ValueError(f"data degree must be >= 1 or -1 (absorb), "
                             f"got {self.data}")
        fixed = self.model * self.pipe * self.seq * self.expert
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by model*pipe*seq*expert="
                f"{fixed}")
        data = self.data if self.data > 0 else n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{fixed} != {n_devices} devices")
        return {DATA_AXIS: data, MODEL_AXIS: self.model, PIPE_AXIS: self.pipe,
                SEQ_AXIS: self.seq, EXPERT_AXIS: self.expert}


class Mesh:
    """The five axes of an initialized process group.

    ``shape`` maps every axis name to its size (their product is the
    group's size); ``size`` is that product; ``ranks`` are the mesh's
    global ranks in mesh order; ``rank`` is this process's index on the
    data axis (the row block it trains on, the seed of its dropout
    stream) and ``coords`` its index on the data and model axes and, on
    each of ``pipe``, ``seq`` and ``expert`` above 1, that axis;
    ``device`` is where this rank's tensors live.
    ``group`` is the data axis's process group, the one the
    data-parallel collectives use (None: the default group); ``groups``
    maps each axis name and the planes ``("data", "expert")`` and
    ``("data", "seq")`` to their groups (an axis of one: None) and
    ``world`` is the whole mesh's (None: the default group).
    ``timeout_s`` bounds each collective on the groups the mesh made
    (a rank whose peer never joins one raises after it)."""

    axis_names = ALL_AXES

    def __init__(self, sizes: Dict[str, int], group, ranks: Tuple[int, ...],
                 rank: int, device: torch.device, backend: str, *,
                 groups: Optional[Dict[str, Any]] = None, world=None,
                 coords: Optional[Dict[str, int]] = None,
                 timeout_s: Optional[float] = None):
        self.shape = {a: int(sizes.get(a, 1)) for a in ALL_AXES}
        self.group = group
        self.ranks = tuple(ranks)
        self.rank = int(rank)
        self.device = device
        self.backend = backend
        self.world = world if groups is not None else group
        self.groups = dict(groups) if groups is not None else {
            DATA_AXIS: group, MODEL_AXIS: None, PIPE_AXIS: None,
            SEQ_AXIS: None, EXPERT_AXIS: None, TOKEN_AXES: group,
            SEQ_TOKEN_AXES: group}
        self.coords = dict(coords) if coords is not None else {
            DATA_AXIS: int(rank), MODEL_AXIS: 0}
        self.timeout_s = float(
            timeout_s if timeout_s is not None
            else dist.default_pg_timeout.total_seconds())

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def model_rank(self) -> int:
        """This process's index on the model axis."""
        return int(self.coords.get(MODEL_AXIS, 0))

    @property
    def expert_rank(self) -> int:
        """This process's index on the expert axis."""
        return int(self.coords.get(EXPERT_AXIS, 0))

    @property
    def pipe_rank(self) -> int:
        """This process's index on the pipe axis: its pipeline stage."""
        return int(self.coords.get(PIPE_AXIS, 0))

    @property
    def seq_rank(self) -> int:
        """This process's index on the seq axis: its sequence block."""
        return int(self.coords.get(SEQ_AXIS, 0))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={self.shape[a]}" for a in ALL_AXES
                         if a in (DATA_AXIS, MODEL_AXIS, EXPERT_AXIS)
                         or self.shape[a] > 1)
        ranks = "".join(f", {a}_rank={int(self.coords.get(a, 0))}"
                        for a in ALL_AXES[1:]
                        if a in (MODEL_AXIS, EXPERT_AXIS)
                        or self.shape[a] > 1)
        return (f"Mesh({axes}, rank={self.rank}{ranks}, "
                f"device={self.device}, backend={self.backend})")


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _local_cuda(rank: int) -> torch.device:
    """This rank's card: ranks are spread over the visible cards."""
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: DeviceLike = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> bool:
    """Join (or start) the process group: the counterpart of the
    reference's ``jax.distributed.initialize`` (:98-106).
    ``coordinator_address`` is a rendezvous URL (``file:///path``,
    ``tcp://host:port`` or ``env://``); a bare ``host:port`` is taken as
    ``tcp://``.  ``device`` (None = CUDA, raising without it) picks the
    backend: NCCL on CUDA, gloo on the CPU; ``backend="gloo"`` on CUDA
    runs gloo over CUDA tensors (several ranks on one card, which NCCL
    refuses).  ``timeout`` (seconds; default ``torch.distributed``'s)
    bounds the rendezvous and every collective of the default group.
    Returns False, doing nothing, without an address; True once the group
    is up.  A group already up is an error: one process joins one
    group."""
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized; "
                           "destroy_process_group() first")
    dev = resolve_device(device)
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    kw = {}
    backend = backend or _default_backend(dev)
    if dev.type == "cuda":
        dev = _local_cuda(int(process_id or 0))
        torch.cuda.set_device(dev)
        if backend == "nccl":
            # NCCL binds its communicator to the card; a gloo group
            # bound to one would split its subgroups, which gloo cannot
            kw["device_id"] = dev
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes or 1),
                            rank=int(process_id or 0), **kw)
    return True


def initialize_from_env(device: DeviceLike = None) -> bool:
    """Cluster wiring from the environment the launch scripts export:
    ``DL4J_TPU_COORDINATOR`` (a rendezvous URL or host:port),
    ``DL4J_TPU_NUM_PROCESSES`` and ``DL4J_TPU_PROCESS_ID`` (the
    reference's trio, :109-128).  False, doing nothing, when the
    coordinator is unset."""
    addr = os.environ.get("DL4J_TPU_COORDINATOR")
    if not addr:
        return False
    return initialize_distributed(
        addr, int(os.environ.get("DL4J_TPU_NUM_PROCESSES", "1")),
        int(os.environ.get("DL4J_TPU_PROCESS_ID", "0")), device=device)


def make_mesh(spec: Optional[MeshSpec] = None, group=None,
              device: DeviceLike = None,
              timeout: Optional[float] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A :class:`Mesh` over ``group`` (default: the whole default group,
    which :func:`initialize_distributed` started).  The spec must resolve
    to the group's size.  Above a degree of 1 on any axis but ``data``
    every rank of the default group must call it, in the same order (it
    creates, with :func:`torch.distributed.new_group`, one process group
    for each line of ranks along each axis, and one for each plane of
    :data:`PLANES`), and the mesh must span the default group.  Each
    call makes groups of its own: two meshes of one shape share no
    communicator, so two threads may run collectives on them at once.
    ``device`` defaults to this rank's card under NCCL and the CPU under
    gloo.  ``timeout`` (seconds; default ``torch.distributed``'s) bounds
    each collective on the groups it makes.

    ``ranks`` (global ranks, in mesh order) lays the mesh over those
    ranks alone, and only they call it: each makes only the groups it
    belongs to, with ``use_local_synchronization``, so a rank outside
    (the lost ones of :func:`elastic_remesh`) takes no part.  The mesh's
    ``world`` is then a group of its own over ``ranks``.  Its members
    must have made the same number of process groups before (torch names
    such a group by its ranks and that count), as the members of one
    earlier mesh have."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "parallel.mesh.initialize_distributed(...) first")
    spec = spec or MeshSpec()
    backend = dist.get_backend(group)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    local = ranks is not None
    if local:
        if group is not None:
            raise ValueError("make_mesh takes group= or ranks=, not both")
        ranks = tuple(int(r) for r in ranks)
        if dist.get_rank() not in ranks:
            raise ValueError(f"rank {dist.get_rank()} is not among the "
                             f"mesh's ranks {ranks}: only they call it")
        n = len(ranks)
        pos = ranks.index(dist.get_rank())
    else:
        n = dist.get_world_size(group)
        pos = dist.get_rank(group)
        ranks = (tuple(range(n)) if group is None
                 else tuple(dist.get_process_group_ranks(group)))
    sizes = spec.resolve(n)
    if device is None:
        dev = (_local_cuda(dist.get_rank()) if backend == "nccl"
               else torch.device("cpu"))
    else:
        dev = resolve_device(device)

    def new_group(members):
        return dist.new_group(list(members), use_local_synchronization=True,
                              **kw)

    world = new_group(ranks) if local else None
    if all(sizes[a] == 1 for a in ALL_AXES[1:]):
        return Mesh(sizes, world if local else group, ranks, pos, dev,
                    backend, timeout_s=timeout)
    if group is not None:
        raise ValueError("a mesh with an axis besides data spans the "
                         "default process group (make_mesh(spec) with "
                         "group=None)")
    dims = tuple(sizes[a] for a in ALL_AXES)
    grid = torch.arange(n).reshape(dims)
    # this rank's index on data, model and each other axis above 1
    coords = {a: int(c) for a, c in zip(ALL_AXES,
                                        (grid == pos).nonzero()[0])
              if a in (DATA_AXIS, MODEL_AXIS) or sizes[a] > 1}
    groups: Dict[Any, Any] = {}
    # one group for each line of the grid along each axis (and for each
    # plane), made in the same order by every rank that makes it
    for key in ALL_AXES + PLANES:
        names = key if isinstance(key, tuple) else (key,)
        axes = tuple(ALL_AXES.index(a) for a in names)
        if len(names) > 1 and any(dims[a] == 1 for a in axes):
            # the plane is a line: the other axis's group (data's when
            # both are one)
            groups[key] = groups[names[1] if dims[axes[0]] == 1
                                 else DATA_AXIS]
            continue
        if key != DATA_AXIS and dims[axes[0]] == 1:
            groups[key] = None
            continue
        rest = [a for a in range(len(dims)) if a not in axes]
        lines = grid.permute(*rest, *axes).reshape(-1, math.prod(
            dims[a] for a in axes))
        for line in lines.tolist():
            members = [ranks[i] for i in line]
            if local:
                if pos in line:
                    groups[key] = new_group(members)
            else:
                g = dist.new_group(members, **kw)
                if pos in line:
                    groups[key] = g
    return Mesh(sizes, groups[DATA_AXIS], ranks, coords[DATA_AXIS], dev,
                backend, groups=groups, world=world, coords=coords,
                timeout_s=timeout)


def _data(mesh) -> int:
    return int(mesh.shape[DATA_AXIS])


def local_batch_size(global_batch: int, mesh, *, pad: bool = True) -> int:
    """Per-shard rows of a global batch over ``mesh``'s data axis
    (:131-156): the ceiling when the batch does not divide (the tail
    shard is zero-padded), an error with ``pad=False``; a batch smaller
    than the data degree is always an error."""
    n = _data(mesh)
    if global_batch < n:
        raise ValueError(
            f"global batch {global_batch} < data-parallel degree {n}: "
            f"at least one example per shard is required — use a bigger "
            f"batch or a smaller mesh (MeshSpec(data=...))")
    if global_batch % n != 0:
        if not pad:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"data-parallel degree {n} (pad=False)")
        return -(-global_batch // n)
    return global_batch // n


def padded_global_batch(global_batch: int, mesh, multiple: int = 1) -> int:
    """Smallest size >= ``global_batch`` divisible by ``data_degree *
    multiple`` (``multiple``: the accumulation factor) (:159-166)."""
    local_batch_size(global_batch, mesh)
    chunk = _data(mesh) * max(multiple, 1)
    return -(-global_batch // chunk) * chunk


def pad_rows(arr, target: int) -> torch.Tensor:
    """``arr`` (a tensor or an array) with its leading axis zero-padded
    up to ``target`` rows (:169-180): the padding every data-parallel
    path shares.  Padded rows carry zero weight in the masked loss."""
    t = torch.as_tensor(arr)
    b = t.shape[0]
    if b == target:
        return t
    pad = torch.zeros((target - b,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad])


def pad_global_batch(x, y, mesh, multiple: int = 1):
    """``(x_pad, y_pad, n_valid)``: both zero-padded to
    :func:`padded_global_batch` rows (:183-190)."""
    b = int(x.shape[0])
    target = padded_global_batch(b, mesh, multiple)
    return pad_rows(x, target), pad_rows(y, target), b


def shard_rows(arr, mesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``arr`` along ``axis`` (the rows
    of a padded global batch, axis 1 of a stacked ``[NB, B, ...]``
    one): rank ``r`` of ``n`` takes ``[r b/n, (r+1) b/n)``, the block
    the reference's ``P("data")`` places on device ``r``."""
    t = torch.as_tensor(arr)
    n = _data(mesh)
    if t.shape[axis] % n:
        raise ValueError(f"{t.shape[axis]} rows do not split over a data "
                         f"axis of {n}: pad them first (pad_rows)")
    local = t.shape[axis] // n
    return t.narrow(axis, mesh.rank * local, local)


def mesh_signature(mesh):
    """Hashable identity for engine keys (:193-207): the axis sizes, the
    group's global ranks, this process's data index and its device, so
    ``data=4``, ``data=2 x model=2`` and ``data=2 x expert=2`` over the
    same ranks are three entries.  None without a mesh."""
    if mesh is None:
        return None
    return (tuple((a, int(mesh.shape[a])) for a in mesh.axis_names),
            tuple(mesh.ranks), int(mesh.rank), str(mesh.device))


def model_degree(mesh) -> int:
    """Tensor-parallel degree of ``mesh`` (1 when absent/None)."""
    return 1 if mesh is None else int(mesh.shape.get(MODEL_AXIS, 1))


def pipe_degree(mesh) -> int:
    """Pipeline-parallel degree of ``mesh`` (1 when absent/None)."""
    return 1 if mesh is None else int(mesh.shape.get(PIPE_AXIS, 1))


def expert_degree(mesh) -> int:
    """Expert-parallel degree of ``mesh`` (1 when absent/None)."""
    return 1 if mesh is None else int(mesh.shape.get(EXPERT_AXIS, 1))


def seq_degree(mesh) -> int:
    """Sequence-parallel degree of ``mesh`` (1 when absent/None)."""
    return 1 if mesh is None else int(mesh.shape.get(SEQ_AXIS, 1))


def check_mesh_axes(mesh) -> None:
    """Raise ``ValueError`` when ``mesh`` (anything with a ``shape``
    mapping) names an axis outside :data:`ALL_AXES` or sizes one below
    1; every axis of the reference's ``MeshSpec`` passes."""
    if mesh is None:
        return
    for axis, n in dict(getattr(mesh, "shape", {})).items():
        if axis not in ALL_AXES or int(n) < 1:
            raise ValueError(f"mesh axis {axis!r} of size {n}: the axes are "
                             f"{ALL_AXES}, each of size >= 1")


def mesh_captures(mesh) -> bool:
    """Whether a step over ``mesh`` may be captured as a CUDA graph: the
    one place that choice is made.  gloo's collectives run on the host
    and cannot enter a graph, so a step over a gloo group runs eagerly;
    NCCL's are captured with the step (no mesh: captured)."""
    return mesh is None or mesh.backend != "gloo"


def per_device_bytes(tree, mesh=None) -> Dict[int, int]:
    """Bytes each device holds for the tensors of ``tree`` (:239-259).
    Without ``mesh``: by CUDA device index, from the tensors of this
    process (host tensors count nothing, as the reference's host-resident
    leaves).  With ``mesh``: ``tree`` is this rank's share of a
    rank-sharded tree, and the result maps each of the mesh's global
    ranks to the bytes of its share (every tensor leaf, on any device),
    gathered with one all-gather over the mesh."""
    from deeplearning4j_tpu_torch.ops.updaters import tree_leaves

    leaves = [leaf for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor)]
    if mesh is not None:
        mine = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
        dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        parts = [torch.zeros((), dtype=torch.int64, device=dev)
                 for _ in mesh.ranks]
        dist.all_gather(parts, torch.full((), mine, dtype=torch.int64,
                                          device=dev), group=mesh.world)
        return {r: int(p) for r, p in zip(mesh.ranks, parts)}
    out: Dict[int, int] = {}
    for leaf in leaves:
        if leaf.device.type == "cuda":
            idx = int(leaf.device.index or 0)
            out[idx] = out.get(idx, 0) + leaf.numel() * leaf.element_size()
    return out


_AUTO_MESH: Optional[Tuple[Tuple[int, int], Mesh]] = None


def auto_data_mesh(devices=None) -> Optional[Mesh]:
    """The default-fit mesh (:262-287): every rank of the initialized
    default group on the data axis, or None when no group is up or it
    has one rank (nothing to shard over).  Memoized per (world size,
    rank).  ``devices=`` (global ranks: the survivors of a device loss)
    lays the data mesh over those ranks alone, unmemoized, and only they
    call it; fewer than two give None."""
    global _AUTO_MESH
    if devices is not None:
        devices = [int(d) for d in devices]
        if len(devices) < 2:
            return None
        return make_mesh(MeshSpec(data=-1), ranks=devices)
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    ident = (dist.get_world_size(), dist.get_rank())
    if _AUTO_MESH is None or _AUTO_MESH[0] != ident:
        _AUTO_MESH = (ident, make_mesh(MeshSpec(data=-1)))
    return _AUTO_MESH[1]


# -- elastic re-meshing (device loss / preemption survival) -----------------

class RemeshError(ValueError):
    """A device loss that shrinking the data axis cannot recover from:
    the survivors cannot field even one intact ``model`` x ``pipe`` x
    ``seq`` x ``expert`` group, or nothing survived (the reference's
    :292-299)."""


def surviving_devices(mesh, lost_ids) -> list:
    """The mesh's ranks minus the lost ones, in mesh order."""
    lost = set(int(i) for i in lost_ids)
    return [r for r in mesh.ranks if int(r) not in lost]


def elastic_plan(shape: Dict[str, int], ranks: Sequence[int], lost_ids,
                 grad_accum: int = 1
                 ) -> Tuple[Optional[Dict[str, int]], list, int]:
    """The reference's re-mesh plan (:308-365) as a pure function:
    ``(new_shape, survivors, new_accum)`` for a mesh of axis sizes
    ``shape`` over ``ranks`` (mesh order) after losing ``lost_ids``.

    Only ``data`` shrinks: whole ``model`` x ``pipe`` x ``seq`` x
    ``expert`` groups are kept, and the new data degree is the largest
    group count the survivors field that divides the old effective
    factor ``data x grad_accum``; ``new_accum = eff // degree``, so the
    effective batch is kept.  ``survivors`` are the ranks the new mesh
    uses, the first ``degree x group`` survivors in mesh order (the
    reference leaves the rest idle; in the port they leave the run).
    ``new_shape`` is None for a pure data mesh down to one rank (the
    caller continues without a mesh).  :class:`RemeshError` when nothing
    survives or no whole group does."""
    lost = sorted(set(int(i) for i in lost_ids))
    survivors = [int(r) for r in ranks if int(r) not in set(lost)]
    if not survivors:
        raise RemeshError(
            f"device loss {lost} leaves no survivors in this mesh — "
            "nothing to resume on")
    model = int(shape.get(MODEL_AXIS, 1))
    pipe = int(shape.get(PIPE_AXIS, 1))
    seq = int(shape.get(SEQ_AXIS, 1))
    expert = int(shape.get(EXPERT_AXIS, 1))
    group = model * pipe * seq * expert
    eff = int(shape[DATA_AXIS]) * max(int(grad_accum), 1)
    if group > 1:
        groups = len(survivors) // group
        if groups < 1:
            raise RemeshError(
                f"device loss leaves {len(survivors)} surviving "
                f"device(s), fewer than one intact model×pipe group of "
                f"model*pipe*seq*expert={group}: the survivor count must "
                f"be divisible into groups of {group} (required divisor "
                f"{group}) to keep the sharded weight layout — restore "
                f"onto a fleet of at least {group} devices instead")
        degree = next(n for n in range(groups, 0, -1) if eff % n == 0)
        return ({DATA_AXIS: degree, MODEL_AXIS: model, PIPE_AXIS: pipe,
                 SEQ_AXIS: seq, EXPERT_AXIS: expert},
                survivors[:degree * group], eff // degree)
    degree = next(n for n in range(len(survivors), 0, -1) if eff % n == 0)
    if degree < 2:
        return None, survivors[:1], eff // degree
    return ({DATA_AXIS: degree, MODEL_AXIS: 1, PIPE_AXIS: 1, SEQ_AXIS: 1,
             EXPERT_AXIS: 1}, survivors[:degree], eff // degree)


def elastic_remesh(mesh, lost_ids, grad_accum: int = 1
                   ) -> Tuple[Optional[Mesh], int]:
    """``(new_mesh, new_accum)`` over the survivors of a device loss
    (:308): :func:`elastic_plan`, then ``make_mesh(..., ranks=
    survivors)`` on the mesh's device with its collective timeout.  Only
    the ranks the plan keeps call it (a rank it drops raises
    ``ValueError``); the new mesh is None for a pure data mesh down to
    one rank, which continues alone with the whole effective batch as
    its accumulation."""
    shape, survivors, new_accum = elastic_plan(mesh.shape, mesh.ranks,
                                               lost_ids, grad_accum)
    me = dist.get_rank()
    if me not in survivors:
        raise ValueError(f"rank {me} is not among the survivors "
                         f"{survivors} the re-meshed run keeps")
    if shape is None:
        return None, new_accum
    spec = MeshSpec(**shape)
    return (make_mesh(spec, device=mesh.device, timeout=mesh.timeout_s,
                      ranks=survivors), new_accum)
