"""Communication core: the trainer world, groups and the hybrid mesh
(counterpart of ``paddle_tpu/distributed/comm.py``).

**A rank is a process.** The JAX package is single-controller SPMD: one
process drives every device, and a per-rank value is a global array whose
leading axis is the rank axis. The port returns to upstream Paddle's model,
which is also PyTorch's: each rank is a process of a ``torch.distributed``
process group and holds its own tensor. Row ``r`` of the JAX package's rank
axis is what rank ``r`` of the port holds: :func:`shard_rank_axis` takes the
global ``[N, ...]`` array and returns this rank's row, :func:`replicate`
returns the rank's copy, and :func:`spmd_region` / :func:`in_spmd_region`
keep their names and contract (every port call is already per rank).

``init_parallel_env`` reads the launch env that ``launch.build_cluster_env``
writes (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS``) and meets its
peers at rank 0's endpoint (``tcp://``), or at ``init_method`` (a
``file://`` store needs no port). Each rank's device is ``cuda:{local_rank %
device_count}``, or the CPU when the caller asks (``device="cpu"``, or
``set_device("cpu")`` before).

**The backend, by rule:** ``nccl`` when every rank of the host has a card of
its own; ``gloo`` when ranks share a card (several ranks on one H100) or run
on the CPU. NCCL refuses two ranks on one device, so the rule is not a
preference: a ``backend=`` that disagrees with it raises, and nothing picks
another backend in silence. :func:`backend` names the job's.

``init_hybrid_mesh(dp, mp, pp, sp)`` lays the world out as the JAX
package's mesh, axis order ``(dp, pp, sp, mp)`` with mp innermost (rank =
``((dp_index * PP + pp_index) * SP + sp_index) * MP + mp_index``), and makes
the group of each axis and the ``data`` group (dp x sp) once, on every rank
in the same order. ``dp_inner`` above 1 factors dp into the two levels of
a hierarchical reduction (counterpart of
``paddle_tpu/distributed/comm.py:419-455``): ``dcn`` outer x ``ici``
inner, ``dp = dcn * dp_inner``, the dp index ``dcn_index * dp_inner +
ici_index`` (so a rank is ``((((dcn * ICI + ici) * PP + pp) * SP + sp) *
MP + mp``, the same rank as before), and the mesh gains the ``dcn`` and
``ici`` groups; ``dp`` and ``data`` stay the whole dp (x sp) group.
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Group", "HybridMesh", "ParallelEnv", "init_parallel_env",
           "is_initialized", "get_group", "new_group", "get_rank",
           "get_world_size", "backend", "backend_rule", "rank_device",
           "init_hybrid_mesh", "hybrid_mesh", "dp_axes", "dp_size",
           "mp_mesh", "mp_group", "dp_group", "data_group", "mesh_rank",
           "mesh_coords", "shard_rank_axis",
           "replicate", "spmd_region", "in_spmd_region",
           "destroy_parallel_env"]


class Group:
    """A communicator: a set of trainer ranks and the ``torch.distributed``
    process group over them (None for a group of one rank, whose
    collectives are local). ``rank`` is this process's index in the group,
    -1 when it is not a member."""

    def __init__(self, ranks: Sequence[int], gid: int,
                 axis_name: Optional[str] = None, pg=None,
                 backend_name: str = "local"):
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.id = int(gid)
        self.axis_name = axis_name or f"g{self.id}"
        self.pg = pg
        self.backend = backend_name if self.nranks > 1 else "local"
        self.rank = self.get_group_rank(get_rank())

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"axis='{self.axis_name}', backend={self.backend})")


class HybridMesh:
    """The job's rank grid: axes ``(dp, pp, sp, mp)``, mp innermost. ``shape``
    maps each axis to its degree; :meth:`group` is this rank's Group along
    an axis and :meth:`axis_rank` its index there. A hierarchical mesh
    (``dp_inner`` above 1) names ``(dcn, ici, pp, sp, mp)`` as its axes,
    as the JAX package's does, and keeps ``dp`` in ``shape``, the groups
    and the coordinates as the pair's product."""

    def __init__(self, shape: Dict[str, int], groups: Dict[str, Group],
                 coords: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = (("dcn", "ici") if "dcn" in self.shape
                           else ("dp",)) + MESH_AXES[1:]
        self.size = 1
        for a in MESH_AXES:
            self.size *= int(self.shape[a])
        self._groups = groups
        self._coords = coords

    def group(self, axis: str) -> Group:
        return self._groups[axis]

    def axis_rank(self, axis: str) -> int:
        return self._coords[axis]

    def __repr__(self):
        return f"HybridMesh({self.shape})"


class _CommState:
    def __init__(self):
        self.default_group: Optional[Group] = None
        self.groups: Dict[int, Group] = {}
        self.next_gid = 1
        self.spmd_axes: Tuple[str, ...] = ()
        self.backend: Optional[str] = None
        self.device: Optional[torch.device] = None


_state = _CommState()
#: the job's hybrid mesh (None before ``init_hybrid_mesh``)
_mesh: Optional[HybridMesh] = None


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def get_rank() -> int:
    """This trainer's rank: the process group's, else
    ``PADDLE_TRAINER_ID`` (0 when unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", 0)


def get_world_size() -> int:
    """The number of trainer processes: the process group's, else
    ``PADDLE_TRAINERS_NUM`` (1 when unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", 1)


def _local_rank_and_size() -> Tuple[int, int]:
    """This rank's index among the ranks of its host, and their number,
    from the launch env's endpoints (all ranks local when it has none)."""
    rank, world = get_rank(), get_world_size()
    eps = [e for e in os.environ.get(
        "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
    if len(eps) != world:
        return rank, world
    host = eps[rank].rpartition(":")[0]
    local = [i for i, e in enumerate(eps) if e.rpartition(":")[0] == host]
    return local.index(rank), len(local)


def backend_rule(device: torch.device, local_world: int) -> str:
    """``nccl`` when each rank of the host has a card of its own, ``gloo``
    when ranks share a card or run on the CPU."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this rank: the CPU when asked (``device="cpu"``, or
    ``set_device("cpu")`` before), else ``cuda:{local_rank %
    device_count}`` (raising on a host without a card)."""
    from ..core import device as _dev

    if device is not None:
        return _dev.resolve_device(device)
    if _dev._current is not None and _dev._current.type == "cpu":
        return _dev._current
    if not torch.cuda.is_available():
        return _dev.resolve_device(None)  # raises: no CUDA device
    local, _ = _local_rank_and_size()
    return torch.device("cuda", local % torch.cuda.device_count())


def init_parallel_env(backend: Optional[str] = None, *,
                      init_method: Optional[str] = None,
                      device=None) -> "ParallelEnv":
    """Set up this trainer's world (reference: parallel.py:57): its device
    (made the package default), and above one trainer the process group,
    met at ``init_method`` or at rank 0's endpoint of
    ``PADDLE_TRAINER_ENDPOINTS``. ``backend`` (None, ``"auto"`` or
    ``PADDLE_DISTRI_BACKEND`` when unset) takes the rule's; another that
    disagrees with the rule raises. ``PADDLE_RDV_DEADLINE`` (seconds, 600
    when unset) bounds the rendezvous and each collective of gloo. A
    second call returns the same world. The process group is torn down
    at exit (:func:`destroy_parallel_env`)."""
    from ..core import device as _dev

    if _state.default_group is not None:
        return ParallelEnv()
    backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or None
    dev = rank_device(device)
    world = get_world_size()
    rank = get_rank()
    _, local_world = _local_rank_and_size()
    rule = backend_rule(dev, local_world)
    if backend not in (None, "auto", rule):
        raise ValueError(
            f"init_parallel_env(backend={backend!r}): the rule gives "
            f"{rule!r} for {local_world} rank(s) of this host on {dev} "
            f"({torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "card(s)); nccl needs a card per rank, gloo serves ranks "
            "that share one")
    meet = world > 1 and not dist.is_initialized()
    if meet and init_method is None:
        eps = [e for e in os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        if not eps or ":" not in eps[0]:
            raise ValueError(
                f"PADDLE_TRAINERS_NUM={world} needs "
                "PADDLE_TRAINER_ENDPOINTS (host:port entries) or an "
                "init_method")
        init_method = f"tcp://{eps[0]}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _dev.set_device(f"gpu:{dev.index}")
    else:
        _dev.set_device("cpu")
    _state.device = dev
    _state.backend = rule
    if meet:
        secs = float(os.environ.get("PADDLE_RDV_DEADLINE", "") or 600.0)
        dist.init_process_group(
            rule, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=secs))
        atexit.register(destroy_parallel_env)
    pg = dist.group.WORLD if world > 1 else None
    _state.default_group = Group(range(world), 0, "dp", pg, rule)
    _state.groups[0] = _state.default_group
    _publish_streams()
    return ParallelEnv()


def _ensure_init() -> Group:
    if _state.default_group is None:
        init_parallel_env()
    return _state.default_group


def _default_group() -> Group:
    return _ensure_init()


def is_initialized() -> bool:
    return _state.default_group is not None


def backend() -> Optional[str]:
    """The job's backend by the rule (None before ``init_parallel_env``)."""
    return _state.backend


def get_group(gid: int = 0) -> Optional[Group]:
    return _state.groups.get(gid)


def new_group(ranks: Optional[List[int]] = None,
              backend: Optional[str] = None,
              axis_name: Optional[str] = None) -> Group:
    """A communicator over ``ranks`` (collective.py new_group). Every rank
    of the world calls it, members or not, in the same order (a
    ``torch.distributed`` rule); a non-member gets a Group whose ``rank``
    is -1 and whose collectives return at once."""
    world = _ensure_init()
    ranks = list(range(world.nranks)) if ranks is None else \
        sorted(int(r) for r in ranks)
    if backend not in (None, "auto", _state.backend):
        raise ValueError(f"new_group(backend={backend!r}): the job's rule "
                         f"gives {_state.backend!r}")
    pg = None
    if world.nranks > 1 and len(ranks) > 1:
        pg = dist.new_group(ranks, backend=_state.backend)
    gid = _state.next_gid
    _state.next_gid += 1
    g = Group(ranks, gid, axis_name, pg, _state.backend)
    _state.groups[gid] = g
    return g


class ParallelEnv:
    """Env facade (reference: fluid/dygraph/parallel.py ParallelEnv)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def local_rank(self) -> int:
        return _local_rank_and_size()[0]

    @property
    def dev_id(self) -> int:
        dev = _state.device
        return int(dev.index or 0) if dev is not None and \
            dev.type == "cuda" else 0

    @property
    def device_id(self) -> int:
        return self.dev_id

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self) -> list:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return [e for e in eps.split(",") if e]


# ---------------------------------------------------------------------------
# spmd regions: every port call is per rank already; the marker keeps the
# JAX package's contract for code that asks
# ---------------------------------------------------------------------------


class _SpmdRegion:
    def __init__(self, axes: Tuple[str, ...]):
        self.axes = axes

    def __enter__(self):
        self._prev = _state.spmd_axes
        _state.spmd_axes = self._prev + self.axes
        return self

    def __exit__(self, *exc):
        _state.spmd_axes = self._prev


def spmd_region(*axes: str) -> _SpmdRegion:
    """Mark code that runs per rank over ``axes`` (on the process model all
    of it does: collectives inside behave as outside)."""
    return _SpmdRegion(tuple(axes))


def in_spmd_region(axis_name: Optional[str] = None) -> bool:
    if axis_name is None:
        return bool(_state.spmd_axes)
    return axis_name in _state.spmd_axes


# ---------------------------------------------------------------------------
# the hybrid mesh
# ---------------------------------------------------------------------------


#: the mesh's axes, outermost first (mp innermost)
MESH_AXES = ("dp", "pp", "sp", "mp")


def mesh_rank(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    """The rank at ``coords`` of a mesh of ``shape``: ``((dp * PP + pp) *
    SP + sp) * MP + mp``, the JAX package's device order
    (``devices.reshape(dp, pp, sp, mp)``)."""
    r = 0
    for a in MESH_AXES:
        r = r * int(shape[a]) + int(coords[a])
    return r


def mesh_coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """The inverse of :func:`mesh_rank`."""
    out = {}
    for a in reversed(MESH_AXES):
        out[a] = rank % int(shape[a])
        rank //= int(shape[a])
    return {a: out[a] for a in MESH_AXES}


def _axis_groups(shape: Dict[str, int], axes: Tuple[str, ...], me: int,
                 name: str, order: Tuple[str, ...] = MESH_AXES) -> Group:
    """Make every group whose ranks differ only along ``axes`` of the
    axes ``order`` (every rank of the world calls this, in one order) and
    return this rank's."""
    import itertools

    def rank_of(coords):
        r = 0
        for a in order:
            r = r * int(shape[a]) + int(coords[a])
        return r

    others = [a for a in order if a not in axes]
    mine = None
    for fixed in itertools.product(*(range(shape[a]) for a in others)):
        base = dict(zip(others, fixed))
        ranks = [rank_of({**base, **dict(zip(axes, var))})
                 for var in itertools.product(*(range(shape[a])
                                                for a in axes))]
        g = new_group(ranks, axis_name=name)
        if me in ranks:
            mine = g
    return mine


def init_hybrid_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sp: int = 1,
                     dp_inner: int = 1) -> HybridMesh:
    """Lay the world out as the job's mesh (axes dp, pp, sp, mp; mp
    innermost: rank ``((dp * PP + pp) * SP + sp) * MP + mp``) and make the
    group of each axis above 1, on every rank in the same order, plus the
    ``data`` group over dp x sp (the ranks that hold the same replicated
    parameters and different tokens: gradients are averaged over it). The
    product of the degrees must be the world size. ``dp_inner`` above 1
    factors dp into ``dcn`` (``dp / dp_inner``) x ``ici`` (``dp_inner``),
    ici innermost, and makes the ``dcn`` and ``ici`` groups after the
    others."""
    global _mesh
    dp_inner = int(dp_inner)
    if dp_inner > 1 and int(dp) % dp_inner:
        raise ValueError(f"hierarchical dp: dp={dp} not divisible by "
                         f"dp_inner={dp_inner}")
    shape = dict(dp=int(dp), pp=int(pp), sp=int(sp), mp=int(mp))
    need = 1
    for v in shape.values():
        need *= v
    world = get_world_size()
    if need != world:
        raise ValueError(
            f"hybrid topology dp={dp} x pp={pp} x sp={sp} x mp={mp} = {need} "
            f"ranks, but the world has {world}: launch that many trainers")
    if world > 1:
        _ensure_init()
    me = get_rank() if world > 1 else 0
    coords = mesh_coords(me, shape)
    groups = {}
    solo = Group([me], -1, "solo")
    for a in MESH_AXES:
        groups[a] = _axis_groups(shape, (a,), me, a) \
            if shape[a] > 1 else solo
    groups["data"] = groups["dp"] if shape["sp"] == 1 else \
        _axis_groups(shape, ("dp", "sp"), me, "data") \
        if shape["dp"] > 1 else groups["sp"]
    if dp_inner > 1:
        shape.update(dcn=shape["dp"] // dp_inner, ici=dp_inner)
        coords.update(dcn=coords["dp"] // dp_inner,
                      ici=coords["dp"] % dp_inner)
        order = ("dcn", "ici") + MESH_AXES[1:]
        for a in ("dcn", "ici"):
            groups[a] = _axis_groups(shape, (a,), me, a, order) \
                if shape[a] > 1 else solo
    _mesh = HybridMesh(shape, groups, coords)
    _publish_streams()
    return _mesh


def hybrid_mesh() -> Optional[HybridMesh]:
    return _mesh


def dp_axes(mesh: Optional[HybridMesh] = None):
    """The axis (or axis pair) data-parallel work shards over: ``dp``, or
    ``("dcn", "ici")`` on a hierarchical mesh."""
    m = mesh if mesh is not None else _mesh
    if m is not None and "ici" in m.axis_names:
        return ("dcn", "ici")
    return "dp"


def dp_size(mesh: Optional[HybridMesh] = None) -> int:
    """The data-parallel degree (on a hierarchical mesh, dcn x ici)."""
    m = mesh if mesh is not None else _mesh
    return 1 if m is None else int(m.shape["dp"])


def mp_mesh() -> HybridMesh:
    """The mesh tensor-parallel layers shard over (its ``mp`` axis)."""
    if _mesh is None:
        raise RuntimeError(
            "model-parallel layers need a hybrid mesh: call "
            "fleet.init(strategy=DistributedStrategy with "
            "hybrid_configs={'mp_degree': N}) or "
            "distributed.comm.init_hybrid_mesh(mp=N) first")
    return _mesh


def mp_group() -> Optional[Group]:
    """This rank's mp Group (None without a mesh)."""
    return None if _mesh is None else _mesh.group("mp")


def data_group() -> Optional[Group]:
    """The group over which replicated parameters' gradients are averaged:
    dp x sp (every rank of it holds other tokens); the dp group when sp is
    1, the default group without a mesh."""
    if _mesh is not None:
        return _mesh.group("data")
    return _state.default_group


def dp_group() -> Optional[Group]:
    """This rank's dp Group: the mesh's, else the default group (None
    before ``init_parallel_env``)."""
    if _mesh is not None:
        return _mesh.group("dp")
    return _state.default_group


# ---------------------------------------------------------------------------
# per-rank values
# ---------------------------------------------------------------------------


def _rank_in(group: Optional[Group]) -> Tuple[int, int]:
    g = group or _ensure_init()
    return g.rank, g.nranks


def shard_rank_axis(raw, group: Optional[Group] = None):
    """The global ``[nranks, ...]`` array of the JAX package's per-rank
    convention -> this rank's row, a ``Tensor`` on the rank's device."""
    from ..core.tensor import to_tensor

    r, n = _rank_in(group)
    arr = raw.numpy() if hasattr(raw, "numpy") else raw
    if getattr(arr, "ndim", 0) == 0 or arr.shape[0] != n:
        raise ValueError(f"shard_rank_axis: leading axis of length {n} "
                         f"expected, got shape {tuple(arr.shape)}")
    return to_tensor(arr[r], place=_state.device)


def replicate(raw, group: Optional[Group] = None):
    """The value every rank holds: a ``Tensor`` of ``raw`` on the rank's
    device."""
    from ..core.tensor import to_tensor

    _ensure_init()
    arr = raw.numpy() if hasattr(raw, "numpy") else raw
    return to_tensor(arr, place=_state.device)


# ---------------------------------------------------------------------------
# random streams
# ---------------------------------------------------------------------------


def _publish_streams() -> None:
    """Name this rank's random streams in ``core.random`` (outside a world
    of several ranks none is named, and the package's generator serves):

    - ``dropout``: per dp x sp index. The batch is split over dp and the
      sequence over sp, so each such rank draws its own masks, while mp
      peers, which hold the same activations, draw the same ones.
    - ``dropout_mp``: per dp and mp index, for activations that tensor
      parallelism shards (the heads, the MLP's hidden units).
    - ``shard_init``: per mp index, for the shards of tensor-parallel
      weights (dp peers hold the same shard; mp peers different ones, so
      no two shards start equal).
    """
    from ..core import random as _rnd

    keys = {}
    if get_world_size() > 1 and _state.default_group is not None:
        dp_i = _mesh.axis_rank("dp") * _mesh.shape["sp"] \
            + _mesh.axis_rank("sp") if _mesh is not None else get_rank()
        mp_i = _mesh.axis_rank("mp") if _mesh is not None else -1
        keys = {"dropout": (1, dp_i, -1), "dropout_mp": (1, dp_i, mp_i)}
    if _mesh is not None and _mesh.shape["mp"] > 1:
        keys["shard_init"] = (2, _mesh.axis_rank("mp"))
    _rnd.set_streams(keys)


def _reset() -> None:
    """Forget the world, its groups and the mesh (tests; the process group
    itself is destroyed by whoever made it)."""
    global _state, _mesh
    _state = _CommState()
    _mesh = None
    _publish_streams()


def destroy_parallel_env() -> None:
    """Tear this rank's world down before the process exits: drop the
    port's groups, then destroy the process groups while the interpreter
    still runs (a gloo process group left to the interpreter's own
    teardown can end the process with ``std::terminate``)."""
    import gc

    _reset()
    gc.collect()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
