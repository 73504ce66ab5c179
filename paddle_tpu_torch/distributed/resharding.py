"""Elastic resharding: survive a rank's loss without relaunching the job
(counterpart of ``paddle_tpu/distributed/resharding.py``).

- **planner** (:func:`plan_refactoring`): given the lost ranks, pick a new
  dcn x ici (or flat dp) factoring of the mesh. Model axes (mp, pp, sp)
  keep their degree: their shards are replicated across dp rows only, so
  a lost rank retires its whole dp row, and a hierarchical mesh balances
  to the smallest surviving ici group (dcn2 x ici4 less one rank is dcn2
  x ici3; an intact row past the balance idles, ``dropped_ranks``). The
  planner works on a :class:`MeshLayout`, a mesh's shape and rank order
  without its groups (the port's ``comm.HybridMesh`` gives one; dp axes
  lead).
- **coverage** (:func:`leaf_coverage`): a reshard is sound only when every
  piece of every state leaf has a holder among the survivors. The port
  knows who holds what from the mesh's geometry (:class:`Leaf`): state
  replicated over dp is held by every rank of its dp row set, so it is
  covered; a ZeRO shard (``fleet``'s ``_ZeroShard``) lives on one dp rank,
  so its loss is not covered, and the job takes the host checkpoint
  fallback.
- **executor** (:class:`ElasticStep`'s transition): the old world's
  process groups are destroyed and the members of the new one meet again
  (``comm.rebuild_world``: torch has no shrink), then
  ``TrainStep.rebind_world`` points everything that caches a group at the
  new world (a module that keeps the mesh itself, the pipeline's or the
  MoE layer's, does not follow: its next collective raises on the old
  world's destroyed groups). A shrink of replicated state moves nothing: each survivor
  already holds it. On a return, the grown world sends each returning rank
  the state of its model index from a survivor (parameters, buffers,
  optimizer state, the scaler and the guard), broadcast over a group of
  that survivor and the index's returning ranks only.
- **control plane**: departure and return notices (the ``rank`` fault
  site, the launcher's notice file after SIGUSR1, the
  :meth:`ElasticStep.notify_departure` / :meth:`ElasticStep.notify_return`
  API) are consumed at a step boundary; ``strategy.elastic_reshard``
  picks off / ``"shrink"`` / ``"shrink_expand"``, with quorum and batch
  semantics in ``strategy.elastic_reshard_configs``.

Every rank consumes the same events (the API called on every rank, a
fault spec every rank reads, the notice the launcher appends to every
survivor's file), so every rank computes the same plan. Every reshard
emits a ``reshard`` row on the telemetry bus (the JAX package's keys:
trigger, lost, survivors, dropped, old and new factoring, covered,
fallback, uncovered, bytes moved, wall seconds) and a line on stderr;
``tools/timeline.py`` renders the rows as duration slices.

Departures from the JAX package, each a consequence of a rank being a
process:

- State reaches a returning rank over the group (``broadcast`` through
  the comm monitor; on one card over gloo through the host), where the
  JAX package moves it with ``jax.device_put``. ``bytes_moved`` counts
  what the port sends: the state bytes broadcast to returning ranks, plus
  the ZeRO shards gathered before the world changes. A shrink of
  replicated state sends 0 bytes.
- The eager step has no compiled program to drop: a transition costs no
  recompile (the JAX package's costs exactly one, on its recompile
  ledger).
- A rank that is out (departed, or alive but left out of the new mesh by
  the ici balance) leaves the world: it holds no process group, launches
  nothing and joins no collective until a return folds it back in. Its
  ``ElasticStep.__call__`` returns None and its ``shard_input`` returns
  None (the global batch is kept for the call that folds it back).
- A collective that fails inside an :class:`ElasticStep` call (a peer
  died mid-step; the comm monitor marks its record ``failed``) waits up to
  ``PADDLE_COLL_TIMEOUT`` seconds (60 when unset or 0) for the launcher's
  departure notice; with one, what the step changed before its optimizer
  write is put back (``TrainStep._retry_point``: the host counters, the
  buffers the forward mutates, every random stream, the guard's capture;
  no update was written: every collective of a step comes before its
  optimizer write), the world reshards, and the same batch runs again
  from the unchanged state; the ``reshard`` row carries
  ``"retried_step": true``. Without a notice, or on any other failure,
  the error surfaces as it does without resharding.
"""
from __future__ import annotations

import json
import os
import pickle
import signal
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

__all__ = [
    "ReshardError", "RankLostError", "CoverageError", "MeshLayout",
    "MeshPlan", "Leaf", "plan_refactoring", "leaf_coverage",
    "coverage_report", "ElasticStep", "install_reshard_notice",
    "read_launcher_notices", "factoring_str", "relayout_tree",
]

_NOTICE_ENV = "PADDLE_RESHARD_NOTICE_FILE"

#: mesh axes that carry data-parallel rows (shrinkable); every other axis
#: is a model axis whose degree the planner keeps
_DP_AXES = ("dp", "dcn", "ici")


class ReshardError(RuntimeError):
    """Base of the reshard control plane's failures."""


class RankLostError(ReshardError):
    """A rank loss that cannot be absorbed in the job (policy off, quorum
    lost, or no surviving dp row): the job goes back to the elastic
    launcher's relaunch path."""


class CoverageError(ReshardError):
    """The survivors cannot rebuild the state (a departed rank held the
    only copy of some shard) and no host checkpoint fallback is
    registered."""


def factoring_str(dims: Dict[str, int]) -> str:
    """'dp4' / 'dcn2xici4' / 'dcn2xici3xmp2': size-1 model axes are left
    out, dp axes always print (a shrink to dp1 must show)."""
    parts = [f"{a}{n}" for a, n in dims.items()
             if a in _DP_AXES or n > 1]
    return "x".join(parts) if parts else "dp1"


class MeshLayout:
    """A mesh's axes (dp axes first), degree by axis, and its ranks in
    row-major order (ranks in the world's first numbering): what the
    planner and the coverage verdicts need of a mesh, without groups."""

    __slots__ = ("axis_names", "shape", "ranks")

    def __init__(self, axis_names: Sequence[str], shape: Dict[str, int],
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        self.ranks = list(range(n)) if ranks is None \
            else [int(r) for r in ranks]
        if len(self.ranks) != n:
            raise ValueError(f"{len(self.ranks)} ranks for a mesh of "
                             f"{self.shape}")

    @classmethod
    def of(cls, mesh) -> "MeshLayout":
        """The layout of a port ``comm.HybridMesh`` (or of another
        ``MeshLayout``), ranks ``0..size-1``."""
        if isinstance(mesh, MeshLayout):
            return mesh
        return cls(mesh.axis_names, {a: int(mesh.shape[a])
                                     for a in mesh.axis_names})

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def devices(self) -> np.ndarray:
        """The ranks as an array of the mesh's shape (the JAX mesh's
        ``devices``)."""
        return np.asarray(self.ranks).reshape(
            [self.shape[a] for a in self.axis_names])

    def dp_size(self) -> int:
        n = 1
        for a in self.axis_names:
            if a in _DP_AXES:
                n *= self.shape[a]
        return n

    def row_len(self) -> int:
        """Ranks in one dp row (the product of the model axes)."""
        return self.size // self.dp_size()

    def hybrid_dims(self) -> Tuple[Dict[str, int], int]:
        """``(init_hybrid_mesh`` degrees, ``dp_inner)`` of this layout."""
        s = self.shape
        dims = {a: s.get(a, 1) for a in ("pp", "sp", "mp")}
        if "dcn" in s:
            dims["dp"] = s["dcn"] * s["ici"]
            return dims, s["ici"]
        dims["dp"] = s.get("dp", 1)
        return dims, 1

    def __repr__(self):
        return f"MeshLayout({self.shape}, ranks={self.ranks})"


class MeshPlan:
    """One planned re-factoring: the survivors' mesh and the bookkeeping
    the control plane and the telemetry need."""

    __slots__ = ("old_mesh", "new_mesh", "old_dims", "new_dims",
                 "lost_ranks", "survivor_ranks", "dropped_ranks")

    def __init__(self, old_mesh, new_mesh, old_dims, new_dims,
                 lost_ranks, survivor_ranks, dropped_ranks):
        self.old_mesh = old_mesh
        self.new_mesh = new_mesh
        self.old_dims = old_dims      # {axis: size} of the base mesh
        self.new_dims = new_dims
        self.lost_ranks = lost_ranks          # sorted base ranks
        self.survivor_ranks = survivor_ranks  # ranks the new mesh uses
        self.dropped_ranks = dropped_ranks    # alive but unused (the ici
        #                                       balance's remainder)

    def describe(self) -> str:
        s = (f"{factoring_str(self.old_dims)} -> "
             f"{factoring_str(self.new_dims)}")
        if self.dropped_ranks:
            s += f" (idling intact ranks {self.dropped_ranks})"
        return s


def plan_refactoring(base_mesh, lost_ranks: Sequence[int]) -> MeshPlan:
    """Factor the surviving ranks of ``base_mesh`` (a ``MeshLayout`` or a
    port ``HybridMesh``) into a new mesh. ``lost_ranks`` are flat indices
    into the base mesh's rank order. A lost rank retires its whole dp row.
    Raises :class:`RankLostError` when no complete dp row survives."""
    base = MeshLayout.of(base_mesh)
    axes = list(base.axis_names)
    sizes = dict(base.shape)
    dp_axes = [a for a in axes if a in _DP_AXES]
    model_axes = [a for a in axes if a not in _DP_AXES]
    if axes[:len(dp_axes)] != dp_axes:
        raise ReshardError(
            f"unsupported mesh layout {axes}: dp axes must lead "
            "(init_hybrid_mesh order)")
    n = base.size
    lost = sorted(set(int(r) for r in lost_ranks))
    for r in lost:
        if not 0 <= r < n:
            raise ReshardError(f"lost rank {r} out of range for a "
                               f"{n}-device mesh")
    row_len = 1
    for a in model_axes:
        row_len *= sizes[a]
    n_rows = n // row_len
    lost_rows = {r // row_len for r in lost}
    row_ranks = [list(range(i * row_len, (i + 1) * row_len))
                 for i in range(n_rows)]
    new_dims = dict(sizes)
    keep_rows: List[int] = []
    dropped: List[int] = []
    if len(dp_axes) == 2:  # hierarchical dcn x ici
        ici = sizes[dp_axes[1]]
        groups = []
        for g in range(sizes[dp_axes[0]]):
            intact = [g * ici + j for j in range(ici)
                      if (g * ici + j) not in lost_rows]
            if intact:
                groups.append(intact)
        if not groups:
            raise RankLostError(
                "no intact dp row survives — world lost, fall back to the "
                "relaunch path")
        ici_new = min(len(g) for g in groups)
        for g in groups:
            keep_rows.extend(g[:ici_new])
            for row in g[ici_new:]:
                dropped.extend(row_ranks[row])
        new_dims[dp_axes[0]] = len(groups)
        new_dims[dp_axes[1]] = ici_new
    elif len(dp_axes) == 1:
        keep_rows = [i for i in range(n_rows) if i not in lost_rows]
        if not keep_rows:
            raise RankLostError(
                "no intact dp row survives — world lost, fall back to the "
                "relaunch path")
        new_dims[dp_axes[0]] = len(keep_rows)
    else:
        raise ReshardError(
            f"mesh {axes} has no dp axis to shrink — elastic resharding "
            "needs a data-parallel dimension")
    ranks = [base.ranks[r] for i in keep_rows for r in row_ranks[i]]
    new_mesh = MeshLayout(axes, new_dims, ranks)
    survivors = sorted(r for i in keep_rows for r in row_ranks[i])
    return MeshPlan(base, new_mesh, sizes, new_dims, lost, survivors,
                    sorted(dropped))


# ---------------------------------------------------------------------------
# coverage: can the survivors rebuild every byte?
# ---------------------------------------------------------------------------


class Leaf:
    """A state leaf and who holds it: ``pieces`` lists, for each piece of
    the leaf, the set of ranks holding a copy of that piece."""

    __slots__ = ("value", "pieces")

    def __init__(self, value, pieces: Sequence[Set[int]]):
        self.value = value
        self.pieces = [frozenset(p) for p in pieces]

    @classmethod
    def replicated(cls, value, mesh: MeshLayout) -> "Leaf":
        """A leaf every dp row holds (its model index's piece): one piece
        a position in the row, held by that position of every row."""
        rl = mesh.row_len()
        rows = [mesh.ranks[i:i + rl] for i in range(0, mesh.size, rl)]
        return cls(value, [{row[j] for row in rows} for j in range(rl)])

    @classmethod
    def dp_sharded(cls, value, mesh: MeshLayout) -> "Leaf":
        """A leaf each rank holds its own piece of (a ZeRO shard)."""
        return cls(value, [{r} for r in mesh.ranks])


def leaf_coverage(leaf, lost_ranks: Set[int]) -> bool:
    """True when every piece of ``leaf`` has a holder outside
    ``lost_ranks``; a value that is not a :class:`Leaf` (a host value)
    is covered."""
    pieces = getattr(leaf, "pieces", None)
    if pieces is None:
        return True
    lost = set(int(r) for r in lost_ranks)
    return all(p - lost for p in pieces)


def coverage_report(leaves: Dict[str, object],
                    lost_ranks: Set[int]) -> List[str]:
    """Names of the leaves the survivors can NOT rebuild."""
    return [name for name, leaf in leaves.items()
            if not leaf_coverage(leaf, lost_ranks)]


def relayout_tree(tree, target):
    """Every tensor leaf of ``tree`` (dicts, lists and tuples of tensors)
    moved to ``target`` (a device), None leaves passed through: the
    counterpart of the JAX package's one ``device_put`` a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: relayout_tree(v, target) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(relayout_tree(v, target) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(target)
    return tree


# ---------------------------------------------------------------------------
# the launcher's notice channel
# ---------------------------------------------------------------------------

_notice_flag = threading.Event()


def install_reshard_notice() -> None:
    """Install the SIGUSR1 handler the elastic launcher sends after
    writing a notice row to ``PADDLE_RESHARD_NOTICE_FILE``. The handler
    only sets a flag; the row is consumed at the next step boundary. No-op
    off the main thread (the poller reads the file regardless).

    It touches ``<notice_file>.armed``: the launcher sends SIGUSR1 only
    once that marker exists (before the handler is installed, SIGUSR1's
    default action would end a child still importing)."""
    if threading.current_thread() is not threading.main_thread():
        return

    def _handler(signum, frame):
        _notice_flag.set()

    try:
        signal.signal(signal.SIGUSR1, _handler)
    except (ValueError, OSError, AttributeError):
        return
    path = os.environ.get(_NOTICE_ENV)
    if path:
        try:
            with open(path + ".armed", "w"):
                pass
        except OSError:
            pass


def read_launcher_notices(offset: int = 0) -> Tuple[List[dict], int]:
    """Notice rows appended to ``PADDLE_RESHARD_NOTICE_FILE`` past
    ``offset`` (bytes): ``(rows, new_offset)``. A torn last line is left
    for the next poll."""
    path = os.environ.get(_NOTICE_ENV)
    if not path or not os.path.exists(path):
        return [], offset
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            chunk = f.read()
    except OSError:
        return [], offset
    rows: List[dict] = []
    consumed = 0
    for line in chunk.splitlines(keepends=True):
        if not line.endswith(b"\n"):
            break  # a torn write: next poll
        consumed += len(line)
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict) and row.get("event") in (
                "depart", "return", "lend", "reclaim"):
            rows.append(row)
    return rows, offset + consumed


# ---------------------------------------------------------------------------
# the control plane: a reshard-aware step wrapper
# ---------------------------------------------------------------------------


def _coll_timeout() -> float:
    raw = os.environ.get("PADDLE_COLL_TIMEOUT", "")
    try:
        v = float(raw) if raw.strip() else 0.0
    except ValueError:
        v = 0.0
    return v if v > 0 else 60.0


class ElasticStep:
    """Wrap a ``jit.TrainStep`` with the elastic-reshard control plane::

        estep = resharding.ElasticStep(TrainStep(model, loss_fn, opt))
        for x, y in loader:
            loss = estep(estep.shard_input(x), estep.shard_input(y))

    Departure and return notices (the ``rank`` fault site, the launcher's
    notice file, :meth:`notify_departure` / :meth:`notify_return`, which
    every rank calls alike) are consumed at the next call, a step
    boundary: at most one transition a boundary, to the net state of the
    events folded in order. Policy comes from ``strategy.elastic_reshard``
    on the optimizer's strategy (arguments override): None/"off" turns
    every departure into :class:`RankLostError`, ``"shrink"`` absorbs
    covered departures, ``"shrink_expand"`` also folds returning ranks
    back in. ``quorum`` (default 0.5) is the least share of the first
    world that must survive; ``batch`` is ``"rescale"`` (the global batch
    kept: each rank's share grows) or ``"shrink"`` (each rank's first
    share kept: a smaller global batch). ``fallback`` is called to restore
    state the survivors cannot cover (else the guard's rescue target,
    ``TrainEpochRange``, restores).

    A call returns the step's loss on a rank of the world, and None on a
    rank that is out (the module's notes); :meth:`shard_input` likewise.
    Batches must come through :meth:`shard_input`: a transition at the
    call re-shards the global batch it kept."""

    def __init__(self, step, policy: Optional[str] = None,
                 quorum: Optional[float] = None,
                 batch: Optional[str] = None, fallback=None):
        from . import comm

        self.step = step
        strategy = getattr(step.opt, "user_defined_strategy", None)
        cfg = (dict(strategy.elastic_reshard_configs)
               if strategy is not None else {})
        if policy is None and strategy is not None:
            policy = strategy.elastic_reshard
        self.policy = (policy or "off").lower()
        if self.policy not in ("off", "shrink", "shrink_expand"):
            raise ValueError(
                f"elastic_reshard={self.policy!r}: want off|shrink|"
                "shrink_expand")
        self.quorum = float(quorum if quorum is not None
                            else cfg.get("quorum", 0.5))
        self.batch = str(batch if batch is not None
                         else cfg.get("batch", "rescale"))
        if self.batch not in ("rescale", "shrink"):
            raise ValueError(
                f"elastic_reshard batch={self.batch!r}: want "
                "rescale|shrink")
        self._fallback = fallback
        mesh = comm.hybrid_mesh()
        self._had_hybrid = mesh is not None
        self._base_mesh = MeshLayout.of(mesh) if mesh is not None else \
            MeshLayout(("dp",), {"dp": comm.get_world_size()})
        self.mesh = self._base_mesh
        self._lost: Set[int] = set()
        self._queued: List[Tuple[str, Optional[int]]] = []
        #: role notices ("lend"/"reclaim" rows) naming this rank, oldest
        #: first (:meth:`pending_role`)
        self.role_events: List[dict] = []
        self._self_rank = comm.base_rank()
        self._notice_offset = 0
        self._per_rank_batch: Optional[int] = None
        self._fed: List[list] = []   # [result, global batch, used]
        self._retry = False
        self.reshards = 0
        #: the ``reshard`` rows of this rank's transitions, oldest first
        self.rows: List[dict] = []
        if os.environ.get(_NOTICE_ENV):
            # launched by a reshard-aware ElasticManager: arm the SIGUSR1
            # handler before the first notice
            install_reshard_notice()

    # -- public notice API -------------------------------------------------
    def notify_departure(self, ranks) -> None:
        """Queue a departure notice (consumed at the next step boundary).
        ``ranks`` are flat indices into the first mesh."""
        for r in np.atleast_1d(ranks):
            self._queued.append(("depart", int(r)))

    def notify_return(self, ranks) -> None:
        for r in np.atleast_1d(ranks):
            self._queued.append(("return", int(r)))

    def pending_role(self):
        """Pop the oldest role notice naming this rank (``{"role":
        "serve"|"train", ...}`` from a ``lend``/``reclaim`` row), or
        None."""
        return self.role_events.pop(0) if self.role_events else None

    @property
    def live_ranks(self) -> List[int]:
        return [r for r in range(self._base_mesh.size)
                if r not in self._lost]

    @property
    def out(self) -> bool:
        """Is this rank out of the current mesh (departed or idle)?"""
        return self._self_rank not in self.mesh.ranks

    def dp_size(self) -> int:
        return self.mesh.dp_size()

    # -- input sharding (global-batch semantics) ---------------------------
    def shard_input(self, x):
        """This rank's part of a global batch over the current mesh (rows
        over dp; positions over sp on a mesh with sequence parallelism).
        Under ``batch="rescale"`` the global batch is kept (the share
        grows after a shrink; divisibility checked); under ``"shrink"``
        the batch is cut to the first per-rank share times the current
        dp. None on a rank that is out."""
        from ..core.tensor import Tensor

        raw = x._data if isinstance(x, Tensor) else x
        if not isinstance(raw, torch.Tensor):
            raw = np.asarray(raw)
        dp = self.dp_size()
        if self._per_rank_batch is None:
            if raw.shape[0] % dp:
                raise ValueError(
                    f"global batch {raw.shape[0]} does not divide the dp "
                    f"degree {dp}")
            self._per_rank_batch = raw.shape[0] // dp
        out = self._shard(raw, dp)
        self._fed.append([out, raw, False])
        return out

    def _shard(self, raw, dp):
        from . import comm
        from .parallel import shard_batch, shard_tokens

        if self.batch == "shrink":
            want = self._per_rank_batch * dp
            if raw.shape[0] > want:
                raw = raw[:want]
        if raw.shape[0] % dp:
            if self.batch == "rescale":
                raise ValueError(
                    f"elastic_reshard batch='rescale' preserves the global "
                    f"batch, but {raw.shape[0]} does not divide the "
                    f"post-reshard dp degree {dp}; feed a divisible global "
                    f"batch or use batch='shrink'")
            raise ValueError(
                f"batch of {raw.shape[0]} rows does not divide the current "
                f"dp degree {dp} (elastic_reshard batch='shrink' trims to "
                f"{self._per_rank_batch} rows per rank; feed at least that "
                f"many per live rank)")
        if self.out:
            return None
        mesh = comm.hybrid_mesh()
        if mesh is not None and mesh.shape["sp"] > 1:
            return shard_tokens(raw, mesh)
        return shard_batch(raw)

    def _reshard_batch(self, xs):
        """The batch of the call, sharded again over the current mesh from
        the global batches :meth:`shard_input` kept."""
        if xs is None and not any(not e[2] for e in self._fed):
            return None
        single = not isinstance(xs, (list, tuple))
        out = []
        for x in ([xs] if single else xs):
            entry = next((e for e in self._fed
                          if not e[2] and e[0] is x), None)
            if entry is None:
                raise ReshardError(
                    "a batch that ElasticStep.shard_input did not make "
                    "cannot be sharded again after a reshard: pass every "
                    "batch through shard_input")
            entry[0] = self._shard(entry[1], self.dp_size())
            entry[2] = True
            out.append(entry[0])
        return out[0] if single else type(xs)(out)

    # -- the step-boundary hook --------------------------------------------
    def __call__(self, inputs, labels=None):
        try:
            n = self.reshards
            self._poll_notices()
            if self.reshards != n:
                # the batch was sharded before the notice landed: shard
                # it again over the new mesh (under batch="shrink", to the
                # new global batch)
                inputs = self._reshard_batch(inputs)
                labels = self._reshard_batch(labels)
            if self.out:
                return None
            return self._run(inputs, labels)
        finally:
            self._fed = []

    def _run(self, inputs, labels):
        from . import comm_monitor

        mon = comm_monitor.monitor()
        n0 = mon._n_records
        point = None if self.policy == "off" else self.step._retry_point()
        try:
            return self.step(inputs, labels)
        except Exception:
            if point is None or not self._collective_failed(mon, n0):
                raise
            # a peer died mid-step: no update was written (every
            # collective of a step precedes its optimizer write)
            self.step._rewind(point)
            n = self.reshards
            if not self._await_departure(n):
                raise
        for e in self._fed:
            e[2] = False
        inputs = self._reshard_batch(inputs)
        labels = self._reshard_batch(labels)
        if self.out:
            return None
        return self.step(inputs, labels)

    @staticmethod
    def _collective_failed(mon, n0: int) -> bool:
        """Did a collective of this call fail (the monitor's records past
        ``n0``)?"""
        k = mon._n_records - n0
        recs = mon.snapshot()[-k:] if k > 0 else []
        return any(r.get("status") == "failed" for r in recs)

    def _await_departure(self, n: int) -> bool:
        """Poll the launcher's notices for a departure, up to
        ``PADDLE_COLL_TIMEOUT`` seconds; True once one was folded in."""
        t_end = time.monotonic() + _coll_timeout()
        self._retry = True
        try:
            while time.monotonic() < t_end:
                self._poll_notices()
                if self.reshards != n:
                    return True
                time.sleep(0.05)
        finally:
            self._retry = False
        return False

    def _poll_notices(self) -> None:
        from ..utils import fault_injection as _FI

        events = [(a, r, "fault") for a, r in _FI.consume_rank_events()]
        if self._queued:
            events.extend((a, r, "api") for a, r in self._queued)
            self._queued = []
        if _notice_flag.is_set() or os.environ.get(_NOTICE_ENV):
            _notice_flag.clear()
            rows, self._notice_offset = read_launcher_notices(
                self._notice_offset)
            for row in rows:
                ev = row["event"]
                if ev in ("lend", "reclaim"):
                    # mesh-wise a lend is a departure and a reclaim a
                    # return; the named rank also learns its new role
                    ranks = [int(r) for r in row.get("ranks", [])]
                    if self._self_rank in ranks:
                        self.role_events.append(dict(
                            row, role=("serve" if ev == "lend"
                                       else "train")))
                    ev = "depart" if ev == "lend" else "return"
                    events.extend((ev, r, "launcher") for r in ranks)
                    continue
                events.extend((ev, int(r), "launcher")
                              for r in row.get("ranks", []))
        if not events:
            return
        # fold the events into the lost set in order (a return then a
        # departure of one rank nets to "still lost"), then make at most
        # one transition, to the net state
        net_lost = set(self._lost)
        n = self._base_mesh.size
        trigger = "api"
        first = True
        for action, rank, src in events:
            if rank is None:
                live = [r for r in range(n) if r not in net_lost]
                rank = max(live) if action == "depart" and live \
                    else (max(net_lost) if net_lost else None)
            if rank is None:
                continue
            if action == "depart":
                net_lost.add(int(rank))
            elif self.policy == "shrink_expand":
                net_lost.discard(int(rank))
            if first:
                trigger = src
                first = False
        added = net_lost - self._lost
        if added:
            self._handle_departure(sorted(net_lost), sorted(added),
                                   trigger=trigger)
        elif net_lost != self._lost:
            self._handle_return(sorted(net_lost), trigger=trigger)

    # -- the state inventory -----------------------------------------------
    def _params(self):
        return list(self.step._params)

    def _state_leaves(self) -> Dict[str, Leaf]:
        """Every state leaf of the step and who holds it on the current
        mesh: parameters, buffers, optimizer accumulators, the scaler and
        the guard; a ZeRO shard is dp-sharded, the rest replicated."""
        step, mesh = self.step, self.mesh
        leaves: Dict[str, Leaf] = {}

        def add(name, v, p=None):
            zs = getattr(p, "_zero_shard", None) if p is not None else None
            sharded = zs is not None and tuple(v.shape) == zs.shard_shape \
                and zs.shard_shape != zs.full_shape
            leaves[name] = (Leaf.dp_sharded if sharded
                            else Leaf.replicated)(v, mesh)

        params = self._params()
        names = {id(p): (getattr(p, "name", None) or str(i))
                 for i, p in enumerate(params)}
        for p in params:
            add(f"param:{names[id(p)]}", p.data, p)
        for i, b in enumerate(step._buffers):
            add(f"buffer:{i}", b)
        inner = getattr(step.opt, "_inner", step.opt)
        for acc, store in getattr(inner, "_accumulators", {}).items():
            for p in params:
                v = store.get(id(p))
                if v is not None:
                    add(f"opt:{names[id(p)]}.{acc}", v, p)
        for i, v in enumerate(step._scaler_state or ()):
            add(f"scaler:{i}", v)
        if step._guard is not None and step._guard_state is not None:
            add("guard:state", step._guard_state)
        return leaves

    # -- the reshard transitions -------------------------------------------
    def _handle_departure(self, net_lost: List[int], newly: List[int],
                          trigger: str) -> None:
        n = self._base_mesh.size
        if self.policy == "off":
            raise RankLostError(
                f"rank(s) {newly} departed and strategy.elastic_reshard is "
                "off — rank loss is a job failure (elastic relaunch path)")
        if (n - len(net_lost)) / n < self.quorum:
            raise RankLostError(
                f"quorum lost: {n - len(net_lost)}/{n} survivors < quorum "
                f"{self.quorum} — world loss, relaunch path")
        plan = plan_refactoring(self._base_mesh, net_lost)
        uncovered = coverage_report(self._state_leaves(), set(newly))
        self._transition(plan, trigger, uncovered, lost=net_lost)

    def _handle_return(self, net_lost: List[int], trigger: str) -> None:
        plan = plan_refactoring(self._base_mesh, net_lost)
        # an expansion is covered: all state lives on the survivors,
        # which stay members of the grown mesh
        self._transition(plan, trigger, [], lost=net_lost)

    def _transition(self, plan: MeshPlan, trigger: str,
                    uncovered: List[str], lost: List[int]) -> None:
        from . import comm
        from ..observability import bus as _bus

        step = self.step
        step.check_rebind(plan.new_dims)
        cur_dims = dict(self.mesh.shape)
        old = list(self.mesh.ranks)
        new = list(plan.new_mesh.ranks)
        me = self._self_rank
        was_in, now_in = me in old, me in new
        returning = [r for r in new if r not in old]
        t0 = time.perf_counter()
        if uncovered and self._fallback is None \
                and not self._has_rescue_target():
            raise CoverageError(
                f"survivors cannot cover {len(uncovered)} state "
                f"leaf/leaves (e.g. {uncovered[:3]}) and no "
                "host-checkpoint fallback is registered — pass "
                "fallback= or iterate a TrainEpochRange")
        fallback_used = bool(uncovered)
        moved = 0
        opt = step.opt
        zero = hasattr(opt, "_zero_unshard")
        if was_in:
            # drain: the step boundary is the barrier; the guard's
            # pending read and the queued device work finish first
            if step._guard is not None:
                step._guard._sync_pending()
            if step._device.type == "cuda":
                torch.cuda.synchronize(step._device)
            if zero:
                # ZeRO's seam: shards back to logical shapes over the old
                # dp group (lost shards: placeholders the fallback fills)
                moved += opt._zero_unshard(self._params(),
                                           gather=not uncovered)
        elif now_in and zero:
            opt._zero_unshard(self._params(), gather=False)
        dims, dp_inner = plan.new_mesh.hybrid_dims()
        comm.rebuild_world(new, dims=dims if self._had_hybrid else None,
                           dp_inner=dp_inner)
        if now_in:
            if returning:
                moved += self._send_state(plan.new_mesh, old, returning)
            if fallback_used:
                # the uncovered shards are gone: reload the last host
                # checkpoint (at logical shapes) before re-sharding
                if self._fallback is not None:
                    self._fallback()
                else:
                    from ..utils import train_guard as _TG

                    _TG._rescue_target().restore()
            step.rebind_world()
        self._lost = set(lost)
        self.mesh = plan.new_mesh
        self.reshards += 1
        wall = time.perf_counter() - t0
        payload = {
            "trigger": trigger,
            "lost": list(lost),
            "survivors": plan.survivor_ranks,
            "dropped": plan.dropped_ranks,
            "old": factoring_str(cur_dims),
            "new": factoring_str(plan.new_dims),
            "covered": not uncovered,
            "fallback": fallback_used,
            "uncovered": uncovered[:8],
            "bytes_moved": int(moved),
            "wall_s": round(wall, 4),
        }
        if self._retry:
            payload["retried_step"] = True
        self.rows.append(payload)
        _bus.emit("reshard", payload)
        role = "member" if now_in else "out"
        print(f"paddle_tpu_torch.resharding: rank {me} ({role}): "
              f"{factoring_str(cur_dims)} -> "
              f"{factoring_str(plan.new_dims)} "
              f"({'fallback' if fallback_used else 'covered'}, "
              f"{moved / 1e6:.3f} MB sent, {wall:.2f}s)",
              file=sys.stderr, flush=True)

    def _send_state(self, new_mesh: MeshLayout, old: List[int],
                    returning: List[int]) -> int:
        """Broadcast the step's state to the returning ranks: for each
        model index (a column of the grown mesh: its dp group) from the
        column's first rank that stayed in the world, over a group of that
        rank and the column's returning ranks (every rank makes every such
        group, in one order). Returns the bytes sent to returning ranks,
        summed over the world (the same on every rank)."""
        from . import collective, comm

        members = comm._state.members
        ranks = list(range(comm.get_world_size()))
        rl = new_mesh.row_len()
        mine = None
        for j in range(rl):
            col = ranks[j::rl]
            takers = [r for r in col if members[r] in returning]
            if not takers:
                continue
            src = next(r for r in col if members[r] in old)
            g = comm.new_group([src] + takers, axis_name="reshard")
            if g.is_member:
                mine = (g, g.ranks.index(src), len(takers))
        sent = 0
        if mine is not None:
            g, src, takers = mine
            size = self._broadcast_state(g, src)
            sent = size * takers if g.rank == src else 0
        total = torch.tensor([sent], dtype=torch.int64,
                             device=self.step._device)
        collective.all_reduce_(total, collective.ReduceOp.SUM,
                               comm._default_group())
        return int(total.item())

    def _broadcast_state(self, group, src: int) -> int:
        """The step's state from group rank ``src`` to the group's other
        ranks: parameters, buffers, optimizer accumulators (made where a
        taker lacks one), the merge counter, the scaler, the guard's state
        vector and host counters, the step and LR counters. Returns the
        bytes of one copy."""
        from . import collective

        step = self.step
        params = self._params()
        inner = getattr(step.opt, "_inner", step.opt)
        accs = getattr(inner, "_accumulators", {})
        dev = step._device
        host = None
        if group.rank == src:
            host = {
                "counters": step._host_counters(),
                "accs": [(name, i, tuple(store[id(p)].shape),
                          str(store[id(p)].dtype))
                         for name, store in sorted(accs.items())
                         for i, p in enumerate(params) if id(p) in store],
                "params": [tuple(p.shape) for p in params],
                "lr": inner._lr.state_dict() if hasattr(
                    inner._lr, "state_dict") else None,
                "gm": getattr(step.opt, "_gm_cnt", None) is not None,
                "guard": step._guard_host_state(),
            }
        host, size = _broadcast_object(host, src, group, dev)
        with torch.no_grad():
            for p, shape in zip(params, host["params"]):
                if tuple(p.shape) != shape:
                    p.data = torch.empty(shape, dtype=p.dtype,
                                         device=p.device)
            tensors = [p.data for p in params] + list(step._buffers)
            for name, i, shape, dtype in host["accs"]:
                store = accs.setdefault(name, {})
                p = params[i]
                v = store.get(id(p))
                if v is None or tuple(v.shape) != shape \
                        or str(v.dtype) != dtype:
                    v = store[id(p)] = torch.empty(
                        shape, dtype=getattr(torch, dtype[6:]),
                        device=p.device)
                tensors.append(v)
            if host["gm"] and step.opt._gm_cnt is None:
                step.opt._gm_counter(dev)
            if host["gm"]:
                tensors.append(step.opt._gm_cnt)
            tensors.extend(step._scaler_state or ())
            if step._guard is not None and step._guard_state is not None:
                tensors.append(step._guard_state)
            for t in tensors:
                collective.broadcast(t, src, group)
                size += t.numel() * t.element_size()
        step._restore_host_counters(host["counters"])
        if host["lr"] is not None:
            inner._lr.set_state_dict(host["lr"])
        step._set_guard_host_state(host["guard"])
        return size

    @staticmethod
    def _has_rescue_target() -> bool:
        from ..utils import train_guard as _TG

        return _TG._rescue_target() is not None


def _broadcast_object(obj, src: int, group, device) -> Tuple[object, int]:
    """``obj`` from group rank ``src`` to every member (pickled bytes in
    two broadcasts: length, then payload); returns it and the bytes
    sent."""
    from . import collective

    if group.rank == src:
        data = pickle.dumps(obj)
        n = torch.tensor([len(data)], dtype=torch.int64, device=device)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=device)
    collective.broadcast(n, src, group)
    size = int(n.item())
    if group.rank == src:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    else:
        buf = torch.empty(size, dtype=torch.uint8, device=device)
    collective.broadcast(buf, src, group)
    if group.rank != src:
        obj = pickle.loads(buf.cpu().numpy().tobytes())
    return obj, size + 8
