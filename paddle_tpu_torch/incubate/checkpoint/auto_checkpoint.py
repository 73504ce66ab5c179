"""Auto-checkpoint: an epoch range that survives preemption (counterpart
of ``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``; reference:
python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py:
``AutoCheckpointChecker`` (:71) reads the job id from the environment,
``TrainEpochRange`` (:265) yields epoch indices, snapshots state at each
epoch and resumes from the last snapshot when a restarted job enters the
range again, ``train_epoch_range`` (:598)).

State is the registered Layers' and optimizers' ``state_dict`` saved
through ``framework.io`` (atomic, fsync'd), under
``PADDLE_CHECKPOINT_DIR/<PADDLE_JOB_ID>/<name>``. Only trainer 0 writes;
every trainer restores. The integrity layer is the JAX package's:

- snapshots are epoch-numbered generations (``snap_00000002/``), each
  built in a temp directory and committed by one rename; the newest
  ``PADDLE_CHECKPOINT_KEEP`` (default 2) are kept;
- each generation's ``meta.json`` records a CRC32 per file; ``restore()``
  verifies them and falls back to the previous generation when a file is
  torn or corrupt, after retrying an ``OSError`` with backoff;
- on SIGTERM (the preemption notice) the range snapshots at the end of
  the epoch in flight and exits 143;
- each epoch touches the rank's heartbeat (``distributed.elastic``) and
  crosses the ``epoch`` fault point; each save crosses ``acp.save``;
- registered extras (``register(scaler=...)``: a ``jit.TrainStep``,
  anything with ``state_dict`` and ``set_state_dict`` or
  ``load_state_dict``) ride each generation as ``extra_*.pdextra``,
  carrying the loss scaler's state and the guard's counters;
- the range registers itself as the numerical guard's rescue target
  (``utils/train_guard.py``) and withholds a snapshot while a divergence
  streak is active, so the generation a rollback restores predates it.

Restores read the files as numpy and copy them into the registered
objects' tensors, on their devices.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

__all__ = ["TrainEpochRange", "train_epoch_range", "CheckpointCorruptError"]

_CHECKPOINT_ENV = "PADDLE_CHECKPOINT_DIR"
_JOB_ENV = "PADDLE_JOB_ID"
_KEEP_ENV = "PADDLE_CHECKPOINT_KEEP"
_SNAP_PREFIX = "snap_"
_PREEMPT_RC = 143


class CheckpointCorruptError(RuntimeError):
    """A snapshot file failed its CRC32 or parse check (not transient:
    ``restore()`` falls back to the previous generation instead of
    retrying)."""


class TrainEpochRange:
    """Resumable epoch range::

        r = TrainEpochRange(10, name="run1")
        r.register(model=model, optimizer=opt, scaler=step)
        for epoch in r.get():       # resumes mid-range after a restart
            train_one_epoch(...)
    """

    def __init__(self, max_epoch_num: int, name: str = "acp",
                 checkpoint_path: Optional[str] = None,
                 save_checkpoint_inter: int = 1,
                 keep_checkpoints: Optional[int] = None,
                 io_retries: int = 3):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name
        root = checkpoint_path or os.environ.get(
            _CHECKPOINT_ENV, os.path.join(tempfile.gettempdir(),
                                          "paddle_tpu_torch_auto_checkpoint"))
        job = os.environ.get(_JOB_ENV, "default_job")
        self._dir = os.path.join(root, job, name)
        self._inter = max(int(save_checkpoint_inter), 1)
        self._keep = max(int(keep_checkpoints
                             if keep_checkpoints is not None
                             else os.environ.get(_KEEP_ENV, "2")), 1)
        self._io_retries = max(int(io_retries), 1)
        self._models: List = []
        self._opts: List = []
        self._extras: List = []
        self._restored_epoch = -1
        self._preempted = False

    # -- what a generation holds -------------------------------------------
    def register(self, model=None, optimizer=None, scaler=None,
                 extras=None):
        """Register state to snapshot each generation. ``scaler`` and
        ``extras`` take anything with ``state_dict()`` and
        ``set_state_dict()`` (or ``load_state_dict()``): an
        ``amp.GradScaler``, a ``jit.TrainStep`` (its loss scaler's state
        and its guard's counters). Their files are optional on restore, so
        a snapshot taken before an extra was registered still serves."""
        if model is not None:
            self._models.append(model)
        if optimizer is not None:
            self._opts.append(optimizer)
        for x in ([scaler] if scaler is not None else []) + list(
                extras if extras is not None else []):
            if not hasattr(x, "state_dict"):
                raise TypeError(
                    f"extra state object {type(x).__name__} has no "
                    "state_dict()")
            self._extras.append(x)
        return self

    @staticmethod
    def _load_extra(obj, state):
        setter = getattr(obj, "set_state_dict", None) \
            or getattr(obj, "load_state_dict", None)
        if setter is not None:
            setter(state)

    # -- persistence -------------------------------------------------------
    def _state_files(self, with_extras: bool = False):
        names = [f"model_{i}.pdparams" for i in range(len(self._models))]
        names += [f"opt_{i}.pdopt" for i in range(len(self._opts))]
        if with_extras:
            names += [f"extra_{i}.pdextra"
                      for i in range(len(self._extras))]
        return names

    def _snap_path(self, epoch: int) -> str:
        return os.path.join(self._dir, f"{_SNAP_PREFIX}{epoch:08d}")

    def _snapshots(self):
        """(epoch, path) of the committed generations, newest first."""
        try:
            entries = os.listdir(self._dir)
        except OSError:
            return []
        out = []
        for e in entries:
            if e.startswith(_SNAP_PREFIX):
                try:
                    out.append((int(e[len(_SNAP_PREFIX):]),
                                os.path.join(self._dir, e)))
                except ValueError:
                    continue
        return sorted(out, reverse=True)

    def _save(self, epoch: int):
        from ...distributed import comm
        from ...framework import io as fio
        from ...utils.fault_injection import fault_point

        # every rank takes the models' state (a ZeRO stage-3 parameter is
        # gathered to its logical shape, a collective); one writer per job
        states = [m.state_dict() for m in self._models]
        states += [getattr(o, "_inner", o).state_dict() for o in self._opts]
        states += [x.state_dict() for x in self._extras]
        if comm.get_rank() != 0:
            return
        fault_point("acp.save")
        os.makedirs(self._dir, exist_ok=True)
        tmp = os.path.join(self._dir, f".tmp_{_SNAP_PREFIX}{epoch:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        crcs = {}
        for fname, state in zip(self._state_files(with_extras=True),
                                states):
            fpath = os.path.join(tmp, fname)
            fio.save(state, fpath)
            crcs[fname] = fio.crc32_file(fpath)
        del states
        meta = {"epoch": epoch, "name": self.name,
                "max_epoch_num": self.max_epoch_num, "files": crcs,
                "extras": [type(x).__name__ for x in self._extras]}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._snap_path(epoch)
        shutil.rmtree(final, ignore_errors=True)
        # the rename is the commit point: readers only ever see complete
        # generations
        os.rename(tmp, final)
        self._prune()

    def _prune(self):
        for _, path in self._snapshots()[self._keep:]:
            shutil.rmtree(path, ignore_errors=True)
        try:
            for e in os.listdir(self._dir):
                if e.startswith(f".tmp_{_SNAP_PREFIX}"):
                    shutil.rmtree(os.path.join(self._dir, e),
                                  ignore_errors=True)
        except OSError:
            pass

    # -- restore, with the integrity checks --------------------------------
    def _read_snapshot(self, snap_dir: str):
        """Verify the CRCs, then load every state tree into host memory
        (the caller applies them, so a half-read snapshot never leaves a
        model half changed). Raises CheckpointCorruptError on a checksum
        or parse failure, OSError on (maybe transient) I/O."""
        from ...framework import io as fio

        with open(os.path.join(snap_dir, "meta.json")) as f:
            try:
                meta = json.load(f)
            except ValueError as e:
                raise CheckpointCorruptError(
                    f"unparseable meta.json in {snap_dir}: {e}") from e
        # a registry/snapshot mismatch is deterministic: fall back at once
        for fname in self._state_files():
            if not os.path.exists(os.path.join(snap_dir, fname)):
                raise CheckpointCorruptError(
                    f"snapshot file missing: {os.path.join(snap_dir, fname)}")
        for fname, want in meta.get("files", {}).items():
            fpath = os.path.join(snap_dir, fname)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"snapshot file missing: {fpath}")
            got = fio.crc32_file(fpath)
            if got != want:
                raise CheckpointCorruptError(
                    f"CRC mismatch for {fpath}: "
                    f"recorded {want:#010x}, found {got:#010x}")
        names = self._state_files() + [
            f"extra_{i}.pdextra" for i in range(len(self._extras))]
        states = []
        for i, fname in enumerate(names):
            fpath = os.path.join(snap_dir, fname)
            if i >= len(self._state_files()) and not os.path.exists(fpath):
                states.append(None)   # an extra registered after the save
                continue
            try:
                states.append(fio.load(fpath, return_numpy=True))
            except OSError:
                raise
            except Exception as e:  # a torn pickle that passed no CRC
                raise CheckpointCorruptError(
                    f"unreadable snapshot file {fname} in {snap_dir}: {e}"
                ) from e
        return meta, states

    def _read_with_retry(self, snap_dir: str):
        delay = 0.05
        last = None
        for attempt in range(self._io_retries):
            try:
                return self._read_snapshot(snap_dir)
            except CheckpointCorruptError:
                raise  # deterministic: fall back, do not retry
            except OSError as e:
                last = e
                if attempt + 1 < self._io_retries:
                    time.sleep(delay)
                    delay *= 2
        raise last

    def restore(self) -> int:
        """Load the newest verifiable snapshot; returns the next epoch to
        run (0 without a usable one). A corrupt generation is skipped with
        a warning and the previous one serves. A flat layout from before
        generations (``meta.json`` directly in the job directory, no CRCs)
        is the last resort."""
        candidates = list(self._snapshots())
        if os.path.exists(os.path.join(self._dir, "meta.json")):
            candidates.append((-1, self._dir))
        for _, snap in candidates:
            try:
                meta, states = self._read_with_retry(snap)
            except (CheckpointCorruptError, OSError) as e:
                print(f"paddle_tpu_torch.auto_checkpoint: snapshot {snap} "
                      f"unusable ({e}); falling back to previous",
                      file=sys.stderr, flush=True)
                continue
            n_models, n_opts = len(self._models), len(self._opts)
            for m, state in zip(self._models, states[:n_models]):
                m.set_state_dict(state)
            for o, state in zip(self._opts,
                                states[n_models:n_models + n_opts]):
                getattr(o, "_inner", o).set_state_dict(state)
            for x, state in zip(self._extras, states[n_models + n_opts:]):
                if state is not None:
                    self._load_extra(x, state)
            self._restored_epoch = int(meta["epoch"])
            return self._restored_epoch + 1
        return 0

    # -- the epoch range ---------------------------------------------------
    def _on_notice(self):
        self._preempted = True

    def _save_unless_diverging(self, epoch: int, what: str) -> None:
        from ...utils import train_guard

        if train_guard.divergence_active():
            print(f"paddle_tpu_torch.auto_checkpoint: {what} of epoch "
                  f"{epoch} withheld (the numerical guard reports an active "
                  "divergence streak)", file=sys.stderr, flush=True)
        else:
            self._save(epoch)

    def get(self):
        from ...distributed.elastic import (
            heartbeat, install_preempt_notice, restore_preempt_notice,
        )
        from ...utils import train_guard
        from ...utils.fault_injection import fault_point

        start = self.restore()
        old_term = install_preempt_notice(self._on_notice)
        # past PADDLE_GUARD_MAX_SKIPS consecutive bad steps the guard
        # restores the last verified generation through restore()
        train_guard.set_rescue_target(self)
        try:
            for epoch in range(start, self.max_epoch_num):
                fault_point("epoch")
                heartbeat()
                yield epoch
                last = epoch + 1 == self.max_epoch_num
                if self._preempted:
                    # the notice costs no epoch: snapshot the one just
                    # finished, then exit with the SIGTERM code (unless it
                    # was the last: the run simply completed). A notice
                    # mid-streak withholds the snapshot like a periodic
                    # save.
                    self._save_unless_diverging(epoch, "preemption snapshot")
                    if last:
                        break
                    raise SystemExit(_PREEMPT_RC)
                if (epoch + 1) % self._inter == 0 or last:
                    self._save_unless_diverging(epoch, "snapshot")
        finally:
            train_guard.set_rescue_target(None)
            restore_preempt_notice(old_term)


@contextlib.contextmanager
def train_epoch_range(max_epoch_num, name="acp", checkpoint_path=None,
                      save_checkpoint_inter=1):
    """The context-manager facade (auto_checkpoint.py:598)."""
    yield TrainEpochRange(
        max_epoch_num, name=name, checkpoint_path=checkpoint_path,
        save_checkpoint_inter=save_checkpoint_inter,
    )
