"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``;
reference: python/paddle/hapi/callbacks.py: Callback :117, CallbackList
:23, ProgBarLogger :313, ModelCheckpoint :503, LRScheduler :583,
EarlyStopping :653). ``VisualDL`` is the in-memory scalar sink of the JAX
package (tag -> [(step, value)]).

``TerminateOnPreempt`` and ``GuardCallback`` raise ``NotImplementedError``
when made: the first needs ``distributed.elastic`` (ROADMAP queue A item
7), the second the guard's host half (item 8).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

__all__ = [
    "Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
    "EarlyStopping", "VisualDL", "TerminateOnPreempt", "GuardCallback",
]


class Callback:
    """reference callbacks.py:117. Every hook is optional."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None,
                     mode="train"):
    """callbacks.py:23 config_callbacks: user callbacks + defaults."""
    if isinstance(callbacks, Callback):
        callbacks = [callbacks]
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if model is not None and not any(
        isinstance(c, LRScheduler) for c in cbks
    ):
        cbks.append(LRScheduler())
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    cbk_list.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"],
    })
    return cbk_list


class ProgBarLogger(Callback):
    """Per-epoch progress logging (callbacks.py:313). verbose 0 silent,
    1 epoch summaries, 2 per-log_freq step lines."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def _fmt(self, logs):
        out = []
        for k in self.params.get("metrics", []):
            if k in (logs or {}):
                v = logs[k]
                if isinstance(v, (list, tuple, np.ndarray)):
                    v = np.asarray(v).reshape(-1)
                    out.append(f"{k}: " + "/".join(f"{x:.4f}" for x in v))
                else:
                    out.append(f"{k}: {v:.4f}")
        return " - ".join(out)

    def on_train_begin(self, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            total = self.steps if self.steps is not None else "?"
            print(f"step {step + 1}/{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} - {self._fmt(logs)}")

    def on_eval_begin(self, logs=None):
        if self.verbose:
            n = (logs or {}).get("steps")
            print(f"Eval begin ({n} steps)" if n else "Eval begin")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Save every `save_freq` epochs + final (callbacks.py:503)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Step the optimizer's LRScheduler (callbacks.py:583): per epoch by
    default, or per `by_step` batches."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None) if opt else None
        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop when `monitor` stops improving (callbacks.py:653)."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0

    def _better(self, cur, ref):
        d = self.min_delta if self.mode == "max" else -self.min_delta
        return cur > ref + d if self.mode == "max" else cur < ref + d

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.asarray(cur).reshape(-1)[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(
                self.model, "_save_dir", None
            ):
                self.model.save(
                    os.path.join(self.model._save_dir, "best_model")
                )
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(
                        f"Early stopping: {self.monitor} did not improve "
                        f"for {self.wait} evals (best {self.best:.5f})"
                    )


class TerminateOnPreempt(Callback):
    """Preemption-notice handler: the hapi face of the elastic runtime
    (SIGTERM: finish the epoch, save ``save_dir/preempt``, stop). Not
    ported: it needs ``distributed.elastic``, ROADMAP queue A item 7."""

    def __init__(self, save_dir=None, verbose=1):
        raise NotImplementedError(
            "TerminateOnPreempt needs distributed.elastic (its SIGTERM "
            "notice and heartbeat), which the port does not have yet: "
            "ROADMAP queue A item 7")


class GuardCallback(Callback):
    """The numerical guard's hapi policy (bad-batch budget, last-good
    snapshot, rollback). Not ported: it needs the guard's host half,
    ROADMAP queue A item 8; the in-step guard of ``TrainStep`` runs
    without it."""

    def __init__(self, max_skips=None, save_dir=None, spike_factor=None,
                 ewma_decay=0.9, warmup=20, verbose=1):
        raise NotImplementedError(
            "GuardCallback needs the guard's host half (spike detection, "
            "events, rollback), which the port does not have yet: ROADMAP "
            "queue A item 8")


class VisualDL(Callback):
    """Metrics sink: records scalars into an in-memory dict (the VisualDL
    dashboard writer is a GUI dependency; the log structure, tag ->
    [(step, value)], is what its add_scalar would receive)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self.scalars = {}
        self._step = 0

    def _record(self, prefix, logs):
        for k, v in (logs or {}).items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                self.scalars.setdefault(f"{prefix}/{k}", []).append(
                    (self._step, float(v))
                )

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._record("train", logs)

    def on_eval_end(self, logs=None):
        self._record("eval", logs)
