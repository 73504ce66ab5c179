"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``;
reference: python/paddle/hapi/callbacks.py: Callback :117, CallbackList
:23, ProgBarLogger :313, ModelCheckpoint :503, LRScheduler :583,
EarlyStopping :653). ``VisualDL`` is the in-memory scalar sink of the JAX
package (tag -> [(step, value)]).

``TerminateOnPreempt`` is the hapi face of the preemption notice
(``distributed.elastic``); ``GuardCallback`` the numerical guard's hapi
policy (``utils/train_guard.py``).
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
    """Preemption-notice handler: the hapi face of the elastic runtime.

    On SIGTERM (the cloud's eviction warning): finish the batch and the
    epoch in flight, save a ``save_dir/preempt`` checkpoint and stop
    training. Touches the rank's heartbeat
    (``distributed.elastic.heartbeat``) every batch, so the launcher's
    hung-rank watchdog sees a live trainer between epochs. With
    ``verbose``, it dumps the collective flight recorder
    (``distributed.comm_monitor.dump_flight_recorder("preempt")``: the
    rank's ``comm_dump.rank{r}.json`` under ``PADDLE_COLL_DEBUG_DIR``) and
    prints its path, so the hapi log names the collective stream.
    """

    def __init__(self, save_dir=None, verbose=1):
        super().__init__()
        self.save_dir = save_dir
        self.verbose = verbose
        self.preempted = False
        self._old_handler = None

    def _on_notice(self):
        self.preempted = True

    def on_train_begin(self, logs=None):
        from ..distributed.elastic import install_preempt_notice

        self.preempted = False
        self._old_handler = install_preempt_notice(self._on_notice)

    def on_train_batch_end(self, step, logs=None):
        from ..distributed.elastic import heartbeat

        heartbeat()
        if self.preempted:
            self.model.stop_training = True

    def on_epoch_end(self, epoch, logs=None):
        if not self.preempted:
            return
        self.model.stop_training = True
        save_dir = self.save_dir or getattr(self.model, "_save_dir", None)
        if save_dir:
            path = os.path.join(save_dir, "preempt")
            self.model.save(path)
            if self.verbose:
                print(f"TerminateOnPreempt: SIGTERM received — saved "
                      f"{path}, stopping after epoch {epoch}")
        if self.verbose:
            from ..distributed import comm_monitor

            dump = comm_monitor.dump_flight_recorder("preempt")
            if dump:
                print(f"TerminateOnPreempt: collective flight recorder "
                      f"at {dump}")

    def on_train_end(self, logs=None):
        from ..distributed.elastic import restore_preempt_notice

        restore_preempt_notice(self._old_handler)
        self._old_handler = None


class GuardCallback(Callback):
    """The numerical guard's hapi policy (``utils/train_guard.py``), on
    the per-batch loss the fit loop already read to the host (so it costs
    nothing more). ``Model.fit`` trains through ``jit.TrainStep``, whose
    in-step guard masks bad steps already; on top of it:

    - a nonfinite logged loss, or with ``spike_factor`` > 0 a finite loss
      above ``spike_factor x EWMA``, counts as a bad batch;
    - every healthy epoch end writes a ``save_dir/guard_last_good``
      snapshot (``Model.save``);
    - past ``max_skips`` consecutive bad batches it restores that snapshot
      (``Model.load``) when there is one, else stops training, emitting a
      ``guard_rollback`` / ``guard_stop`` event either way
      (``PADDLE_GUARD_EVENT_FILE`` and the telemetry bus).
    """

    def __init__(self, max_skips=None, save_dir=None, spike_factor=None,
                 ewma_decay=0.9, warmup=20, verbose=1):
        super().__init__()
        from ..utils import train_guard as tg

        self.max_skips = (max_skips if max_skips is not None
                          else tg._envi(tg._MAX_SKIPS_ENV, 8))
        self.spike_factor = (spike_factor if spike_factor is not None
                             else tg._envf(tg._SPIKE_ENV, 0.0))
        self.save_dir = save_dir
        self.ewma_decay = float(ewma_decay)
        self.warmup = int(warmup)
        self.verbose = verbose
        self._reset()

    def _reset(self):
        self.consec = 0
        self.total_bad = 0
        self.rollbacks = 0
        self._ewma = None
        self._healthy = 0
        self._anchor = None

    def _loss_of(self, logs):
        v = (logs or {}).get("loss")
        if isinstance(v, (list, tuple, np.ndarray)):
            v = np.asarray(v).reshape(-1)[0]
        return None if v is None else float(v)

    def on_train_begin(self, logs=None):
        self._reset()

    def on_train_batch_end(self, step, logs=None):
        from ..utils import train_guard as tg

        loss = self._loss_of(logs)
        if loss is None:
            return
        bad = not np.isfinite(loss)
        spiked = (not bad and self.spike_factor > 0.0
                  and self._healthy >= self.warmup
                  and self._ewma is not None
                  and loss > self.spike_factor * abs(self._ewma))
        if bad or spiked:
            self.consec += 1
            self.total_bad += 1
            tg.emit_event(
                "guard_skip", step=step, consec=self.consec,
                loss=loss if np.isfinite(loss) else None,
                detail=f"hapi batch {step}: "
                       + ("loss nonfinite" if bad else
                          f"loss spike {loss:.6g} > "
                          f"{self.spike_factor:g}x ewma {self._ewma:.6g}"))
            if self.consec >= self.max_skips:
                self._rescue(step)
            return
        self.consec = 0
        self._healthy += 1
        self._ewma = (loss if self._ewma is None
                      else self.ewma_decay * self._ewma
                      + (1.0 - self.ewma_decay) * loss)

    def _rescue(self, step):
        from ..utils import train_guard as tg

        detail = (f"hapi divergence: {self.consec} consecutive bad "
                  f"batches (budget {self.max_skips})")
        if self._anchor:
            self.model.load(self._anchor)
            self.rollbacks += 1
            self.consec = 0
            tg.emit_event("guard_rollback", step=step, anchor=self._anchor,
                          detail=detail)
            if self.verbose:
                print(f"GuardCallback: {detail}; restored {self._anchor}")
        else:
            self.model.stop_training = True
            tg.emit_event("guard_stop", step=step, detail=detail)
            if self.verbose:
                print(f"GuardCallback: {detail}; no last-good snapshot — "
                      "stopping training")

    def on_epoch_end(self, epoch, logs=None):
        save_dir = self.save_dir or getattr(self.model, "_save_dir", None)
        if save_dir and self.consec == 0:
            path = os.path.join(save_dir, "guard_last_good")
            self.model.save(path)
            self._anchor = path


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
