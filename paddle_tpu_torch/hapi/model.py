"""paddle.Model, the high-level trainer (counterpart of
``paddle_tpu/hapi/model.py``; reference: python/paddle/hapi/model.py:
Model :810, prepare :1244, fit :1299, evaluate :1515, predict :1609,
train_batch/eval_batch/predict_batch :880-1040, save/load :1041-1200).

Training runs through the port's ``jit.TrainStep`` (with
``return_outputs`` when there are metrics, so the metrics read the
forward the loss used); evaluation and prediction run the network's
forward under ``no_grad`` in eval mode. Batches are ``Tensor`` on the
current device (a ``DataLoader`` puts them there; numpy inputs are
converted). ``save``/``load`` write and read ``.pdparams`` and ``.pdopt``
through ``framework.io``, so a checkpoint of the JAX package's ``Model``
resumes here.

Raised as in the JAX package: ``prepare(amp_configs=)`` (AMP comes from
``fleet``'s strategy) and ``train_batch(update=False)``.

Across trainers (the reference's ``prepare_distributed_context``, the JAX
package's ``hapi/model.py:91-120``): under a world of more than one
trainer, ``prepare`` wraps the network in ``DataParallel`` (the mesh's dp
group), and the batch engines give each rank its dp share of a batch whose
rows the dp degree divides, in every element but the scalars (other
batches, and ``predict``'s, run whole on every rank: one decision a batch,
which the loss mean and the metrics' gather follow). A rank holds only
its share, where the JAX package's arrays are global, so the
logged loss is the dp group's mean and the metrics read every rank's
outputs and labels, gathered over dp: the numbers of the whole batch, as
in the JAX package.

Departure: a metric with several names (``Accuracy(topk=(1, 5))`` names
``acc_top1`` and ``acc_top5``) logs one value under each name, as upstream
Paddle's ``_metrics_name`` does; the JAX package's ``fit`` and
``evaluate`` raise ``TypeError`` on it (a list used as a dict key).
Metrics with one name log as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..core.tensor import Tensor, wrap_like
from ..distributed import comm
from ..framework import io as fio
from ..io.dataloader import DataLoader
from ..io.dataset import Dataset
from ..jit.train_step import TrainStep
from ..jit.train_step import _as_list as _to_list
from ..metric import Metric
from ..nn.layer import Layer
from .callbacks import CallbackList, config_callbacks

__all__ = ["Model"]


def _numpy(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x).numpy()
    return np.asarray(x)


def _tensor(x) -> Tensor:
    """A batch element as ``Tensor`` (numpy: on the current device)."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    return Tensor(np.asarray(x))


class Model:
    """A high-level API over Layer + TrainStep + DataLoader (model.py:810).

    Usage (reference parity)::

        model = paddle.Model(network)
        model.prepare(optimizer, paddle.nn.CrossEntropyLoss(),
                      paddle.metric.Accuracy())
        model.fit(train_dataset, eval_dataset, batch_size=64, epochs=2)
        model.evaluate(eval_dataset)
        model.predict(test_dataset)
    """

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self._save_dir = None
        self._prepared = False
        self._dp_model = None

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """model.py:1244. ``loss`` is a Layer (e.g. CrossEntropyLoss()) or
        a callable; ``metrics`` paddle.metric instances."""
        self._optimizer = optimizer
        if loss is not None and not isinstance(loss, Layer) \
                and not callable(loss):
            raise TypeError("loss should be a Layer or a callable")
        self._loss = loss
        for m in _to_list(metrics):
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metric should be paddle.metric.Metric, got {type(m)}"
                )
        self._metrics = _to_list(metrics)
        if amp_configs is not None:
            raise NotImplementedError(
                "amp via Model.prepare: use fleet DistributedStrategy.amp "
                "(the TrainStep consumes it)"
            )
        # prepare_distributed_context (model.py:165): several trainers
        # train the network data-parallel
        from ..distributed.parallel import DataParallel

        if comm.is_initialized() and comm.get_world_size() > 1 \
                and not isinstance(self.network, DataParallel):
            self._dp_model = DataParallel(self.network)
        self._train_step = None
        self._prepared = True
        return self

    def _net(self):
        return self._dp_model if self._dp_model is not None else self.network

    def _dp(self):
        """The dp group batches shard over, or None."""
        g = self._dp_model.group if self._dp_model is not None else None
        return g if g is not None and g.nranks > 1 else None

    def _split(self, inputs, labels):
        """The batch's inputs and labels as ``Tensor``s, and the dp group
        they are sharded over: this rank's dp share of every element but
        the scalars when the dp degree divides all their rows, else the
        whole batch and None (the module's notes)."""
        ins = [_tensor(x) for x in _to_list(inputs)]
        lbls = [_tensor(y) for y in _to_list(labels)]
        g = self._dp()
        if g is None or any(t.ndim > 0 and t.shape[0] % g.nranks
                            for t in ins + lbls):
            return ins, lbls, None
        share = self._dp_model.shard_input
        return ([share(t) if t.ndim > 0 else t for t in ins],
                [share(t) if t.ndim > 0 else t for t in lbls], g)

    @staticmethod
    def _gather(xs, g):
        """``xs`` (this rank's rows of a batch sharded over ``g``)
        gathered back to the whole batch; left as they are when ``g`` is
        None."""
        from ..distributed import collective

        if g is None:
            return xs
        return [Tensor._wrap(collective.all_gather_(
            _tensor(x)._data, g).flatten(0, 1)) for x in xs]

    @staticmethod
    def _mean_loss(loss, g):
        """The loss of a batch sharded over ``g`` averaged over dp (the
        whole batch's mean for a mean-reduced loss)."""
        from ..distributed import collective

        if g is None:
            return loss
        t = _tensor(loss)._data.detach().float().reshape(1).clone()
        return collective.all_reduce_(t, collective.ReduceOp.AVG, g)[0]

    def _loss_fn(self, outs, *labels):
        if self._loss is None:
            # the network computes its own loss (model.py allows a
            # loss-less prepare when the outputs ARE the loss)
            return outs if not isinstance(outs, (list, tuple)) else outs[0]
        outs = _to_list(outs)
        return self._loss(*(outs + list(labels)))

    # -- the three batch engines (model.py:880-1040) -------------------------
    def train_batch(self, inputs, labels=None, update=True):
        if not self._prepared or self._optimizer is None:
            raise RuntimeError(
                "call model.prepare(optimizer, loss, ...) before training"
            )
        if not update:
            raise NotImplementedError(
                "update=False (gradient accumulation) rides through "
                "DistributedStrategy.gradient_merge instead"
            )
        if self._train_step is None:
            self._train_step = TrainStep(
                self._net(), self._loss_fn, self._optimizer,
                return_outputs=bool(self._metrics),
            )
        inputs, labels, g = self._split(inputs, labels)
        self.network.train()
        if self._metrics:
            # metrics come from the forward the loss used (the step's
            # loss is the dp group's mean already)
            loss, outs = self._train_step(inputs, labels)
            metrics = [float(loss.reshape(-1)[0])]
            metrics += self._update_metrics(
                self._gather(_to_list(wrap_like(outs)), g),
                self._gather(labels, g))
        else:
            loss = self._train_step(inputs, labels)
            metrics = [float(loss.reshape(-1)[0])]
        return metrics if len(metrics) > 1 else metrics[0]

    def _update_metrics(self, outs, labels):
        vals = []
        outs = _to_list(outs)
        labels = [_tensor(y) for y in labels]
        for m in self._metrics:
            state = m.compute(*(outs + labels))
            m.update(*_to_list(state))
            vals.append(m.accumulate())
        return vals

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels, g = self._split(inputs, labels)
        with torch.no_grad():
            outs = self._net()(*inputs)
            loss = self._mean_loss(self._loss_fn(outs, *labels), g)
        metrics = [float(_numpy(loss).reshape(-1)[0])]
        metrics += self._update_metrics(
            self._gather(_to_list(outs), g), self._gather(labels, g))
        return metrics if len(metrics) > 1 else metrics[0]

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outs = self._net()(*[_tensor(x) for x in _to_list(inputs)])
        return [_numpy(o) for o in _to_list(outs)]

    # -- loops ---------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers, drop_last):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(
                data, batch_size=batch_size, shuffle=shuffle,
                num_workers=num_workers, drop_last=drop_last,
            )
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, num_iters=None):
        """model.py:1299."""
        loader = self._loader(
            train_data, batch_size, shuffle, num_workers, drop_last
        )
        eval_loader = self._loader(
            eval_data, batch_size, False, num_workers, False
        )
        self._save_dir = save_dir
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=self._metrics_name(),
        )
        self.stop_training = False
        cbks.on_train_begin()
        done_iters = 0
        logs = {}
        try:
            for epoch in range(epochs):
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    ins, labs = self._split_batch(batch)
                    vals = _to_list(self.train_batch(ins, labs))
                    logs = self._logs(vals)
                    cbks.on_train_batch_end(step, logs)
                    done_iters += 1
                    if num_iters is not None and done_iters >= num_iters:
                        self.stop_training = True
                        break
                cbks.on_epoch_end(epoch, logs)
                # a stopping run skips the final eval pass
                if eval_loader is not None \
                        and (epoch + 1) % eval_freq == 0 \
                        and not self.stop_training:
                    self.evaluate(
                        eval_loader, batch_size=batch_size,
                        log_freq=log_freq, verbose=verbose, callbacks=cbks,
                    )
                if self.stop_training:
                    break
        finally:
            # guaranteed even when training raises
            cbks.on_train_end(logs)

    def _split_batch(self, batch):
        batch = _to_list(batch)
        n_in = max(len(self._inputs), 1)
        if len(batch) == 1:
            return batch, []
        return batch[:n_in], batch[n_in:]

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            names.extend(_to_list(m.name()))
        return names

    def _logs(self, vals):
        flat = []
        for v in vals:
            flat.extend(_to_list(v))
        return dict(zip(self._metrics_name(), flat))

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        """model.py:1515. Returns {metric_name: value}."""
        loader = self._loader(eval_data, batch_size, False, num_workers,
                              False)
        own_cbks = not isinstance(callbacks, CallbackList)
        cbks = callbacks if not own_cbks else config_callbacks(
            callbacks, model=self, batch_size=batch_size, verbose=verbose,
            log_freq=log_freq, metrics=self._metrics_name(),
        )
        for m in self._metrics:
            m.reset()
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks.on_eval_begin({"steps": steps})
        logs, losses = {}, []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            vals = _to_list(self.eval_batch(ins, labs))
            losses.append(vals[0])
            logs = self._logs([float(np.mean(losses))] + vals[1:])
            cbks.on_eval_batch_end(step, logs)
            if num_iters is not None and step + 1 >= num_iters:
                break
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """model.py:1609. Returns per-output lists of batch arrays (or
        concatenated when stack_outputs)."""
        loader = self._loader(test_data, batch_size, False, num_workers,
                              False)
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, verbose=verbose,
            metrics=[],
        )
        cbks.on_predict_begin()
        outputs = None
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins, _ = self._split_batch(batch)
            outs = self.predict_batch(ins)
            if outputs is None:
                outputs = [[] for _ in outs]
            for slot, o in zip(outputs, outs):
                slot.append(o)
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        if outputs is None:
            return []
        if stack_outputs:
            outputs = [np.concatenate(slot, axis=0) for slot in outputs]
        return outputs

    # -- persistence (model.py:1041 save / :1135 load) -----------------------
    def save(self, path, training=True):
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            opt = getattr(self._optimizer, "_inner", self._optimizer)
            fio.save(opt.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = fio.load(path + ".pdparams", return_numpy=True)
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            opt = getattr(self._optimizer, "_inner", self._optimizer)
            opt.set_state_dict(fio.load(opt_path, return_numpy=True))

    # -- misc ----------------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        if input_size is None and not self._inputs:
            raise ValueError("summary needs input_size or Model inputs spec")
        if input_size is None:
            input_size = [tuple(s.shape) for s in self._inputs]
        return summary(self.network, input_size, dtypes=dtype)
