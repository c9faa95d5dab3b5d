"""High-level Model API (counterpart of paddle_tpu/hapi/model.py, the
reference's python/paddle/hapi/model.py).

Model.prepare / fit / evaluate / predict / train_batch / eval_batch /
save / load / summary. Training always goes through static.TrainStep
(amp_configs, mesh= and sharding_plan= pass to it), so on the card each
input signature is one captured CUDA graph: a bucketed loader
(io.BucketBatchSampler) gives one program a bucket. Evaluation and
prediction run the network eagerly in eval mode under no_grad. The
layer holds the step's live parameters (TrainStep updates them in
place), so nothing is synced back before an eval; under ZeRO-3 and fsdp
they are this rank's shards, which the step gathers for an eval
forward. save and load go through the step's state_dict and
set_state_dict when there is one: whole tensors, the optimizer's state
included, cut back to this rank's blocks on load.

Batches come from an io.DataLoader (a Dataset is wrapped in one): the
inputs= specs (jit.InputSpec) say how many leading items of a batch are
inputs, the rest are labels. A multi-output forward (YOLOv3's three
heads) is unpacked into the loss and the metrics: loss(*outputs,
*labels).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .. import serialization
from ..io import DataLoader
from ..metric import Metric
from ..static.train_step import TrainStep
from .callbacks import config_callbacks

__all__ = ["Model"]


def _as_tensors(items, device):
    """Numpy arrays and numbers among `items` as tensors on `device`;
    tensors pass."""
    out = []
    for a in items:
        if isinstance(a, np.ndarray) or isinstance(a, (np.number, float,
                                                       int)):
            a = torch.as_tensor(np.asarray(a)).to(device)
        out.append(a)
    return tuple(out)


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self.stop_training = False

    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None, sharding_plan=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        amp_level = None
        if isinstance(amp_configs, str):
            amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            amp_level = amp_configs.get("level")
        if optimizer is not None and loss is not None:
            loss_fn = loss if callable(loss) else None

            def apply_loss(out, *lbls):
                if isinstance(out, (list, tuple)):
                    return loss_fn(*out, *lbls)
                return loss_fn(out, *lbls)
            self._train_step = TrainStep(
                self.network, apply_loss, optimizer, amp_level=amp_level,
                mesh=mesh, sharding_plan=sharding_plan)
        return self

    # -- loops ---------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, drop_last=False,
                num_workers=0):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers,
                          places=self._device())

    def _split_batch(self, batch):
        """Split a loader batch into (inputs, labels) by the Model's
        inputs=/labels= specs: the declared input count first (fit,
        evaluate and a label-free predict batch), the declared label
        count when only labels are given, else one trailing label."""
        if not isinstance(batch, (list, tuple)):
            return (batch,), ()
        items = list(batch)
        if self._inputs is not None:
            ins = self._inputs
            n_in = len(ins) if isinstance(ins, (list, tuple)) else 1
            return tuple(items[:n_in]), tuple(items[n_in:])
        n_labels = 1
        if self._labels is not None:
            ls = self._labels
            n_labels = len(ls) if isinstance(ls, (list, tuple)) else 1
        inputs = items[:-n_labels] if len(items) > n_labels else items[:1]
        return tuple(inputs), tuple(items[len(inputs):])

    def train_batch(self, inputs, labels=None):
        """One TrainStep on the batch; returns [loss] (a host float: one
        read of the card a step)."""
        dev = self._device()
        loss = self._train_step(_as_tensors(inputs, dev),
                                _as_tensors(labels or (), dev))
        return [float(loss.item())]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        dev = self._device()
        inputs = _as_tensors(inputs, dev)
        labels = _as_tensors(labels or (), dev)
        training = self.network.training
        self.network.eval()
        try:
            out = self.network(*inputs)
            outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            metrics = []
            for m in self._metrics:
                m.update(m.compute(*outs, *labels))
                metrics.append(m.accumulate())
            loss = None
            if self._loss is not None and labels:
                loss = float(self._loss(*outs, *labels).item())
            return loss, metrics
        finally:
            self.network.train(training)

    @torch.no_grad()
    def predict_batch(self, inputs):
        training = self.network.training
        self.network.eval()
        try:
            return self.network(*_as_tensors(inputs, self._device()))
        finally:
            self.network.train(training)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        assert self._train_step is not None, "call prepare() first"
        loader = self._loader(train_data, batch_size, shuffle, drop_last,
                              num_workers)
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=len(loader) if hasattr(
                                    loader, "__len__") else None,
                                log_freq=log_freq, verbose=verbose,
                                save_dir=save_dir)
        cbks.on_begin("train")
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            if hasattr(loader, "batch_sampler") and hasattr(
                    loader.batch_sampler, "set_epoch"):
                loader.batch_sampler.set_epoch(epoch)
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_batch_begin("train", step, logs)
                inputs, labels = self._split_batch(batch)
                (loss_v,) = self.train_batch(inputs, labels)
                logs = {"loss": [loss_v], "step": step}
                cbks.on_batch_end("train", step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            lr = getattr(self._optimizer, "_lr", None)
            if hasattr(lr, "step"):
                try:
                    lr.step()
                except TypeError:
                    pass
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, False,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = self._split_batch(batch)
            loss, _ = self.eval_batch(inputs, labels)
            if loss is not None:
                losses.append(loss)
        logs = {}
        if losses:
            logs["loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            name = m.name()
            res = m.accumulate()
            if isinstance(name, list):
                for n, r in zip(name, res):
                    logs[n] = r
            else:
                logs[name] = res
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, False,
                              num_workers=num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            out = self.predict_batch(inputs)
            outputs.append(_to_numpy(out) if isinstance(out, torch.Tensor)
                           else [_to_numpy(o) for o in out])
        if stack_outputs and outputs and isinstance(outputs[0], np.ndarray):
            return [np.concatenate(outputs, 0)]
        return [outputs]

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        if self._train_step is not None:
            state = self._train_step.state_dict()
            model, opt = state["model"], state["opt"]
        else:
            model = self.network.state_dict()
            opt = self._optimizer.state_dict() \
                if self._optimizer is not None else None
        serialization.save(model, path + ".pdparams")
        if training and opt is not None:
            serialization.save(opt, path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Weights (and the optimizer's state unless reset_optimizer) from
        `path`, written into the live tensors in place, so a captured
        step goes on reading them."""
        model = serialization.load(path + ".pdparams")
        opt = None
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt = serialization.load(path + ".pdopt")
        if self._train_step is not None:
            self._train_step.set_state_dict({"model": model, "opt": opt})
            return self
        self.network.set_state_dict(model)
        if opt is not None:
            self._optimizer.set_state_dict(opt)
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtype)
