"""Training callbacks (counterpart of paddle_tpu/hapi/callbacks.py, the
reference's python/paddle/hapi/callbacks.py). MetricsLogger streams
through the port's observability.metrics registry and exporters."""
from __future__ import annotations

import os
import time

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "MetricsLogger", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and step % self.log_freq == 0:
            loss = logs.get("loss", ["?"])[0] if logs else "?"
            loss_s = f"{loss:.4f}" if isinstance(loss, float) else loss
            print(f"Epoch {self.epoch} step {step}: loss={loss_s}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            extras = {k: v for k, v in (logs or {}).items()
                      if k not in ("step",)}
            print(f"Epoch {epoch} done in {dt:.1f}s: {extras}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None and \
                epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class MetricsLogger(Callback):
    """Stream training telemetry through the observability runtime.

    Turns the metrics registry on for the duration of fit(), publishes
    per-batch gauges/counters (train.loss, train.batches_total,
    throughput.examples_per_sec when batch_size is known), and exports:

      jsonl_path  one JSONL snapshot record every `log_freq` batches
                  and at train end (exporters.JsonlExporter)
      prom_path   a Prometheus text dump rewritten every `log_freq`
                  batches (point a node_exporter textfile collector or
                  a sidecar scrape at it) and at train end

    ProgBarLogger shows a human the loss; this shows the fleet.
    Fleet-level rollups are the reader's job (observability.fleet).
    """

    def __init__(self, log_freq=10, jsonl_path=None, prom_path=None,
                 batch_size=None, enable_metrics=True):
        super().__init__()
        self.log_freq = max(int(log_freq), 1)
        self.jsonl_path = jsonl_path
        self.prom_path = prom_path
        self.batch_size = batch_size
        self.enable_metrics = enable_metrics
        self._jsonl = None
        self._was_enabled = None
        self._batches = 0
        self._t_last = None

    def on_train_begin(self, logs=None):
        from ..observability import exporters, metrics
        if self.enable_metrics:
            self._was_enabled = metrics.enabled()
            metrics.enable()
        if self.jsonl_path:
            self._jsonl = exporters.JsonlExporter(self.jsonl_path)
        self._batches = 0
        self._t_last = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        from ..observability import metrics
        self._batches += 1
        # per-batch path: gate before any instrument lookup (the
        # registry would no-op anyway, but the name and label work runs
        # first)
        if metrics._enabled:
            metrics.counter("train.batches_total").add(1)
            loss = (logs or {}).get("loss")
            if isinstance(loss, (list, tuple)) and loss:
                loss = loss[0]
            if isinstance(loss, (int, float)):
                metrics.gauge("train.loss").set(round(float(loss), 6))
            now = time.perf_counter()
            if self.batch_size and self._t_last is not None \
                    and now > self._t_last:
                metrics.gauge("throughput.examples_per_sec").set(
                    round(self.batch_size / (now - self._t_last), 3))
                metrics.counter("throughput.examples_total").add(
                    self.batch_size)
            self._t_last = now
        else:
            self._t_last = time.perf_counter()
        if self._batches % self.log_freq == 0:
            self._export(step=self._batches)

    def on_train_end(self, logs=None):
        from ..observability import metrics
        self._export(step=self._batches)
        if self.enable_metrics and self._was_enabled is not None:
            metrics.enable(self._was_enabled)

    def _export(self, step):
        from ..observability import exporters
        if self._jsonl is not None:
            self._jsonl.write(step=step)
        if self.prom_path:
            exporters.write_prometheus(self.prom_path)


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        val = logs.get(self.monitor) or logs.get(f"eval_{self.monitor}")
        if val is None:
            return
        if isinstance(val, (list, tuple)):
            val = val[0]
        if self._better(float(val)):
            self.best = float(val)
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=10, verbose=2, save_dir=None, metrics=None,
                     mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    for c in cbks:
        c.set_model(model)
        c.set_params({"epochs": epochs, "steps": steps,
                      "verbose": verbose})
    return CallbackList(cbks)
