"""Inference API (counterpart of paddle_tpu/inference; the reference's
paddle/fluid/inference: AnalysisPredictor, AnalysisConfig).

The saved model is the port's .pdmodel (a torch.export program of a
layer's eval forward, static/io.py and jit/api.py) with its weights in
the .pdiparams. A Predictor runs it on the card by default
(Config.disable_gpu() asks for the CPU; without a card and without that
request it raises): on the card, `run` copies its inputs into static
buffers (static/capture.py StaticInputs) and replays one CUDA graph per
input signature, the first call of a signature being its warm-up and
capture; on the CPU it calls the program. The handle surface (named
input and output handles, copy_from_cpu / run / copy_to_cpu) is the
reference's zero-copy API.

Two serving surfaces live behind this front end:
- per-call artifacts: create_predictor(Config(...)) below;
- LM request streams: create_serving_engine(model, ...), the
  continuous-batching ServingEngine (paddle_tpu_torch.serving).
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "create_serving_engine"]


class Config:
    """AnalysisConfig analogue: points at the exported artifact."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        if model_path and model_path.endswith(".pdmodel"):
            model_path = model_path[:-len(".pdmodel")]
        self._prefix = model_path
        self._device = None          # None: the card (CUDAPlace(0))
        self._memory_pool_mb = 0
        self._ir_optim = True

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device = ("gpu", device_id)

    def enable_tpu(self, device_id=0):
        raise NotImplementedError(
            "Config.enable_tpu: the port runs on a CUDA card (an NVIDIA "
            "H100), not a TPU; use enable_use_gpu(), or disable_gpu() for "
            "the CPU")

    def disable_gpu(self):
        self._device = ("cpu", 0)

    def use_gpu(self):
        return self._device is None or self._device[0] != "cpu"

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def model_dir(self):
        return os.path.dirname(self._prefix or "")

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return (self._prefix or "") + ".pdiparams"

    def device(self) -> torch.device:
        from ..core.place import CPUPlace, CUDAPlace, resolve_device
        if self._device is not None and self._device[0] == "cpu":
            return resolve_device(CPUPlace())
        if not torch.cuda.is_available():
            raise RuntimeError(
                "inference.Predictor runs on a CUDA card by default and "
                "none is available; call Config.disable_gpu() to run on "
                "the CPU")
        return resolve_device(CUDAPlace(self._device[1] if self._device
                                        else 0))


class Tensor:
    """ZeroCopyTensor analogue: a named input or output slot."""

    def __init__(self, predictor: "Predictor", name: str, is_input: bool):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    def reshape(self, shape):
        pass  # shapes come from the data; kept for API parity

    def copy_from_cpu(self, data: np.ndarray):
        if not self._is_input:
            raise RuntimeError(f"{self.name} is an output handle")
        self._p._feeds[self.name] = np.asarray(data)

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise RuntimeError(f"{self.name} is an input handle")
        return np.asarray(self._p._outputs[self.name])

    def shape(self):
        if self._is_input:
            a = self._p._feeds.get(self.name)
            return list(a.shape) if a is not None else None
        return list(np.shape(self._p._outputs[self.name]))


class _Graph:
    pass


class Predictor:
    """AnalysisPredictor analogue: the program and its weights, run on
    the card through one CUDA graph per input signature. `programs`,
    `captures` and `replays` count them."""

    def __init__(self, config: Config):
        from ..jit.api import ExportedForward, _load_state_into
        self.config = config
        self.device = config.device()
        prefix = config._prefix
        exported = ExportedForward.load(prefix + ".pdmodel")
        with open(prefix + ".pdiparams", "rb") as f:
            data = pickle.load(f)
        state = {k: np.asarray(v) for k, v in data["state"].items()}
        here = next(iter(exported.ep.state_dict.values()), None)
        if here is not None and here.device != self.device:
            exported = exported.to(self.device)
        self._exported = exported
        self._module = exported.module()
        _load_state_into(self._module, exported.state_names(), state)
        meta_path = prefix + ".pdmeta.json"
        names = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                names = json.load(f)
        spec = data.get("meta", {}).get("input_spec") or []
        self._input_names = names.get("feed_names") or [
            f"x{i}" for i in range(len(spec))]
        self._output_names = names.get("fetch_names") or [
            f"out{i}" for i in range(exported.n_outputs)]
        self._feeds: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        self._graphs = {}
        self.captures = 0
        self.replays = 0
        # the kernel launches the wrappers counted in the last warm-up
        self.last_launches = None

    @property
    def programs(self) -> int:
        return len(self._graphs)

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(self, name, is_input=True)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(self, name, is_input=False)

    def run_tensors(self, inputs):
        """The program on tensors already on the device: returns the
        output tensors (a replay's are clones of the graph's own)."""
        inputs = [t.to(self.device) for t in inputs]
        with torch.no_grad():
            if self.device.type != "cuda":
                out = self._module(*inputs)
            else:
                out = self._graph_run(inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _graph_run(self, inputs):
        from ..static.capture import (StaticInputs, capture, clone_outputs,
                                      warm_up)
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        g = self._graphs.get(key)
        if g is not None:
            g.inputs.fill(inputs)
            g.graph.replay()
            self.replays += 1
            return clone_outputs(g.out)
        g = _Graph()
        g.inputs = StaticInputs(list(inputs), self.device)

        def body():
            return self._module(*g.inputs.tree)
        before = _kernel_launches()
        first = warm_up(body, self.device)
        after = _kernel_launches()
        self.last_launches = {k: after[k] - before[k] for k in after}
        g.graph, g.out = capture(body, self.device, program="predictor")
        self._graphs[key] = g
        self.captures += 1
        return first

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._feeds[n] = a
        args = []
        for n in self._input_names:
            a = self._feeds[n]
            args.append(a if isinstance(a, torch.Tensor) else
                        torch.from_numpy(np.ascontiguousarray(a)))
        flat = self.run_tensors(args)
        self._outputs = {n: _to_numpy(a)
                         for n, a in zip(self._output_names, flat)}
        if inputs is not None:
            return [self._outputs[n] for n in self._output_names]

    def release(self):
        """Drop the captured graphs and their memory pools."""
        self._graphs.clear()


def _kernel_launches():
    """The kernel wrappers' launch counts (flash attention and NMS)."""
    from ..ops import flash_attention as _fa
    from ..ops import nms as _nms
    return {**_fa.launches, **_nms.launches}


def _to_numpy(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_serving_engine(model, serving_config=None, warmup=True,
                          **config_kw):
    """The serving twin of create_predictor: a warmed continuous-batching
    ServingEngine over a live GPTForCausalLM. Keyword overrides build a
    ServingConfig; warmup=False skips the program captures."""
    from ..serving import ServingConfig, ServingEngine
    if serving_config is not None and config_kw:
        raise ValueError(
            "pass either serving_config or keyword overrides, not both")
    cfg = serving_config or ServingConfig(**config_kw)
    eng = ServingEngine(model, cfg)
    return eng.warmup() if warmup else eng
