"""static.io: save/load_inference_model (counterpart of
paddle_tpu/static/io.py, the reference's static/io.py).

The artifact is {prefix}.pdmodel, {prefix}.pdiparams and
{prefix}.pdmeta.json. The last two keep the JAX package's layout: a
pickle of {"state": {name: numpy array}, "meta": {...}} and the feed and
fetch names as JSON. The .pdmodel is the port's program: a torch.export
archive of the layer's eval forward (jit/api.py export_forward), where
the JAX package writes jax.export StableHLO; None dims of the input
spec stay dynamic in it.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Sequence

__all__ = ["save_inference_model", "load_inference_model",
           "serialize_program", "deserialize_program"]


def save_inference_model(path_prefix: str, feed_vars=None, fetch_vars=None,
                         executor=None, layer=None, input_spec=None,
                         feed_names: Optional[Sequence[str]] = None,
                         fetch_names: Optional[Sequence[str]] = None,
                         **kwargs):
    """Export a Layer's eval forward as a deployable artifact:
    save_inference_model(prefix, layer=model, input_spec=[InputSpec...])
    or the positional (prefix, layer, input_spec) form. Raises when the
    forward cannot be exported: here the program is the artifact."""
    from ..jit.api import export_forward, state_arrays, _spec_meta
    from ..nn.layer.layers import Layer

    if layer is None and isinstance(feed_vars, Layer):
        layer = feed_vars
        if input_spec is None and fetch_vars is not None:
            input_spec = fetch_vars
    if layer is None or input_spec is None:
        raise ValueError(
            "save_inference_model needs layer= and input_spec= (or the "
            "positional (path, layer, input_spec) form)")
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    exported = export_forward(layer, input_spec)
    exported.save(path_prefix + ".pdmodel")
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump({"state": state_arrays(layer),
                     "meta": _spec_meta(layer, input_spec)}, f)
    feed_names = list(feed_names) if feed_names else [
        getattr(s, "name", None) or f"x{i}"
        for i, s in enumerate(input_spec)]
    fetch_names = list(fetch_names) if fetch_names else [
        f"out{i}" for i in range(exported.n_outputs)]
    with open(path_prefix + ".pdmeta.json", "w") as f:
        json.dump({"feed_names": feed_names, "fetch_names": fetch_names},
                  f)


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """(predictor, feed_names, fetch_names): the reference returns
    (program, feed_names, fetch_targets) for Executor.run; here the
    program is a Predictor, run as predictor.run([arrays]). The
    Predictor's device is the executor's place when one is given, else
    the card (Config's default)."""
    from ..core.place import resolve_device
    from ..inference import Config, create_predictor
    config = Config(path_prefix)
    place = getattr(executor, "place", None)
    if executor is not None and resolve_device(place).type == "cpu":
        config.disable_gpu()
    pred = create_predictor(config)
    return pred, pred.get_input_names(), pred.get_output_names()


def serialize_program(layer, input_spec) -> bytes:
    """The exported program's bytes (ref static/io.py
    serialize_program)."""
    from ..jit.api import export_forward
    return export_forward(layer, input_spec).to_bytes()


def deserialize_program(data: bytes):
    from ..jit.api import ExportedForward
    return ExportedForward.from_bytes(data)
