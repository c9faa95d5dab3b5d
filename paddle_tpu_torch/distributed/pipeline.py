"""Pipeline layers (counterpart of the parts of
paddle_tpu/distributed/pipeline.py that run in one process).

- LayerDesc: deferred layer construction (fleet.meta_parallel.LayerDesc);
- PipelineLayer: a list of layers cut into contiguous stage segments;
  in one process its forward runs every layer in turn, so one model
  file serves everywhere. Heterogeneous stages train through
  distributed/pipeline_engine.py's PipelineParallel;
- _min_slots: the ring-size rule of the static timetables
  (pipeline_engine._spmd_tick_tables).

The SPMD schedules (gpipe_schedule, one_f_one_b_schedule,
interleaved_one_f_one_b_schedule) and SpmdPipelineParallel run one
process per pp rank with p2p send/recv over the pp group: they come with
ROADMAP.md item 14d. A PipelineLayer called inside a pp axis context
raises, as the JAX one does inside shard_map.
"""
from __future__ import annotations

from typing import List, Sequence

from .. import nn
from ..nn.layer.layers import Layer
from .env import PIPE_AXIS, current_axis_name

__all__ = ["PipelineLayer", "LayerDesc"]


class LayerDesc:
    """Deferred layer construction (fleet.meta_parallel.LayerDesc parity)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.layer_cls(*self.args, **self.kwargs)


def _min_slots(intervals_by_m):
    """Smallest R such that slot m % R never holds two overlapping
    live intervals (the exact ring size the static timetable needs)."""
    ms = sorted(intervals_by_m)
    for r in range(1, len(ms) + 1):
        ok = True
        for i, m1 in enumerate(ms):
            for m2 in ms[i + 1:]:
                if m1 % r != m2 % r:
                    continue
                a1, b1 = intervals_by_m[m1]
                a2, b2 = intervals_by_m[m2]
                if a1 <= b2 and a2 <= b1:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return r
    return max(1, len(ms))


class PipelineLayer(Layer):
    """fleet.meta_parallel.PipelineLayer parity: takes a list of layers
    or LayerDescs and assigns contiguous segments to pp stages
    (uniform segmentation, stage_bounds). In one process the forward
    runs every layer in turn; stage_layers(i) gives stage i's segment
    for PipelineParallel."""

    def __init__(self, layers: Sequence, num_stages: int = 1,
                 loss_fn=None, topology=None, seg_method="uniform",
                 name=None, device=None):
        super().__init__(device=device)
        built = [d.build() if isinstance(d, LayerDesc) else d
                 for d in layers]
        self.funcs = nn.LayerList(built)
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        n = len(built)
        per = (n + num_stages - 1) // num_stages
        self.stage_bounds = [(i * per, min((i + 1) * per, n))
                             for i in range(num_stages)]

    def stage_layers(self, stage: int) -> List[Layer]:
        lo, hi = self.stage_bounds[stage]
        return list(self.funcs)[lo:hi]

    def forward(self, x):
        if current_axis_name(PIPE_AXIS) is None:
            for layer in self.funcs:
                x = layer(x)
            return x
        raise RuntimeError(
            "inside shard_map, drive PipelineLayer via gpipe_schedule "
            "with stacked stage params (see distributed.fleet); the SPMD "
            "schedules come with ROADMAP.md item 14d")
