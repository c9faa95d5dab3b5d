"""Model summary (counterpart of paddle_tpu/hapi/summary.py, the
reference's python/paddle/hapi/model_summary.py)."""
from __future__ import annotations

__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None, input=None):
    """Parameter-count summary, printed; returns {'total_params',
    'trainable_params'}."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(p.numel())
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'Param':<{width}}{'Shape':<20}{'Count':>12}"]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append("-" * (width + 32))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
