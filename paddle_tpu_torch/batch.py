"""paddle.batch: a minibatch-aggregating reader decorator (counterpart
of paddle_tpu/batch.py; reference python/paddle/batch.py:18)."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample-yielding reader into a batch-yielding reader."""
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer, "
                         f"got {batch_size}")

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
