"""Enforce errors with op attribution (counterpart of
paddle_tpu/core/enforce.py's EnforceNotMet family): an error raised for
an op carries the op's name in its message."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "UnimplementedError"]


class EnforceNotMet(RuntimeError):
    """Raised when an enforce check fails; carries the op's name."""

    def __init__(self, message, op_type=None):
        self.op_type = op_type
        full = f"[operator < {op_type} > error] {message}" if op_type \
            else message
        super().__init__(full)


class InvalidArgumentError(EnforceNotMet):
    pass


class NotFoundError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet):
    pass
