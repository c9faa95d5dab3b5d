"""paddle.regularizer: L1/L2 weight decay (counterpart of
paddle_tpu/regularizer.py; reference python/paddle/regularizer.py:15).
The optimizers read `coeff` and `mode` (optimizer/optimizer.py)."""

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    mode = "l2"

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """Adds coeff * sign(param) to the gradient (sparsity-encouraging)."""
    mode = "l1"


class L2Decay(WeightDecayRegularizer):
    """Adds coeff * param to the gradient."""
    mode = "l2"
