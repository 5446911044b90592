"""Load predictors for the SLA planner.

The port's copy of ``dynamo_tpu/planner/load_predictor.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `components/planner/src/dynamo/planner/utils/
load_predictor.py:62,75,115` (constant / ARIMA / Prophet). Prophet and
statsmodels aren't in the image, so the AR predictor is a dependency-free
least-squares AR(p) fit — same role (trend-following forecast), numpy only.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class BasePredictor:
    def __init__(self, window: int = 128):
        self.history: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self.history.append(float(value))

    def predict(self) -> float:
        raise NotImplementedError


class ConstantPredictor(BasePredictor):
    """Next load = last observed load."""

    def predict(self) -> float:
        return self.history[-1] if self.history else 0.0


class MovingAveragePredictor(BasePredictor):
    def __init__(self, window: int = 128, span: int = 8):
        super().__init__(window)
        self.span = span

    def predict(self) -> float:
        if not self.history:
            return 0.0
        tail = list(self.history)[-self.span :]
        return float(np.mean(tail))


class ARPredictor(BasePredictor):
    """AR(p) one-step forecast by ordinary least squares on the window."""

    def __init__(self, window: int = 128, order: int = 4):
        super().__init__(window)
        self.order = order

    def predict(self) -> float:
        h = np.asarray(self.history, dtype=np.float64)
        p = self.order
        if len(h) <= p + 1:
            return float(h[-1]) if len(h) else 0.0
        # Rows: h[t-p:t] -> h[t]
        X = np.stack([h[i : i + p] for i in range(len(h) - p)])
        y = h[p:]
        X1 = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        coef, *_ = np.linalg.lstsq(X1, y, rcond=None)
        pred = float(np.concatenate([h[-p:], [1.0]]) @ coef)
        return max(0.0, pred)


PREDICTORS = {
    "constant": ConstantPredictor,
    "moving_average": MovingAveragePredictor,
    "ar": ARPredictor,
}
