"""ReduceLROnPlateau, the port of ``jpdse_tpu/train/schedule.py``: the JAX
package's own host-side controller (mode 'min', relative threshold), not
torch's, so both packages step the same lr sequence."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.1
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Feed a validation loss; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "factor": self.factor, "patience": self.patience,
                "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)
