"""Dynamic loss scaler.

Counterpart of ``mxnet_tpu/contrib/amp/loss_scaler.py`` (MXNet's
``python/mxnet/contrib/amp/loss_scaler.py``): the scale doubles after
``scale_window`` steps without overflow and halves (not below 1) on an
overflow, whose step is skipped. ``has_overflow`` is one all-finite
reduction over the gradients; ``update_from_step`` reads a step's finite
flag, the one host sync a float16 step needs.
"""
from __future__ import annotations

import torch


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0, scale_window=2000,
                 tolerance=0.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    def has_overflow(self, params_or_grads):
        """True if any floating array holds an inf or a NaN. Takes NDArrays
        or tensors."""
        flats = []
        for g in params_or_grads:
            raw = getattr(g, "_data", g)
            if raw is not None and raw.is_floating_point():
                flats.append(raw.detach().reshape(-1))
        if not flats:
            return False
        return not bool(torch.stack([torch.isfinite(f).all() for f in flats]).all())

    def update_from_step(self, finite):
        """Apply the policy to a step's all-finite flag (a bool or a 0-d
        tensor, read here: the host decides the next scale)."""
        return self.update_scale(not bool(finite))

    def state_dict(self):
        return {"loss_scale": self.loss_scale, "unskipped": self._unskipped}

    def load_state_dict(self, d):
        self.loss_scale = float(d["loss_scale"])
        self._unskipped = int(d.get("unskipped", 0))

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
        return not overflow


__all__ = ["LossScaler"]
