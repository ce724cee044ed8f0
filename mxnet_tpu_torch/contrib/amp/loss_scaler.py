"""Dynamic loss scaler.

Counterpart of ``mxnet_tpu/contrib/amp/loss_scaler.py`` (MXNet's
``python/mxnet/contrib/amp/loss_scaler.py``): the scale doubles after
``scale_window`` steps without overflow and halves (not below 1) on an
overflow, whose step is skipped. ``has_overflow`` is one all-finite
reduction over the gradients.

Two homes for the state. Unbound, the scale and the count of finite steps
are host numbers and ``update_scale`` / ``update_from_step`` apply the
policy on the host. ``bind(device)`` moves them into device memory (the
scale a float64 tensor, the count an int64 one, so the arithmetic is the
host's), where ``update_on_device`` applies the same policy with a few
tensor ops and no host read: the fused float16 step runs it inside its
captured graph. ``loss_scale``, ``_unskipped`` and ``state_dict()`` read
the device values, and sync only then; assigning them, or
``load_state_dict``, writes them in place.
"""
from __future__ import annotations

from typing import Optional

import torch


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0, scale_window=2000,
                 tolerance=0.0):
        self._dev: Optional[tuple] = None        # (scale f64, count i64) once bound
        self._scale = float(init_scale)
        self._count = 0
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)

    # -- the state, wherever it lives -------------------------------------------------
    @property
    def loss_scale(self) -> float:
        return float(self._dev[0].item()) if self._dev is not None else self._scale

    @loss_scale.setter
    def loss_scale(self, v):
        if self._dev is not None:
            self._dev[0].fill_(float(v))
        else:
            self._scale = float(v)

    @property
    def _unskipped(self) -> int:
        return int(self._dev[1].item()) if self._dev is not None else self._count

    @_unskipped.setter
    def _unskipped(self, v):
        if self._dev is not None:
            self._dev[1].fill_(int(v))
        else:
            self._count = int(v)

    def bind(self, device) -> None:
        """Keep the scale and the count in ``device`` memory from now on."""
        if self._dev is None:
            self._dev = (torch.tensor(self._scale, dtype=torch.float64, device=device),
                         torch.tensor(self._count, dtype=torch.int64, device=device))

    def scale_tensor(self) -> torch.Tensor:
        """The scale as a 0-d float32 tensor on the bound device (what
        multiplies the loss: the reference's ``np.float32(loss_scale)``)."""
        return self._dev[0].to(torch.float32)

    def update_on_device(self, found: torch.Tensor, gate: Optional[torch.Tensor] = None):
        """The policy on the bound device: ``found`` nonzero is an overflow;
        where ``gate`` is given and zero, nothing changes (a ``run_steps``
        call applies the policy at its last step only). Tensor ops only."""
        scale, count = self._dev
        over = found.reshape(()) != 0
        nxt = count + 1
        grow = nxt >= self._scale_window
        new_scale = torch.where(over, torch.clamp(scale / self._scale_factor, min=1.0),
                                torch.where(grow, scale * self._scale_factor, scale))
        new_count = torch.where(over | grow, torch.zeros_like(count), nxt)
        if gate is not None:
            on = gate.reshape(()) != 0
            new_scale = torch.where(on, new_scale, scale)
            new_count = torch.where(on, new_count, count)
        scale.copy_(new_scale)
        count.copy_(new_count)

    # -- the host forms -----------------------------------------------------------------
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
        scale, count = self.loss_scale, self._unskipped
        if overflow:
            scale = max(scale / self._scale_factor, 1.0)
            count = 0
        else:
            count += 1
            if count >= self._scale_window:
                scale *= self._scale_factor
                count = 0
        self.loss_scale, self._unskipped = scale, count
        return not overflow


__all__ = ["LossScaler"]
