"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (itself MXNet's
``python/mxnet/lr_scheduler.py``): ``LRScheduler`` with its linear or
constant warm-up (:7), ``FactorScheduler`` (:43), ``MultiFactorScheduler``
(:61), ``PolyScheduler`` (:78) and ``CosineScheduler`` (:97). A scheduler
maps the optimizer's ``num_update`` to a learning rate; ``Optimizer`` sets
its ``base_lr`` to the optimizer's ``learning_rate`` and reads the rate
through it. Pure Python, the same arithmetic as the reference, so the two
give the same floats.

``FactorScheduler`` and ``MultiFactorScheduler`` change their own state
when called (the decayed ``base_lr``, ``count``, ``cur_step_ind``), as in
the reference; ``state_dict``/``load_state_dict`` carry it.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * num_update \
                / self.warmup_steps
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise ValueError(self.warmup_mode)

    def __call__(self, num_update):
        raise NotImplementedError

    _STATE_ATTRS = ("base_lr", "count", "cur_step_ind")

    def state_dict(self):
        return {k: getattr(self, k) for k in self._STATE_ATTRS if hasattr(self, k)}

    def load_state_dict(self, d):
        for k in self._STATE_ATTRS:
            if k in d and hasattr(self, k):
                setattr(self, k, d[k])


class FactorScheduler(LRScheduler):
    """``base_lr * factor**k`` after every ``step`` updates, floored at
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor, self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` at each update count in ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = list(step)
        self.factor = factor
        self.cur_step_ind = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind < len(self.step) \
                and num_update >= self.step[self.cur_step_ind]:
            self.base_lr *= self.factor
            self.cur_step_ind += 1
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` to ``final_lr`` at ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = 1 - (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * frac ** self.power
        return self.final_lr


class CosineScheduler(LRScheduler):
    """Half a cosine from ``base_lr`` to ``final_lr`` at ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            t = (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * t)) / 2
        return self.final_lr


__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]
