"""Learning-rate schedulers: the port's copy of ``mxnet_tpu/lr_scheduler.py``."""

from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (lr_scheduler.py:36)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be at least 1")
        if factor > 1.0:
            raise ValueError("factor must be no more than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: lr reached stop factor %.5e",
                             num_update, self.base_lr)
            else:
                logging.info("Update[%d]: change lr to %.5e", num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given update milestones (lr_scheduler.py:85)."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("steps must be increasing")
        if step[0] < 1:
            raise ValueError("steps must be at least 1")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor

    def __call__(self, num_update):
        while (self.cur_step_ind <= len(self.step) - 1
               and num_update > self.step[self.cur_step_ind]):
            self.base_lr *= self.factor
            self.cur_step_ind += 1
            logging.info("Update[%d]: change lr to %.5e", num_update, self.base_lr)
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to ``final_lr`` over
    ``max_update`` steps (beyond the 2016 reference; the classic
    ImageNet alternative to step decay), with optional linear warmup."""

    def __init__(self, max_update, power=2.0, final_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0.0):
        super().__init__()
        if max_update < 1:
            raise ValueError("max_update must be at least 1")
        self.max_update = max_update
        self.power = power
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def _warmup(self, num_update):
        return (self.warmup_begin_lr
                + (self.base_lr - self.warmup_begin_lr)
                * num_update / self.warmup_steps)

    def _progress(self, num_update):
        """Post-warmup decay fraction in [0, 1] (clamped past max)."""
        return min(
            (num_update - self.warmup_steps)
            / max(self.max_update - self.warmup_steps, 1), 1.0)

    def _decay(self, frac):
        """Decay weight in [0, 1] at post-warmup progress ``frac``;
        subclasses override this single hook."""
        return (1.0 - frac) ** self.power

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self._warmup(num_update)
        return (self.final_lr + (self.base_lr - self.final_lr)
                * self._decay(self._progress(num_update)))


class CosineScheduler(PolyScheduler):
    """Cosine decay from base_lr to ``final_lr`` over ``max_update``
    steps with optional linear warmup (beyond the 2016 reference; the
    standard TPU-era large-batch schedule, paired with LARS/LAMB)."""

    def __init__(self, max_update, final_lr=0.0, warmup_steps=0,
                 warmup_begin_lr=0.0):
        super().__init__(max_update, final_lr=final_lr,
                         warmup_steps=warmup_steps,
                         warmup_begin_lr=warmup_begin_lr)

    def _decay(self, frac):
        return 0.5 * (1.0 + math.cos(math.pi * frac))
