"""Learning-rate schedules (counterpart of ``mxnet_tpu/lr_scheduler.py``):
``FactorScheduler`` and ``MultiFactorScheduler``, computed in closed form
from the optimizer's update count, with the reference's
decay-when-exceeded rule.  The optimizer sets ``base_lr`` from its
``learning_rate`` and calls the scheduler at every update.
"""
from __future__ import annotations

import bisect
import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]

log = logging.getLogger(__name__)


class LRScheduler:
    """Maps ``num_update`` (the optimizer's update count) to a learning
    rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_logged = None

    def _decays(self, num_update):
        """How many decay boundaries ``num_update`` has passed."""
        raise NotImplementedError()

    def __call__(self, num_update):
        lr = self._lr(num_update)
        if self._last_logged != lr:
            self._last_logged = lr
            log.info("Update[%d]: learning rate %0.5e", num_update, lr)
        return lr

    def _lr(self, num_update):
        return self.base_lr * self.factor ** self._decays(num_update)


class FactorScheduler(LRScheduler):
    """``base_lr * factor ** k`` after every ``step`` updates (the decay
    comes once ``num_update`` exceeds a multiple of ``step``), floored at
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decays(self, num_update):
        return max(0, num_update - 1) // self.step

    def _lr(self, num_update):
        return max(super()._lr(num_update), self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """The learning rate falls by ``factor`` as ``num_update`` passes
    each boundary of the increasing list ``step``."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list")
        if any(s < 1 for s in step):
            raise ValueError("Schedule step must be greater or equal than 1")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("Schedule step must be an increasing list")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor

    def _decays(self, num_update):
        # the boundaries strictly below num_update have been passed
        return bisect.bisect_left(self.step, num_update)
