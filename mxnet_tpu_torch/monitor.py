"""Monitor: statistics of a graph's tensors during training
(counterpart of ``mxnet_tpu/monitor.py``).

``Module.install_monitor(mon)`` hands ``mon.stat_helper`` to each bound
executor, which calls it after a forward with every op node's outputs
(``<node>_<output>``); ``toc`` adds the arguments' statistics and
returns the rows collected since ``tic``, on batches that fall on the
interval, for names that match ``pattern``.
"""
from __future__ import annotations

import logging
import re

import numpy as _np

from .ndarray import NDArray

__all__ = ["Monitor"]


def _mean_abs(x):
    """Default statistic: mean |x| (the reference's asum_stat)."""
    return float(abs(x).mean().asscalar())


class Monitor:
    """Collects statistics of graph tensors every ``interval`` batches.

    Usage (reference contract)::

        mon = Monitor(100, pattern=".*weight")
        mod.install_monitor(mon)
        # per batch: mon.tic(); ...forward...; mon.toc_print()
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _mean_abs
        self.sort = sort
        self._pattern = re.compile(pattern)
        self._records = []      # (step, tensor name, raw stat)
        self._step = 0
        self._armed = False
        self._executors = []

    # executors call this for every named intermediate they surface
    def stat_helper(self, name, array):
        if self._armed and self._pattern.match(name):
            self._records.append((self._step, name,
                                  self.stat_func(array)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self._executors.append(exe)

    def _drain_args(self):
        for exe in self._executors:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                array.wait_to_read()
                if self._pattern.match(name):
                    self._records.append((self._step, name,
                                          self.stat_func(array)))

    def tic(self):
        """Arm collection if this batch is on the interval."""
        if self._step % self.interval == 0:
            self._records = []
            self._armed = True
        self._step += 1

    def toc(self):
        """Disarm and return [(step, name, formatted stat)] collected
        since ``tic`` (intermediates via the callback + current
        arguments)."""
        if not self._armed:
            return []
        self._drain_args()
        self._armed = False
        rows = self._records
        self._records = []
        if self.sort:
            rows.sort(key=lambda r: r[1])
        return [(step, name, self._format(stat))
                for step, name, stat in rows]

    @staticmethod
    def _format(stat):
        vals = stat if isinstance(stat, list) else [stat]
        parts = []
        for v in vals:
            if isinstance(v, NDArray):
                v = v.asnumpy()
            parts.append(str(_np.asarray(v) if not isinstance(v, str)
                             else v))
        return "\t".join(parts) + "\t"

    def toc_print(self):
        for step, name, value in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, value)
