"""``mx.monitor`` — statistics of op outputs, the port of
``mxnet_tpu/monitor.py`` (MXNet's ``python/mxnet/monitor.py``).

``Monitor(interval, stat_func, pattern, sort)`` adds a hook at the
registry's dispatch (``ops.registry.add_monitor_hook``), which sees every
op that ``mx.nd`` runs, after it ran.  The stat (by default the mean of
|x|) stays a device tensor until ``toc()`` reads the batch's stats back.

Inside a hybridized block the ops run on tensors without ``mx.nd``'s
dispatch, and nothing is seen, as the reference sees nothing inside a jit
trace; nor is anything seen while a CUDA graph is being captured, so a
captured ``parallel.TrainStep`` is not observable (its replays run no
Python).  Call ``net.hybridize(False)`` while monitoring.
"""

from __future__ import annotations

import logging
import re

import torch

from .base import MXNetError

__all__ = ["Monitor"]


def _default_stat(x):
    return x.abs().float().mean()


class Monitor:
    """Collect output statistics of the ops run every ``interval``
    batches: ``stat_func(tensor) -> 0-d tensor`` (default mean |x|),
    ``pattern`` a regular expression over op names (``name_output<i>`` for
    an op with several outputs), ``sort`` orders ``toc()`` by name::

        mon = mx.monitor.Monitor(interval=2)
        mon.install()
        mon.tic()
        ... forward ...
        for batch, name, stat in mon.toc():
            print(batch, name, stat)
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = int(interval)
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = bool(sort)
        self.step = 0
        self.activated = False
        self.queue = []
        self._installed = False

    def _hook(self, op_name, outputs):
        if not self.activated:
            return
        for i, t in enumerate(outputs):
            if not isinstance(t, torch.Tensor):
                continue
            name = op_name if len(outputs) == 1 else f"{op_name}_output{i}"
            if not self.re_pattern.match(name):
                continue
            try:
                self.queue.append((self.step, name,
                                   self.stat_func(t.detach())))
            except Exception:  # noqa: BLE001 - a stat of a non-numeric output
                pass

    def install(self, exe=None):  # noqa: ARG002 - MXNet's executor argument
        """Start observing dispatch (one install covers every op)."""
        from .ops import registry
        if not self._installed:
            registry.add_monitor_hook(self._hook)
            self._installed = True
        return self

    def uninstall(self):
        from .ops import registry
        if self._installed:
            registry.remove_monitor_hook(self._hook)
            self._installed = False

    def tic(self):
        """Start collecting for this batch if the interval says so."""
        if not self._installed:
            self.install()
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting; the batch's ``(step, name, float stat)``s."""
        if not self.activated:
            return []
        self.activated = False
        res = []
        for n, name, stat in self.queue:
            try:
                val = float(stat)
            except (TypeError, ValueError, RuntimeError) as e:
                raise MXNetError(f"monitor stat for {name} not scalar: "
                                 f"{e}") from None
            res.append((n, name, val))
        self.queue = []
        if self.sort:
            res.sort(key=lambda t: t[1])
        return res

    def toc_print(self):
        for n, name, val in self.toc():
            logging.info("Batch: %7d %30s %s", n, name, val)
