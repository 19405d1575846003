"""Process helpers of the reference's elastic controller
(``mxnet_tpu/resilience/controller.py``) that the serving router needs:
``_pid_alive`` and ``_pid_matches``, the guards a restarted supervisor
uses before it re-adopts a recorded pid.  ``ElasticController`` itself
is not ported yet (ROADMAP A.9)."""

from __future__ import annotations

import os

__all__ = []


def _pid_alive(pid):
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def _pid_matches(pid, workdir):
    """Best-effort guard against PID reuse when adopting: every worker
    is spawned with cwd=workdir, so a recorded pid whose /proc cwd no
    longer points there is some other process wearing a recycled pid.
    Unknowable platforms (no /proc) answer True."""
    try:
        cwd = os.readlink(f"/proc/{int(pid)}/cwd")
    except OSError:
        return True
    return os.path.realpath(cwd) == os.path.realpath(workdir)
