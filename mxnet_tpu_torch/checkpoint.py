"""``mx.checkpoint`` — step checkpoints and the auto-resume loop, the port
of ``mxnet_tpu/checkpoint.py``.

The reference saves through orbax, which needs JAX, so the port keeps its
own layout under the same manifest; checkpoints do not cross between the
packages (``.params`` files do: ``model.py``).  Each committed step is a
directory ``<directory>/<step>/`` holding:

- ``params.params``: the net's arrays by parameter name (``nd.save``);
- ``trainer.states``: the bytes of ``Trainer.save_states``;
- ``extra.params``: the ``extra`` arrays by name (``nd.save``).

A step is written into a temporary directory, its files flushed to disk,
and renamed into place; only then does it enter ``manifest.json``
(``{"committed": [steps], "world": {step: {"n": 1, "sharded": false}}}``,
the reference's schema), itself written to a temporary file and renamed
over the old one.  A save killed at any point leaves either the old
manifest or the new one, and no half-written step that ``latest_step`` or
``restore`` would pick up.  ``max_to_keep`` (default
``MXNET_CHECKPOINT_KEEP``, 3) keeps the newest steps and deletes the
oldest after each commit.  ``restore(step=None)`` warns and falls back to
the previous committed step when the latest does not restore.  A step
that the manifest says a world of several processes committed is refused
(the port writes only one-process checkpoints).

``auto_resume(train_fn, directory, net, trainer)`` restores the latest
step, runs ``train_fn(step)`` from the one after it, saves every
``save_every`` steps, replays from the last good step when ``train_fn``
raises (``resume_policy="restart"``, up to ``max_restarts``), and on a
SIGTERM (``MXNET_RESILIENCE_SIGTERM_SAVE``, default 1) saves after the
step in flight and returns.  The random generators are not saved, as in
the reference: a resumed run equals the uninterrupted one where its steps
draw nothing (dropout 0).

Not ported: the reference's telemetry (save and restore histograms, the
corrupt-step and resize counters), its ``checkpoint.save`` chaos site and
``resilience.record_resume`` (ROADMAP A.11).
"""

from __future__ import annotations

import json
import os
import shutil

from . import config
from .base import MXNetError

__all__ = ["CheckpointManager", "auto_resume"]

_PARAMS, _STATES, _EXTRA = "params.params", "trainer.states", "extra.params"


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """Step checkpoints in ``directory``: ``save(step, net=, trainer=,
    extra=)``, ``restore(step=None, net=, trainer=)`` -> ``(step, extra)``,
    ``latest_step()``, ``committed_steps()``, ``all_steps()``."""

    def __init__(self, directory, max_to_keep=None):
        self._dir = os.path.abspath(directory)
        keep = max_to_keep if max_to_keep is not None \
            else config.get_int("MXNET_CHECKPOINT_KEEP", 3)
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)
        self._manifest_path = os.path.join(self._dir, "manifest.json")

    def _step_dir(self, step):
        return os.path.join(self._dir, str(int(step)))

    # -- the manifest ---------------------------------------------------------
    def _read_manifest_data(self):
        """The manifest as a dict, or None when absent or unreadable."""
        try:
            with open(self._manifest_path) as f:
                data = json.load(f)
        except (FileNotFoundError, ValueError, OSError):
            return None
        if not isinstance(data, dict) \
                or not isinstance(data.get("committed"), list):
            return None
        return data

    def _write_manifest(self, committed, world):
        """Write-then-rename, after the steps' data is on disk."""
        doc = {"committed": sorted(int(s) for s in committed)}
        doc["world"] = {str(s): world[str(s)] for s in doc["committed"]
                        if str(s) in world}
        tmp = f"{self._manifest_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)
        _fsync_dir(self._dir)

    def _world_entry(self, step):
        data = self._read_manifest_data() or {}
        entry = (data.get("world") or {}).get(str(int(step)))
        return entry if isinstance(entry, dict) and "n" in entry else None

    def all_steps(self):
        """Step directories on disk, committed or not, oldest first."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def committed_steps(self):
        """Steps whose save finished and entered the manifest, oldest
        first."""
        data = self._read_manifest_data()
        present = self.all_steps()
        if data is None:
            return present
        on_disk = set(present)
        return [s for s in sorted(int(s) for s in data["committed"])
                if s in on_disk]

    def latest_step(self):
        steps = self.committed_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------------
    def save(self, step, net=None, trainer=None, extra=None, force=False):
        """Checkpoint ``step``; False (nothing written) when it is already
        committed, unless ``force``."""
        from .ndarray import ndarray as nd
        if net is None and trainer is None and not extra:
            raise MXNetError("nothing to checkpoint: pass net/trainer/extra")
        step = int(step)
        data = self._read_manifest_data()
        committed = set(self.committed_steps())
        if step in committed and not force:
            return False
        tmp = os.path.join(self._dir, f".{step}.tmp.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        files = []
        if net is not None:
            files.append(os.path.join(tmp, _PARAMS))
            nd.save(files[-1], {name: p.data() for name, p in
                                net.collect_params().items()})
        if trainer is not None:
            files.append(os.path.join(tmp, _STATES))
            trainer.save_states(files[-1])
        if extra:
            files.append(os.path.join(tmp, _EXTRA))
            nd.save(files[-1], {k: v if isinstance(v, nd.NDArray)
                                else nd.array(v, ctx=_cpu())
                                for k, v in extra.items()})
        for path in files:
            with open(path, "rb") as f:
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        final = self._step_dir(step)
        if os.path.exists(final):   # a replaced step, or an uncommitted one
            shutil.rmtree(final)
        os.replace(tmp, final)
        committed.add(step)
        world = dict((data or {}).get("world") or {})
        world[str(step)] = {"n": 1, "sharded": False}
        if self._keep:
            committed = set(sorted(committed)[-self._keep:])
        self._write_manifest(committed, world)
        if self._keep:
            for s in self.all_steps():
                if s not in committed:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return True

    # -- restore --------------------------------------------------------------
    def restore(self, step=None, net=None, trainer=None):
        """Restore ``step`` (default: the latest committed) into ``net``
        and ``trainer`` in place; returns ``(step, extra)``, or
        ``(None, {})`` with no checkpoint.  With ``step=None`` a step that
        fails to restore is skipped with a warning for the one before it;
        an explicit ``step`` raises its error."""
        if step is not None:
            return self._restore_step(step, net=net, trainer=trainer)
        candidates = list(reversed(self.committed_steps()))
        if not candidates:
            return None, {}
        last_exc = None
        for s in candidates:
            try:
                return self._restore_step(s, net=net, trainer=trainer)
            except Exception as exc:  # noqa: BLE001 - a corrupted step
                import warnings
                last_exc = exc
                warnings.warn(
                    f"checkpoint step {s} failed to restore ({exc!r}); "
                    "falling back to the previous step", stacklevel=2)
        raise MXNetError(
            f"no restorable checkpoint in {self._dir}: every committed "
            f"step {list(reversed(candidates))} failed") from last_exc

    def _restore_step(self, step, net=None, trainer=None):
        from .ndarray import ndarray as nd
        step = int(step)
        d = self._step_dir(step)
        if not os.path.isdir(d):
            raise MXNetError(f"no checkpoint step {step} in {self._dir}")
        entry = self._world_entry(step)
        if entry is not None and int(entry["n"]) != 1:
            raise MXNetError(
                f"checkpoint step {step} was committed by a world of "
                f"{int(entry['n'])} processes; only one-process checkpoints "
                "restore here (multi-process stores: ROADMAP A.9)")
        saved = None
        if net is not None:
            saved = nd.load(os.path.join(d, _PARAMS), ctx=_cpu())
            params = net.collect_params()
            missing = set(params.keys()) - set(saved)
            if missing:
                raise MXNetError(f"checkpoint step {step} lacks params "
                                 f"{sorted(missing)}")
        extra = {}
        if os.path.exists(os.path.join(d, _EXTRA)):
            extra = nd.load(os.path.join(d, _EXTRA), ctx=_cpu())
        states = os.path.join(d, _STATES)
        if trainer is not None and os.path.exists(states):
            trainer.load_states(states)
        if saved is not None:
            for name, p in params.items():
                p.set_data(saved[name])
        return step, extra


def _cpu():
    from .context import cpu
    return cpu()


class _SigtermHook:
    """A SIGTERM handler that only sets a flag, which the loop reads
    between steps, so the save after a preemption notice holds a whole
    step."""

    def __init__(self):
        self.fired = False
        self._prev = None
        self._installed = False

    def _handler(self, signum, frame):  # noqa: ARG002
        self.fired = True

    def install(self):
        import signal
        import threading
        if threading.current_thread() is not threading.main_thread():
            return self         # signal.signal works in the main thread only
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:
            pass
        return self

    def uninstall(self):
        if self._installed:
            import signal
            # a handler installed from C reads back as None: restore the
            # default then
            prev = self._prev if self._prev is not None else signal.SIG_DFL
            signal.signal(signal.SIGTERM, prev)
            self._installed = False


def auto_resume(train_fn, directory, net=None, trainer=None,
                save_every=1, max_to_keep=None, resume_policy="restart",
                max_restarts=3, sigterm_save=None):
    """Run ``train_fn(step) -> bool`` (one step at global step ``step``;
    False stops) from the step after the latest checkpoint in
    ``directory``, restored into ``net`` and ``trainer`` first.  Returns
    the last step completed.

    - ``resume_policy="restart"``: when ``train_fn`` raises, restore the
      last good checkpoint and replay from the step after it, at most
      ``max_restarts`` times; a fault before the first checkpoint raises.
      ``"none"`` raises at once.
    - ``sigterm_save`` (default ``MXNET_RESILIENCE_SIGTERM_SAVE``): a
      SIGTERM saves after the step in flight and returns; the next
      ``auto_resume`` continues there.
    """
    import warnings
    mgr = CheckpointManager(directory, max_to_keep=max_to_keep)
    last, _ = mgr.restore(net=net, trainer=trainer)
    step = (last + 1) if last is not None else 0
    restarts = 0
    if sigterm_save is None:
        sigterm_save = bool(config.get_int("MXNET_RESILIENCE_SIGTERM_SAVE",
                                           1))
    hook = _SigtermHook().install() if sigterm_save else None
    try:
        while True:
            try:
                more = train_fn(step)
            except Exception as exc:  # noqa: BLE001 - the restart policy
                if hook is not None and hook.fired:
                    # preempted while the step failed: stop at the last
                    # checkpoint instead of replaying
                    last_good = mgr.latest_step()
                    if last_good is None:
                        raise
                    warnings.warn(
                        f"SIGTERM received and step {step} failed "
                        f"({exc!r}); stopping at checkpointed step "
                        f"{last_good} without replay", stacklevel=2)
                    return last_good
                if resume_policy != "restart" or restarts >= max_restarts:
                    raise
                good, _ = mgr.restore(net=net, trainer=trainer)
                if good is None:
                    raise
                restarts += 1
                warnings.warn(
                    f"train_fn failed at step {step} ({exc!r}); resumed "
                    f"from checkpoint step {good} "
                    f"(restart {restarts}/{max_restarts})", stacklevel=2)
                step = good + 1
                continue
            preempted = hook is not None and hook.fired
            if step % save_every == 0 or not more or preempted:
                mgr.save(step, net=net, trainer=trainer, force=preempted)
            if preempted:
                warnings.warn(
                    f"SIGTERM received: emergency checkpoint at step "
                    f"{step}; stopping cleanly", stacklevel=2)
                return step
            if not more:
                return step
            step += 1
    finally:
        if hook is not None:
            hook.uninstall()
