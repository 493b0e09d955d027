"""Simulation driver: the user-facing time loop.

Counterpart of ``triflow_tpu.core.simulation``: an iterable yielding
``(t, fields)`` every output ``dt`` until ``tmax``, with the hook applied
on the host before each output step, the last step's dt clamped to land on
``tmax``, post-processes, a stream fan-out, per-step timers and a status
lifecycle.  A ``double="df64"`` model keeps float64 fields and rounds the
output dt to float32, as the reference does.  The default scheme is
``RODASPR`` with its own adaptive controller; a scheme without one is
wrapped in the step-doubling controller (``schemes.time_stepping``) unless
``time_stepping=False``.  ``run(device_chunk=n)`` advances up to n output
steps per call of the scheme's ``device_steps`` (one K6 launch, one
captured CUDA graph, or the eager loop: ``schemes._SchemeBase``) and emits
every snapshot as the stepwise run does.

Persistence: ``attach_container`` feeds a ``plugins.container.Container``
from the stream, one frame per emission (the chunked run emits one per
snapshot, as the stepwise loop does); a finished run flushes and merges
it, a failed one flushes what it buffered.  ``save_checkpoint`` /
``from_checkpoint`` (``utils.checkpoint``) write and rebuild the
restartable state.

A duck-typed model (any object with ``.F(fields, pars)`` and
``fields_template``, stepped by ``schemes.scipy_ode``) keeps its fields as
given: only a model of the port has a backend to convert them with.
"""

from __future__ import annotations

import inspect
import logging
import pprint
import time
import warnings
from collections import namedtuple
from datetime import datetime, timedelta
from uuid import uuid1

import numpy as np

from . import schemes
from ..utils.streams import Stream

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())

null_hook = schemes.null_hook


class Timer:
    """Wall time of the scheme calls: the last one and the total."""

    def __init__(self, last, total):
        self.last = last
        self.total = total

    @staticmethod
    def _fmt(seconds):
        return str(timedelta(seconds=float(seconds)))

    def __repr__(self):
        return f"last:   {self._fmt(self.last)}\ntotal:  {self._fmt(self.total)}"


PostProcess = namedtuple("PostProcess", ["name", "function", "description"])


class Simulation:
    """A model run through time.

    Parameters
    ----------
    model : triflow_tpu_torch.Model
    fields : Fields or mapping of initial conditions (numpy arrays or
        tensors; copied onto the model's device and dtype)
    parameters : dict, with the 'periodic' key
    dt : float, output time step
    t : float, initial time
    tmax : float or None (None: endless iterator)
    id : str, simulation name (generated if omitted)
    hook : callable ``(t, fields, pars) -> (fields, pars)``; the fields hold
        tensors, updated in place (``fields["U"][0] = 1.0``) or rebound
    scheme : scheme class (default ``schemes.RODASPR``)
    time_stepping : bool, passed to the scheme where its signature takes
        it; a scheme left without its own controller is wrapped in
        ``schemes.time_stepping`` (step doubling) when True
    **kwargs : passed to the scheme, and to ``schemes.time_stepping`` when
        it wraps the scheme, where their signatures take them
    """

    def __init__(self, model, fields, parameters, dt, t=0, tmax=None,
                 id=None, hook=null_hook, scheme=schemes.RODASPR,
                 time_stepping=True, mesh=None, **kwargs):
        if mesh is not None:
            raise NotImplementedError(
                "spatial sharding (mesh=...) is not ported yet (ROADMAP A9)")
        self.id = str(uuid1())[:6] if not id else id
        self.model = model
        self.parameters = dict(parameters)
        keys = fields.keys()
        if hasattr(model, "backend"):
            tensor = model.backend.as_tensor
            self.fields = model.fields_template(
                **{k: tensor(fields[k]).clone() for k in keys})
        else:
            self.fields = model.fields_template(**{k: fields[k] for k in keys})
        self.t = t
        if getattr(model, "precision", None) == "df64":
            # the df64 mode's steps are float32 values (as the reference's
            # device steps are): round the requested dt to one up front, so
            # the float64 clock advances by the dt the state integrates with
            dt = float(np.float32(dt))
        self.user_dt = self.dt = dt
        self.tmax = tmax
        self.i = 0
        self._stream = Stream()
        self._pprocesses = []

        def accepted(function):
            params = inspect.signature(function).parameters
            return {k: v for k, v in kwargs.items() if k in params}

        kwargs["time_stepping"] = time_stepping
        self._scheme = scheme(model, **accepted(scheme.__init__))
        # a scheme with its own adaptive controller is not wrapped again
        if time_stepping and not getattr(self._scheme, "_time_control",
                                         False):
            self._scheme = schemes.time_stepping(
                self._scheme, **accepted(schemes.time_stepping))
        self.status = "created"
        self._total_running = 0
        self._last_running = 0
        self._created_timestamp = datetime.now()
        self._started_timestamp = None
        self._last_timestamp = None
        self._actual_timestamp = datetime.now()
        self._hook = hook
        self._container = None
        self._iterator = self.compute()

    # ------------------------------------------------------------------ loop
    def _compute_one_step(self, t, fields, pars):
        if self._hook is not null_hook:
            # hooks update tensors in place: a copy keeps every state
            # yielded before as it was yielded
            fields, pars = self._hook(t, fields.copy(), pars)
        self.dt = (self.tmax - t
                   if self.tmax and (t + self.dt >= self.tmax) else self.dt)
        before = time.monotonic()
        t, fields = self._scheme(t, fields, self.dt, pars, hook=self._hook)
        self._last_running = time.monotonic() - before
        self._total_running += self._last_running
        self._last_timestamp = self._actual_timestamp
        self._actual_timestamp = datetime.now()
        return t, fields, pars

    def compute(self):
        """Generator yielding the state every dt."""
        fields, t, pars = self.fields, self.t, self.parameters
        self._started_timestamp = datetime.now()
        self.stream.emit(self)
        self.status = "running"
        try:
            while True:
                if self.tmax and np.isclose(t, self.tmax):
                    self._end_simulation()
                    return
                t, fields, pars = self._compute_one_step(t, fields, pars)
                self.i += 1
                self.t, self.fields, self.parameters = t, fields, pars
                for pprocess in self.post_processes:
                    pprocess.function(self)
                self.stream.emit(self)
                yield self.t, self.fields
        except RuntimeError:
            self._fail()
            raise

    def _end_simulation(self):
        self.status = "finished"
        if self.container:
            self.container.flush()
            self.container.merge()

    def _fail(self):
        """A failed run: its status, and the container's buffered frames
        written (best effort: the run's own error is the one raised)."""
        self.status = "failed"
        if self.container:
            try:
                self.container.flush()
            except Exception:  # noqa: BLE001 - the run's error wins
                logger.exception("container flush failed during teardown")

    def run(self, progress=True, verbose=False, device_chunk=1):
        """Compute all steps (never returns when tmax is not set).

        ``device_chunk > 1`` (with tmax set) advances up to that many
        output steps per call of the scheme's ``device_steps`` and then
        emits each snapshot to the post-processes and the stream: the
        observable sequence (``i``, the times, the states, the emissions)
        is the stepwise run's."""
        if (device_chunk and device_chunk > 1 and self.tmax
                and hasattr(self._scheme, "device_steps")):
            return self._run_chunked(progress, verbose, int(device_chunk))
        log = logger.info if verbose else logger.debug
        t, fields = self.t, self.fields
        ran = False
        pbar = None
        if progress:
            import tqdm

            total = int((self.tmax // self.user_dt) if self.tmax else 0)
            pbar = tqdm.tqdm(initial=min(self.i, total), total=total)
        try:
            for t, fields in self:
                ran = True
                if pbar is not None:
                    pbar.update(1)
                log("%s running: t: %g" % (self.id, t))
        finally:
            if pbar is not None:
                pbar.close()
        if not ran:
            warnings.warn("Simulation already ended")
        return t, fields

    #: cap on the snapshot bytes of one ``device_steps`` call (its
    #: snapshots are held on the device together)
    _CHUNK_SNAPSHOT_BYTES = 1 << 30

    def _chunk_cap(self):
        """Output steps whose snapshots fit ``_CHUNK_SNAPSHOT_BYTES``."""
        state_bytes = sum(self.fields[k].nelement()
                          * self.fields[k].element_size()
                          for k in self.fields.keys())
        return max(1, self._CHUNK_SNAPSHOT_BYTES // max(state_bytes, 1))

    def _full_steps(self, most):
        """How many of the next output steps (at most ``most``) the
        stepwise loop would take with the full dt: each from a time not
        close to tmax with ``t + dt < tmax`` (or ``tmax - t == dt``, which
        the clamp leaves as it is), the clock advanced as the scheme
        advances it.  The stepwise loop clamps the step that would pass
        tmax, and the chunked run leaves that one to it."""
        t, n = self.t, 0
        while (n < most and not np.isclose(t, self.tmax)
               and (t + self.dt < self.tmax or self.tmax - t == self.dt)):
            t = float(self._scheme._advance(t, self.dt))
            n += 1
        return n

    def _emit(self, pbar, log):
        self.i += 1
        for pprocess in self.post_processes:
            pprocess.function(self)
        self.stream.emit(self)
        if pbar is not None:
            pbar.update(1)
        log("%s running: t: %g" % (self.id, self.t))

    def _run_chunked(self, progress, verbose, device_chunk):
        """The chunked run: the full-dt output steps in calls of the
        scheme's ``device_steps`` of at most ``device_chunk`` steps (and
        ``_chunk_cap``), each snapshot emitted as the stepwise loop emits
        it (on failure the valid prefix, then ``RuntimeError``), the rest
        (the step clamped to land on tmax) through ``_compute_one_step``.
        The reference falls back to the stepwise loop where its hook fails
        to trace; a hook here is never traced (the eager route runs it on
        the host), so there is nothing to fall back from."""
        log = logger.info if verbose else logger.debug
        total = int(round(self.tmax / self.user_dt))
        pbar = None
        if progress:
            import tqdm

            pbar = tqdm.tqdm(initial=min(self.i, total), total=total)
        if self.status == "created":
            self._started_timestamp = datetime.now()
            self.stream.emit(self)
            self.status = "running"
        device_chunk = min(device_chunk, self._chunk_cap())
        try:
            while True:
                n = self._full_steps(device_chunk)
                if n < 1:
                    break
                before = time.monotonic()
                t2, snapshots, status = self._scheme.device_steps(
                    self.t, self.fields, n, self.dt, self.parameters,
                    hook=self._hook)
                elapsed = time.monotonic() - before
                self._last_running = elapsed / n
                self._total_running += elapsed
                self._last_timestamp = self._actual_timestamp
                self._actual_timestamp = datetime.now()
                for t_i, fields_i in snapshots:
                    self.t, self.fields = t_i, fields_i
                    self._emit(pbar, log)
                if status:
                    raise RuntimeError(self._scheme._failures[status])
            while not np.isclose(self.t, self.tmax):
                self.t, self.fields, self.parameters = self._compute_one_step(
                    self.t, self.fields, self.parameters)
                self._emit(pbar, log)
            self._end_simulation()
        except RuntimeError:
            self._fail()
            raise
        finally:
            if pbar is not None:
                pbar.close()
        return self.t, self.fields

    # ------------------------------------------------------------- plumbing
    def attach_container(self, path=None, save="all", mode="w",
                         nbuffer=50, force=False):
        """Attach a persistence container fed from the stream, in
        ``path/<id>`` (in memory with no path), the parameters as its
        metadata."""
        from ..plugins.container import Container

        self._container = Container(
            "%s/%s" % (path, self.id) if path else None, save=save,
            mode=mode, metadata=self.parameters, force=force,
            nbuffer=nbuffer)
        self._container.connect(self.stream)
        return self._container

    def save_checkpoint(self, path):
        """One-call restartable snapshot (t, i, dt, the scheme's internal
        dt, the fields, the parameters): ``utils.checkpoint``."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(path, self)

    @staticmethod
    def from_checkpoint(path, model, **kwargs):
        """Rebuild a Simulation from a checkpoint file and the (re)built
        model; extra kwargs (hook, scheme, tol, ...) are forwarded."""
        from ..utils.checkpoint import load_checkpoint

        return load_checkpoint(path, model, **kwargs)

    @property
    def post_processes(self):
        return self._pprocesses

    @property
    def stream(self):
        return self._stream

    @property
    def container(self):
        return self._container

    @property
    def timer(self):
        return Timer(self._last_running, self._total_running)

    def add_post_process(self, name, post_process, description=""):
        """Register a per-step callback taking the simulation."""
        self._pprocesses.append(PostProcess(name, post_process, description))
        self._pprocesses[-1].function(self)

    def remove_post_process(self, name):
        self._pprocesses = [pp for pp in self._pprocesses if pp.name != name]

    def __repr__(self):
        def stamp(ts):
            return ts.isoformat(" ", "seconds") if ts else "never"

        lines = [
            f" Simulation {self.id} ".center(40, "="),
            f"status      {self.status}",
            f"created     {stamp(self._created_timestamp)}",
            f"started     {stamp(self._started_timestamp)}",
            f"last step   {stamp(self._last_timestamp)}",
            "",
            f"t           {self.t:g}"
            + (f" / tmax {self.tmax:g}" if self.tmax else ""),
            f"iteration   {self.i}",
            f"timing      last {self._last_running:g}s, "
            f"total {self._total_running:g}s",
            "",
            "parameters:",
        ]
        lines += [f"  {key:<10} {pprint.pformat(value)}"
                  for key, value in self.parameters.items()]
        if self._hook is not null_hook:
            try:
                hook_src = inspect.getsource(self._hook).rstrip()
            except (OSError, TypeError):
                hook_src = repr(self._hook)
            lines += ["", "hook:", *("  " + ln for ln in hook_src.splitlines())]
        lines += ["", "model:", str(self.model), "=" * 40]
        return "\n".join(lines)

    def __iter__(self):
        return self.compute()

    def __next__(self):
        return next(self._iterator)
