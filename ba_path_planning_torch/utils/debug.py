"""Numerical sanitizer (counterpart of ``ba_path_planning_tpu.utils.debug``,
which is built on ``jax.experimental.checkify``).

An opt-in harness that instruments a solve callable with float checks and
postconditions on its result, without touching the production path::

    from ba_path_planning_torch.utils.debug import checked
    fn = checked(engine.solve_fn())         # same signature
    err, res = fn(p0, v0, pf, vf)
    err.throw()                             # raises with the first failed check

The checks are checkify's ``float_checks``: a NaN in the output of an
operation, and a division whose divisor holds a zero.  Inf is not a
failure: the solver's open bounds are +-inf by design.  They run in a
``TorchDispatchMode`` that sees every PyTorch operation of the call.  The
hand-written CUDA kernels are bound through ``ctypes`` and never pass the
dispatcher, so their wrappers hand their outputs to :func:`report`, which
checks them while a harness is active and returns at once otherwise.  A
CUDA-graph replay (``utils/graphs.py``) would hide its operations from the
mode, so graphs are not used inside a checked call: it runs eagerly.

Each check is a device flag: the index of the first operation that failed
is kept on the device, and only ``throw()`` (or ``get()``) reads it, once.
Uninitialised allocations (``empty`` and its kin) are not checked: their
contents are undefined until something writes them, and what writes them is
checked.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: NaN in the output of an operation
NAN_CHECKS = frozenset({"nan"})
#: a division by a divisor that holds a zero
DIV_CHECKS = frozenset({"div"})
#: checkify's ``float_checks``: both of the above
FLOAT_CHECKS = NAN_CHECKS | DIV_CHECKS

_aten = torch.ops.aten
# operations whose output is uninitialised memory
_UNINITIALISED = {_aten.empty.memory_format, _aten.empty_like.default,
                  _aten.empty_strided.default, _aten.new_empty.default,
                  _aten.new_empty_strided.default}
# the divisions (``lax.div_p``); their divisor is the second argument
_DIVISIONS = {_aten.div.Tensor, _aten.div.Scalar, _aten.div.Tensor_mode,
              _aten.div.Scalar_mode, _aten.div_.Tensor, _aten.div_.Scalar,
              _aten.div_.Tensor_mode, _aten.div_.Scalar_mode,
              _aten.floor_divide.default, _aten.floor_divide_.Tensor}

# the harnesses now running, innermost last (:func:`report` checks with it)
_active: list = []


class CheckError:
    """The outcome of a checked call: the first failed check, if any."""

    def __init__(self, mode: "_SanitizerMode", cause=None):
        self._mode = mode
        self._cause = cause

    def get(self) -> str | None:
        """The message of the first failed check, or None (one host read
        a device)."""
        return self._mode.message()

    def throw(self) -> None:
        """Raise ``FloatingPointError`` with the first failed check."""
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg) from self._cause


def _is_view(func) -> bool:
    """True for an operation whose outputs alias its inputs without writing
    them (a view): it computes no value, so its output is not checked."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _SanitizerMode(TorchDispatchMode):
    """Checks every operation's output on its device.  The 0-d flags of the
    checks gather on their device and are folded, FLUSH at a time, into the
    index of the first failed check; the description of every check site
    stays on the host."""

    FLUSH = 512

    def __init__(self, errors=FLOAT_CHECKS):
        super().__init__()
        self.errors = frozenset(errors)
        self.first: dict = {}       # device -> int64 0-d: first failed, or -1
        self.pending: dict = {}     # device -> [(site index, 0-d bool flag)]
        self.host_first = None      # first failed check known on the host
        self.what: list = []        # (kind, operation) of each check site
        self.inner = False          # the checks' own operations pass
        self._views: dict = {}

    def record(self, bad, kind: str, op) -> None:
        """Record a check of ``kind`` at ``op``, failed where ``bad`` (a
        0-d bool tensor, or a Python bool) is true."""
        idx = len(self.what)
        self.what.append((kind, op))
        if not isinstance(bad, torch.Tensor):
            if bad and self.host_first is None:
                self.host_first = idx
            return
        pending = self.pending.setdefault(bad.device, [])
        pending.append((idx, bad))
        if len(pending) >= self.FLUSH:
            self._flush(bad.device)

    def _flush(self, device) -> None:
        pending = self.pending.pop(device, [])
        if not pending:
            return
        idxs = torch.tensor([i for i, _ in pending], device=device)
        hits = torch.stack([b for _, b in pending])
        found = idxs[torch.argmax(hits.to(torch.int8))]
        first = self.first.get(device)
        if first is None:
            first = torch.full((), -1, dtype=torch.int64, device=device)
        self.first[device] = torch.where((first < 0) & hits.any(), found,
                                         first)

    def check_nan(self, outputs, op) -> None:
        if "nan" not in self.errors:
            return
        for t in outputs:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel()):
                self.record(torch.isnan(t).any(), "nan", op)

    def message(self) -> str | None:
        """The first failed check's description, or None: one host read
        a device."""
        self.inner = True
        try:
            for device in list(self.pending):
                self._flush(device)
            hits = [int(f) for f in self.first.values()]
        finally:
            self.inner = False
        hits = [i for i in hits + [self.host_first]
                if i is not None and i >= 0]
        if not hits:
            return None
        kind, op = self.what[min(hits)]
        return (f"nan in the output of {op}" if kind == "nan"
                else f"division by zero in {op}" if kind == "div" else kind)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.inner:
            return func(*args, **kwargs)
        if "div" in self.errors and func in _DIVISIONS:
            divisor = args[1]
            self.record((divisor == 0).any()
                        if isinstance(divisor, torch.Tensor)
                        else divisor == 0, "div", func)
        out = func(*args, **kwargs)
        view = self._views.get(func)
        if view is None:
            view = self._views[func] = (func in _UNINITIALISED
                                        or _is_view(func))
        if not view:
            self.check_nan(tree_flatten(out)[0], func)
        return out

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)


def active() -> bool:
    """True while a checked call runs (``utils/graphs.py`` then runs
    eagerly)."""
    return bool(_active)


def report(kernel: str, *outputs) -> None:
    """Check the outputs of a hand-written kernel (which the dispatch mode
    cannot see) in the innermost running harness; free when none runs."""
    if not _active:
        return
    mode = _active[-1]
    mode.inner = True
    try:
        mode.check_nan(tree_flatten(outputs)[0], f"kernel {kernel}")
    finally:
        mode.inner = False


def _result_postconditions(mode: _SanitizerMode, res) -> None:
    """Explicit postconditions on an SCPResult-shaped result."""
    mode.record(~torch.isfinite(res.positions).all(),
                "non-finite positions in SCP result", None)
    mode.record(~torch.isfinite(res.accelerations).all(),
                "non-finite accelerations in SCP result", None)
    mode.record((res.iterations < 0).any(), "negative iteration count", None)


def checked(solve_fn, errors=FLOAT_CHECKS, postconditions=True):
    """Wrap a solve callable with the sanitizer.

    Returns a function with the same signature whose result is
    ``(error, result)``; ``error.throw()`` raises with the first failed
    check.  No host read is added inside the call."""

    @functools.wraps(solve_fn)
    def run(*args, **kwargs):
        mode = _SanitizerMode(errors)
        try:
            with mode:
                res = solve_fn(*args, **kwargs)
        except Exception as exc:
            # an exception that a failed check let through (a NaN that
            # reached a library call which raises) is the check's outcome
            if mode.message() is None:
                raise
            return CheckError(mode, exc), None
        if postconditions:
            _result_postconditions(mode, res)
        return CheckError(mode), res

    return run


def checked_jit(solve_fn, errors=FLOAT_CHECKS, postconditions=True):
    """:func:`checked` under the JAX package's name (the port has no jit)."""
    return checked(solve_fn, errors=errors, postconditions=postconditions)


def find_nan_lanes(res) -> torch.Tensor:
    """Boolean (B,) mask of batch lanes whose trajectories contain NaN/Inf:
    host-side triage of batched results (which lane poisoned the batch)."""
    bad_p = ~torch.isfinite(res.positions.flatten(1)).all(dim=-1)
    bad_a = ~torch.isfinite(res.accelerations.flatten(1)).all(dim=-1)
    return bad_p | bad_a
