"""Replay a function of CUDA tensors as a CUDA graph.

The ADMM check intervals that launch no hand-written kernel (the dense
route of ``solvers/banded.py`` and the CG method of ``solvers/admm.py``)
are hundreds to thousands of small PyTorch launches an iteration and no
host read, so on the card their time is the host's.  :func:`graphed` runs
such a function eagerly on its first call (the warm-up), captures it into a
CUDA graph on its second and replays the graph on every later call.  The
kernel routes are not graphed: their wrappers count launches on the host.
Inside a call checked by ``utils/debug.py`` the function runs eagerly, so
that the sanitizer sees its operations.
"""

from __future__ import annotations

import torch

from . import debug


def _flatten(tree, out):
    """The tensors of a nested tuple, in order, and its structure."""
    if isinstance(tree, tuple):
        return type(tree), [_flatten(t, out) for t in tree]
    out.append(tree)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, parts = spec
    vals = [_unflatten(p, it) for p in parts]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def graphed(fn):
    """``fn`` over (nested tuples of) CUDA tensors of fixed shapes, whose
    outputs are (nested tuples of) tensors, and which reads nothing on the
    host.  On CPU tensors, and inside a checked call, it is ``fn``.  On CUDA tensors the first call runs
    ``fn``, the second captures it into a CUDA graph on copies of its
    inputs, and each call from the second on copies the inputs into the
    graph's, replays it and returns copies of its outputs: the same kernels
    on the same values as an eager call."""
    state = {}

    def run(*args):
        flat = []
        spec = _flatten(args, flat)
        if not flat[0].is_cuda or debug.active():
            return fn(*args)
        if "graph" not in state:
            if not state.get("warm"):
                state["warm"] = True
                return fn(*args)
            inputs = [t.clone() for t in flat]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(*_unflatten(spec, iter(inputs)))
            state.update(graph=graph, inputs=inputs, out=out)
        for dst, src in zip(state["inputs"], flat):
            dst.copy_(src)
        state["graph"].replay()
        outs = []
        out_spec = _flatten(state["out"], outs)
        return _unflatten(out_spec, iter([t.clone() for t in outs]))
    return run
