"""Checkpoint / resume (counterpart of
``ba_path_planning_tpu.utils.checkpoint``; the files are the same npz and
JSON, so either package reads the other's).

The reference persists nothing but terminal benchmark records and discards
trajectories (``compute_trajectories_batch.py:51, 153-164``).  Here, batch
results are persisted as columnar npz + JSON meta, and long batch runs are
resumable at chunk granularity: every chunk of scenarios is saved as it
completes, and a rerun with the same run directory skips finished chunks.
Everything is reproducible from (seed, config), which are stored in the meta.
Results may hold tensors on any device; they are copied to the host before
they are saved, and loaded results are numpy arrays.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_result(path, result, meta: dict | None = None) -> None:
    """Persist an SCPResult pytree (or any NamedTuple of arrays) to npz,
    with optional JSON metadata sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: _host(v) for k, v in result._asdict().items()}
    np.savez_compressed(path, **arrays)
    if meta is not None:
        Path(str(path) + ".meta.json").write_text(json.dumps(meta, indent=2))


def load_result(path, result_cls):
    """Load an npz checkpoint back into ``result_cls`` (a NamedTuple type)."""
    with np.load(path) as z:
        return result_cls(**{k: z[k] for k in result_cls._fields})


def load_meta(path) -> dict | None:
    p = Path(str(path) + ".meta.json")
    return json.loads(p.read_text()) if p.exists() else None


class ChunkedRun:
    """Chunk-granular resumable batch run.

    Usage:
        run = ChunkedRun(run_dir, config_dict)
        for idx, (lo, hi) in run.pending(total, chunk):
            result = solve(chunk_inputs)          # only unfinished chunks
            run.save_chunk(idx, result)
        merged = run.merge(result_cls)

    A rerun with the same ``run_dir`` and an equal config skips completed
    chunks; a config mismatch raises (protects against silently mixing runs).
    """

    def __init__(self, run_dir, config: dict):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.config = config
        cfg_path = self.dir / "run_config.json"
        if cfg_path.exists():
            existing = json.loads(cfg_path.read_text())
            if existing != json.loads(json.dumps(config)):
                raise ValueError(
                    f"run dir {run_dir} holds a different config; refuse to "
                    f"mix checkpoints")
        else:
            cfg_path.write_text(json.dumps(config, indent=2))

    def _chunk_path(self, idx: int) -> Path:
        return self.dir / f"chunk_{idx:05d}.npz"

    def done(self, idx: int) -> bool:
        return self._chunk_path(idx).exists()

    def pending(self, total: int, chunk: int):
        """Yield (idx, (lo, hi)) for chunks not yet completed."""
        n_chunks = (total + chunk - 1) // chunk
        for idx in range(n_chunks):
            if not self.done(idx):
                yield idx, (idx * chunk, min((idx + 1) * chunk, total))

    def save_chunk(self, idx: int, result) -> None:
        tmp = self._chunk_path(idx).with_suffix(".tmp.npz")
        arrays = {k: _host(v) for k, v in result._asdict().items()}
        np.savez_compressed(tmp, **arrays)
        tmp.rename(self._chunk_path(idx))

    def merge(self, result_cls, total: int | None = None,
              chunk: int | None = None):
        """Concatenate all chunk results along the batch axis, in order.

        When ``total``/``chunk`` are given (the expected scenario count and
        chunk size of the run), the merge validates completeness: every chunk
        index in [0, ceil(total/chunk)) must be present, no stray chunk files
        from another layout may exist, and the merged batch length must equal
        ``total``.  This refuses to return a silently truncated or garbled
        batch when a run was killed before finishing or when chunk files from
        a different chunking layout are present in the directory.
        """
        chunks = sorted(self.dir.glob("chunk_*.npz"))
        if not chunks:
            raise FileNotFoundError(f"no chunks in {self.dir}")
        indices = [int(c.stem.split("_")[1]) for c in chunks]
        if total is not None and chunk is not None:
            n_chunks = (total + chunk - 1) // chunk
            missing = sorted(set(range(n_chunks)) - set(indices))
            extra = sorted(set(indices) - set(range(n_chunks)))
            if missing or extra:
                raise ValueError(
                    f"incomplete/inconsistent run in {self.dir}: "
                    f"missing chunks {missing}, unexpected chunks {extra} "
                    f"(expected {n_chunks} chunks of {chunk} for "
                    f"{total} scenarios)")
        elif indices != list(range(len(indices))):
            raise ValueError(
                f"non-contiguous chunk indices in {self.dir}: {indices}")
        loaded = [load_result(c, result_cls) for c in chunks]
        merged = result_cls(*[np.concatenate([getattr(r, f) for r in loaded])
                              for f in result_cls._fields])
        if total is not None:
            got = len(getattr(merged, result_cls._fields[0]))
            if got != total:
                raise ValueError(
                    f"merged batch length {got} != expected {total} "
                    f"(chunk files do not cover the run exactly)")
        return merged
