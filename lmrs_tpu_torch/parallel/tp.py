"""Tensor parallelism: the sharded loader, and the mesh Engine and
scheduler entry points.

`shard_tensors` cuts a .lmrs file's tensors into one rank's blocks (the
split plan of `parallel.sharding`): each block a fresh contiguous array,
so that every kernel wrapper's alignment check holds.  With the layout's
row concatenations this gives rank r the wqkv rows [q_r; k_r; v_r] and the
w13 rows [gate_r; up_r] in logical order, the JAX package's interleaved
rows (`lmrs_tpu/parallel/tp.py` `_interleave_rows`); wo and w2 split on
the input axis at group edges, where a Q4 byte's two values and a scale's
group never straddle two ranks.  With cp alone every rank holds all the
weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from lmrs_tpu_torch.config import ModelConfig, local_config
from lmrs_tpu_torch.parallel.sharding import (COLUMN, ROW, VOCAB,
                                              tp_param_shardings)


def _block(a: np.ndarray, axis: int, r: int, tp: int) -> np.ndarray:
    n = a.shape[axis] // tp
    return np.ascontiguousarray(np.take(a, np.arange(r * n, (r + 1) * n),
                                        axis=axis))


def shard_tensors(cfg: ModelConfig, tensors: Dict[str, Tuple], tp: int,
                  rank: int) -> Dict[str, Tuple]:
    """Rank `rank`'s blocks of the (values, scales) host arrays of a .lmrs
    file (`LmrsFile.tensors`: file layout, keyed by layout name)."""
    plan = tp_param_shardings(cfg, tp)
    out = {}
    for key, (q, s) in tensors.items():
        kind = plan.get(key.split("@")[0])
        q = np.asarray(q)
        if kind in (COLUMN, VOCAB):
            out[key] = (_block(q, 0, rank, tp),
                        None if s is None else _block(np.asarray(s), 0,
                                                      rank, tp))
        elif kind == ROW:
            # the packed values and the group scales split on their input
            # axis; tp divides the groups, so a block holds whole groups
            s2 = None if s is None else np.asarray(s).reshape(q.shape[0], -1)
            out[key] = (_block(q, 1, rank, tp),
                        None if s2 is None else _block(s2, 1, rank, tp))
        else:
            out[key] = (q, s)
    return out


def tp_params(f, cfg: ModelConfig, tp: int, rank: int, device):
    """One rank's TransformerParams (its local config's shapes) from a
    parsed .lmrs file, onto `device`."""
    from lmrs_tpu_torch.io.params import _params_from_tensors

    if tp == 1:
        return _params_from_tensors(cfg, f.tensors, device)
    return _params_from_tensors(local_config(cfg, tp),
                                shard_tensors(cfg, f.tensors, tp, rank),
                                device)


def _open(f, seq_len=None):
    """A parsed .lmrs file from a path or a parsed file, with an optional
    context override (the CLI's --seq-len)."""
    from lmrs_tpu_torch.io.lmrs import read_lmrs

    if isinstance(f, str) or hasattr(f, "__fspath__"):
        f = read_lmrs(str(f))
    if seq_len:
        f.cfg = f.cfg.replace(seq_len=seq_len)
    return f


def make_mesh_engine(f, tp: int = 1, cp: int = 1, device=None,
                     mesh=None, **engine_kw):
    """The product entry point of --tp/--cp: a parsed .lmrs file (or its
    path) -> an Engine over a (tp, cp) mesh of ranks (`parallel.
    distributed.Mesh`; started here unless `mesh` is given).  The engine's
    API is the one-device Engine's."""
    from lmrs_tpu_torch.parallel.distributed import Mesh
    from lmrs_tpu_torch.runtime.engine import Engine

    if tp * cp < 2 and mesh is None:
        raise ValueError("make_mesh_engine needs tp>1 or cp>1")
    f = _open(f)
    mesh = mesh or Mesh.start(f, tp=tp, cp=cp, device=device)
    return Engine(mesh.cfg, mesh.params, mesh=mesh, **engine_kw)


def make_mesh_scheduler(f, tp: int = 1, cp: int = 1, device=None,
                        mesh=None, **sched_kw):
    """--batch with --tp/--cp: the continuous-batching scheduler over a
    (tp, cp) mesh of ranks; every step's matmuls shard on tp and, with cp,
    the per-slot cache's sequence axis shards on cp."""
    from lmrs_tpu_torch.parallel.distributed import Mesh
    from lmrs_tpu_torch.serve.scheduler import BatchScheduler

    if tp * cp < 2 and mesh is None:
        raise ValueError("make_mesh_scheduler needs tp>1 or cp>1")
    f = _open(f)
    mesh = mesh or Mesh.start(f, tp=tp, cp=cp, device=device)
    return BatchScheduler(mesh.cfg, mesh.params, mesh=mesh, **sched_kw)
