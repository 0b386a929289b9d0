"""Checkpoint / resume for the TT solvers — port of
``c3sc_tpu/utils/checkpoint.py``, in the same file layout.

Reference mechanism: FT serialization (``valuef_save`` /
``function_train_save``, SURVEY.md §5). A checkpoint carries the whole
solver state: padded TT cores + ranks, the cross pivot index sets, the
outer-loop iteration and, for the fused solver, every field of its
``FusedCarry``, so a killed run resumes mid-iteration.

The files are the JAX package's: the same npz keys and the same JSON
``meta``, so a file either package writes loads in the other, field for
field, each package casting to its own dtypes. The one difference is the
random state. The JAX package stores its key as ``key_data``; the port seeds
from integers (``seeds.SeedStream``, the restart draws of ``fused_tt_vi``)
and stores the state of that stream under ``meta["seed_stream"]``, a key
that the JAX package's loaders ignore. The port never writes ``key_data``
and ignores it on load: a JAX-written ``tt_vi`` checkpoint resumes in the
port with a stream drawn from the caller's ``seed``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.ops.cross import CrossState
from c3sc_tpu_torch.ops.tt import TT


def _numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _meta(data) -> dict:
    return json.loads(bytes(data["meta"]).decode())


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_solver_state(path: str, v: TT, state: CrossState | None, iteration: int,
                      stream: dict | None = None, extras: dict | None = None) -> None:
    """The state of a ``tt_vi`` run: its TT, its cross index sets, the
    iteration just done, ``stream`` (``SeedStream.state()``) and ``extras``."""
    arrays = {f"core_{k}": _numpy(c) for k, c in enumerate(v.cores)}
    arrays["ranks"] = _numpy(v.ranks).astype(np.int32)
    meta = {"d": v.ndim, "iteration": int(iteration)}
    if state is not None:
        for k, a in enumerate(state.left):
            arrays[f"left_{k}"] = np.asarray(a)
        for k, a in enumerate(state.right):
            arrays[f"right_{k}"] = np.asarray(a)
        meta["has_state"] = True
    if extras:
        meta["extras"] = extras
    if stream is not None:
        meta["seed_stream"] = stream
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_solver_state(path: str, device=None) -> dict:
    """A file of either package's ``save_solver_state``: ``v`` (on
    ``device``; None: the default CUDA device), ``iteration``, ``extras``,
    and ``state`` (int64 index sets) and ``seed_stream`` where it holds
    them."""
    dev = resolve_device(device)
    with np.load(path) as data:
        meta = _meta(data)
        d = meta["d"]
        v = TT(tuple(torch.as_tensor(data[f"core_{k}"], device=dev) for k in range(d)),
               torch.as_tensor(np.asarray(data["ranks"], np.int32), device=dev))
        out = {"v": v, "iteration": meta["iteration"], "extras": meta.get("extras", {})}
        if meta.get("has_state"):
            out["state"] = CrossState(
                left=[np.array(data[f"left_{k}"], np.int64) for k in range(d + 1)],
                right=[np.array(data[f"right_{k}"], np.int64) for k in range(d + 1)])
    if "seed_stream" in meta:
        out["seed_stream"] = meta["seed_stream"]
    return out


_FUSED_SIMPLE_FIELDS = (
    "ranks", "left", "right", "rl", "rr", "rlf", "rrf", "rows_l", "rows_r",
    "it", "residual", "long_res", "wstall", "v_sample", "sample_ref",
    "probe_cost", "best_cost", "ranks_best", "frozen", "freeze_mark",
    "best_long", "best_absdisp", "warm_until",
)


def save_fused_carry(path: str, carry, context: dict | None = None,
                     stream: dict | None = None) -> None:
    """Serialize the whole fused-solver state (``FusedCarry``), atomically: a
    temporary file renamed over the target. ``context`` (``fused_context``)
    records what the carry was solved for; ``stream`` is the state of the
    restarts' seed draws (``{"rng": bit_generator.state}``)."""
    arrays = {f"core_{k}": _numpy(c) for k, c in enumerate(carry.cores)}
    for k, c in enumerate(carry.cores_best):
        arrays[f"core_best_{k}"] = _numpy(c)
    for name in _FUSED_SIMPLE_FIELDS:
        arrays[name] = _numpy(getattr(carry, name))
    meta = {"d": len(carry.cores), "kind": "fused_carry"}
    if context:
        meta["context"] = context
    if stream is not None:
        meta["seed_stream"] = stream
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = _npz(path) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, _npz(path))


def fused_context(problem, grid, rmax: int) -> dict:
    """The identity block written into (and checked against) fused
    checkpoints: which solve this carry belongs to."""
    return {
        "problem": getattr(problem, "name", "problem"),
        "grid_shape": list(grid.shape),
        "lb": [float(x) for x in grid.lb],
        "ub": [float(x) for x in grid.ub],
        "rmax": int(rmax),
    }


def is_fused_checkpoint(path: str) -> bool:
    """True iff the npz at path was written by ``save_fused_carry``."""
    try:
        with np.load(_npz(path)) as data:
            return _meta(data).get("kind") == "fused_carry"
    except Exception:
        return False


def checkpoint_seed_stream(path: str) -> dict | None:
    """The seed stream's state a checkpoint of either kind holds (None in a
    file the JAX package wrote)."""
    with np.load(_npz(path)) as data:
        return _meta(data).get("seed_stream")


def load_fused_carry(path: str, expect: dict | None = None, device=None):
    """Restore a ``FusedCarry`` saved by either package's
    ``save_fused_carry``, on ``device`` (None: the default CUDA device).

    ``expect`` (the keys of ``fused_context``) is checked against the
    context the checkpoint recorded: a mismatch raises ``ValueError`` (a
    coincidentally same-shaped grid of another problem would otherwise
    resume silently into a wrong solve). rmax is not checked: rank growth
    legitimately resumes at another cap."""
    from c3sc_tpu_torch.convert import fused_carry_from_numpy

    with np.load(_npz(path)) as data:
        meta = _meta(data)
        if meta.get("kind") != "fused_carry":
            raise ValueError(
                f"{path} is not a fused solver checkpoint (kind={meta.get('kind')!r}); pass "
                "a solver_state.npz written by save_fused_carry, or load it as a plain "
                "value function")
        saved = meta.get("context")
        if expect is not None and saved is not None:
            for k in ("problem", "grid_shape", "lb", "ub"):
                if k in saved and saved[k] != expect[k]:
                    raise ValueError(
                        f"checkpoint {path} was written for {saved.get('problem')!r} "
                        f"grid={saved.get('grid_shape')} bounds=[{saved.get('lb')}, "
                        f"{saved.get('ub')}], but this solve is {expect['problem']!r} "
                        f"grid={expect['grid_shape']} (mismatch on {k!r})")
        d = meta["d"]
        fields = {name: data[name] for name in _FUSED_SIMPLE_FIELDS if name in data}
        fields["cores"] = [data[f"core_{k}"] for k in range(d)]
        fields["cores_best"] = [data[f"core_best_{k}"] for k in range(d)]
    # fields added after a checkpoint was written default as the JAX
    # package's loader defaults them
    fields.setdefault("best_absdisp", np.float32(np.inf))
    fields.setdefault("rlf", fields["rl"])
    fields.setdefault("rrf", fields["rr"])
    return fused_carry_from_numpy(fields, resolve_device(device))
