"""Checkpoints: save and restore the full training state, in the JAX
package's ``.npz`` layout.

Port of ``backpacks_flash_attn_tpu/training/checkpoint.py``: one ``.npz`` per
checkpoint holding every array leaf keyed by its tree path joined with "/"
(:13-31), a JSON meta file beside it, keep-last-k pruning, a crash
auto-save, and resume from the newest file. The training state is written
under the paths of the JAX state (``TrainState(params, opt_state, step)``
with optax's AdamW chain: ``opt_state/1/0/{count,mu,nu}`` and
``opt_state/1/2/count``), so checkpoints cross between the two packages.
bf16 leaves are stored as 2-byte void records, as numpy stores the JAX
package's bfloat16 arrays, so reading them needs no ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .ema import EMAState
from .train import TrainState, _state_tree, named_leaves

SEP = "/"
AUTO_SAVE = "auto_save.ckpt.npz"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
        return out
    return {prefix[:-len(SEP)]: _to_numpy(tree)}


def _from_numpy(arr: np.ndarray, example):
    """arr shaped and typed like ``example`` (a tensor or a numpy value)."""
    if isinstance(example, torch.Tensor):
        if arr.dtype.kind == "V":           # bf16 records
            t = torch.from_numpy(np.array(arr.view(np.int16))).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(example.dtype)
    return np.asarray(arr).astype(np.asarray(example).dtype)


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}{SEP}")
                for k, v in template.items()}
    key = prefix[:-len(SEP)]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return _from_numpy(flat[key], template)


# ------------------------------------------------------------ state trees

def _tree_like(paths, tensors) -> dict:
    out: dict = {}
    for path, t in zip(paths, tensors):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def train_state_tree(state: TrainState) -> dict:
    """The JAX TrainState's tree: params, optax's AdamW moments and counts,
    step (int32). A sharded step's state (``train.make_sharded_train_step``)
    gives the whole tree on every rank: its slices gathered. Under
    gradient accumulation also "accum": the calls into the current
    accumulation and the running mean of their gradients."""
    opt = state.opt_state
    sharding = getattr(opt, "sharding", None)
    if sharding is not None:
        tree = sharding.state_tree(state)
    else:
        mu, nu = [], []
        for p in opt.params:
            st = opt.adamw.state.get(p, {})
            mu.append(st.get("exp_avg", torch.zeros_like(p)))
            nu.append(st.get("exp_avg_sq", torch.zeros_like(p)))
        tree = _state_tree(state.params, _tree_like(opt.paths, mu),
                           _tree_like(opt.paths, nu), opt.update_count(), state.step)
    if opt.accum_steps > 1:
        acc = opt.acc if opt.acc is not None else [torch.zeros_like(p) for p in opt.params]
        tree["accum"] = {"mini_step": np.int32(opt.mini_step),
                         "acc": (sharding.global_tree(acc, opt=True) if sharding is not None
                                 else _tree_like(opt.paths, acc))}
    return tree


@torch.no_grad()
def load_train_state(state: TrainState, tree: dict) -> TrainState:
    """Copy a restored ``train_state_tree`` into ``state`` in place (a
    sharded state takes its slices)."""
    opt = state.opt_state
    sharding = getattr(opt, "sharding", None)
    if sharding is not None:
        sharding.load_state_tree(state, tree)
    else:
        adam = tree["opt_state"]["1"]["0"]
        mu = dict(named_leaves(adam["mu"]))
        nu = dict(named_leaves(adam["nu"]))
        new = dict(named_leaves(tree["params"]))
        count = int(adam["count"])
        for path, p in zip(opt.paths, opt.params):
            p.copy_(new[path].to(p.device))
            opt.adamw.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[path].to(device=p.device, dtype=p.dtype),
                "exp_avg_sq": nu[path].to(device=p.device, dtype=p.dtype)}
        state.step = int(tree["step"])
    if "accum" in tree:
        acc = tree["accum"]["acc"]
        local = (sharding.local_tensors(acc, opt=True) if sharding is not None
                 else [dict(named_leaves(acc))[path] for path in opt.paths])
        opt.acc = [a.to(device=p.device, dtype=p.dtype) for a, p in zip(local, opt.params)]
        opt.mini_step = int(tree["accum"]["mini_step"])
    return state


def ema_tree(ema: EMAState) -> dict:
    return {"shadow": ema.shadow, "num_updates": np.int32(ema.num_updates)}


@torch.no_grad()
def load_ema(ema: EMAState, tree: dict) -> EMAState:
    new = dict(named_leaves(tree["shadow"]))
    for path, s in named_leaves(ema.shadow):
        s.copy_(new[path].to(s.device))
    ema.num_updates = int(tree["num_updates"])
    return ema


# ------------------------------------------------------------ files

def save(ckpt_dir: str, state, *, step: int,
         meta: Optional[Dict[str, Any]] = None,
         name: Optional[str] = None, keep_last: int = 3) -> str:
    """Write ``state`` (a nested dict of tensors and numpy values) at
    ``step``; prune the periodic checkpoints to the newest keep_last."""
    os.makedirs(ckpt_dir, exist_ok=True)
    fname = name or f"step_{step:08d}.ckpt.npz"
    path = os.path.join(ckpt_dir, fname)
    payload = _flatten(state)
    payload["__step__"] = np.asarray(step, np.int64)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)  # atomic publish: no torn checkpoints on crash
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
    if name is None:
        _prune(ckpt_dir, keep_last)
    return path


def _prune(ckpt_dir: str, keep_last: int) -> None:
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".ckpt.npz"))
    for f in ckpts[:-keep_last] if keep_last > 0 else []:
        os.remove(os.path.join(ckpt_dir, f))
        meta = os.path.join(ckpt_dir, f + ".json")
        if os.path.exists(meta):
            os.remove(meta)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest of the periodic checkpoints and the crash auto-save (mtime)."""
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                  if f.endswith(".ckpt.npz")]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def restore(path: str, state_template) -> Tuple[Any, int, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``state_template`` (tensors
    come back as CPU tensors of the template's dtype). Returns (state,
    step, meta)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", np.asarray(0)))
    meta = {}
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return _unflatten_into(state_template, flat), step, meta


class auto_save_on_exception:
    """Context manager: on any exception, write an auto-save checkpoint
    before re-raising. The state is read lazily through ``get_state`` so it
    reflects the moment of the crash."""

    def __init__(self, ckpt_dir: str, get_state, get_step,
                 meta: Optional[Dict[str, Any]] = None):
        self.ckpt_dir = ckpt_dir
        self.get_state = get_state
        self.get_step = get_step
        self.meta = meta

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            return False
        if issubclass(exc_type, KeyboardInterrupt):
            save(self.ckpt_dir, self.get_state(), step=int(self.get_step()),
                 meta=self.meta, name=AUTO_SAVE)
            return False
        try:
            save(self.ckpt_dir, self.get_state(), step=int(self.get_step()),
                 meta=self.meta, name=AUTO_SAVE)
        except (OSError, ValueError, RuntimeError):
            pass  # never mask the original error
        return False
