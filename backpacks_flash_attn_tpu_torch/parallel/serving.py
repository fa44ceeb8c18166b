"""Multi-device serving: the decode step with slots sharded over 'data'.

Port of ``backpacks_flash_attn_tpu/parallel/serving.py``. Over a ('data',
'model') mesh (``parallel/mesh.make_mesh``):

  * 'data': serving slots (batch rows) shard over the ranks. Each rank owns
    its slots' cache rows (the flat-E layouts are batch-major, so a
    contiguous E split is a slot split) and decodes them with the
    single-device step, ``models/backpack.backpack_forward_with_cache``
    (K1, K2 and the rest of its kernels on the card), with no collectives.
    This is the throughput parallelism for Backpack-scale models.
  * 'model' (``tp_params=True``): each rank keeps only its slices of the
    parameters under the Megatron specs of ``parallel/mesh.py``
    (``shard_params``) and gathers every leaf's slices over 'model' when a
    step uses them (``gather_params``), then computes its slots' whole step
    itself: the parameter storage of JAX's pjit path, where XLA inserts the
    all-gathers. The Megatron split of the COMPUTE is
    ``parallel/tp_decode.py``'s. INT4 trees, which tp_decode refuses, take
    this path.

torch has one process a rank: the step takes and returns this rank's rows
(``mesh.data_rows`` cuts them from a global batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from . import mesh as mesh_lib


def cache_specs(cache: bp.BackpackCache) -> bp.BackpackCache:
    """Specs sharding a cache's slots over 'data' (JAX :35): the flat E axes
    are batch-major, so ('data', ...) on them splits slots. A staged cache
    raises (flush it first)."""
    if cache.staged:
        raise ValueError("cache_specs takes an unstaged cache (flush it first)")
    g = cache.gpt
    vec = isinstance(cache.length, torch.Tensor) and cache.length.dim() == 1

    def opt(spec, x):
        return spec if x is not None else None
    length = ("data",) if vec else ()
    return bp.BackpackCache(
        gpt=dataclasses.replace(
            g, k=(None, "data", None, None), v=(None, "data", None, None),
            length=length, k_scale=opt((None, "data", None), g.k_scale),
            v_scale=opt((None, "data", None), g.v_scale)),
        ctx_k=("data", None, None), content=("data", None, None), length=length,
        content_scale=opt(("data", None), cache.content_scale),
        ctx_k_scale=opt(("data", None), cache.ctx_k_scale))


def shard_cache(cache: bp.BackpackCache, mesh) -> bp.BackpackCache:
    """This rank's slots of a cache (JAX :63): contiguous copies of its
    rows."""
    return mesh_lib.shard_tree(cache, cache_specs(cache), mesh)


def make_sharded_decode_step(cfg: BackpackConfig, mesh, *, tp_params: bool = False):
    """-> (step, prepare) (JAX :67). step(params, tokens, cache) -> (logits
    (b_loc, s, V), cache): this rank's slots through
    ``backpack_forward_with_cache`` (prefill or decode; the cache updated in
    place), params replicated (the default, right for models up to ~1B) or,
    with ``tp_params``, this rank's 'model' slices, gathered for the step.
    prepare(params, cache) -> this rank's params (the whole tree, or its
    ``shard_params`` slices) and its slots of the cache
    (:func:`shard_cache`)."""

    @torch.no_grad()
    def step(params, tokens, cache):
        if tp_params:
            params = mesh_lib.gather_params(params, cfg, mesh)
        return bp.backpack_forward_with_cache(params, cfg, tokens, cache)

    def prepare(params: Any, cache: bp.BackpackCache):
        if tp_params:
            params = mesh_lib.shard_params(params, cfg, mesh)
        return params, shard_cache(cache, mesh)

    return step, prepare
