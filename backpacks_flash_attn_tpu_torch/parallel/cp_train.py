"""Context-parallel training: the whole forward sequence-sharded.

Port of ``backpacks_flash_attn_tpu/parallel/cp_train.py``. Every
per-token computation (embeddings, LayerNorms, MLPs, the sense network, the
LM head, the cross-entropy) runs on this rank's chunk of the sequence, and
both attention-shaped contractions ride the ring (``ring_attention.py``):
the GPT stack's self-attention (the flash ring: K3 and K5 on the card, or
the einsum ring) and the Backpack contextualization (alpha is attention
whose values are the d-wide sense vectors, so the einsum ring computes sum_k
softmax_j(q_k . k_j) content_j with nv heads, summed over them).

The loss and gradients are the single-device ones, dropout included: the
step key is the same on every rank and each site derives its key by the
single-device chain (backpack_forward -> gpt_forward -> _block), the
attention masks hash GLOBAL (row, q, k) positions inside the ring, and
the per-token sites hash the chunk's element positions in the unsharded
(B, s, n_embd) tensor (``norms.dropout_add_layer_norm(dropout_idx=)``).
Rotary runs at each chunk's absolute offsets; attn_dwconv (a cross-token
convolution) is refused, and MoE blocks wait for ROADMAP Queue 1 item 7.

torch has one process a rank: ``ids`` is the GLOBAL batch on every rank;
each takes its data shard's rows (mesh dimension 'data') and its chunk of
the sequence ('seq'). The loss a rank returns is the global mean (an
all-reduce whose backward scales by 1 / world), and ``reduce_grads`` sums
the parameters' gradients over the world, which JAX's transpose of the
replicated parameters does; the train steps take the gradient norm after
it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models import backpack as bp
from ..models import gpt as gpt_lib
from ..ops import dense, norms, rotary
from ..ops.cross_entropy import cross_entropy
from ..training import train as train_lib
from ..utils import prng
from . import mesh as mesh_lib
from .ring_attention import (ring_attention_local, ring_flash_attention_local,
                             zigzag_ring_attention_local,
                             zigzag_ring_attention_local_einsum)

Params = Any


class _WorldMean(torch.autograd.Function):
    """The mean of every rank's value (JAX's pmean over 'seq' then
    'data'); the backward hands each rank 1 / world of the gradient, its
    share of the replicated output."""

    @staticmethod
    def forward(ctx, x):
        ctx.world = torch.distributed.get_world_size()
        buf = x.detach().float().reshape(1).clone()
        return (mesh_lib.all_reduce_(buf) / ctx.world).reshape(()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world


def _self_attention(cfg, attn_impl: str, zigzag: bool, use_attn_drop: bool):
    if attn_impl == "flash":
        impl = zigzag_ring_attention_local if zigzag else ring_flash_attention_local
    elif attn_impl == "einsum":
        impl = (zigzag_ring_attention_local_einsum if zigzag
                else ring_attention_local)
    else:
        raise ValueError(f"unknown attn_impl: {attn_impl!r}")

    def attn(q, k, v, ring, scale, arng, boff):
        if use_attn_drop:
            return impl(q, k, v, ring=ring, softmax_scale=scale,
                        dropout_p=cfg.attn_pdrop, dropout_rng=arng,
                        bh_offset=boff)
        return impl(q, k, v, ring=ring, softmax_scale=scale)

    return attn


def _make_local_loss(cfg, *, label_smoothing: float = 0.0,
                     attn_impl: str = "einsum", train: bool = False,
                     layout: str = "natural", model: str = "backpack"):
    """local_loss(params, ids, rng, mesh) -> (this rank's mean loss over
    its rows and chunk, its per-token losses (b, c) f32, detached) (JAX :56;
    the mean over the world is the caller's)."""
    if cfg.attn_dwconv:
        raise ValueError("attn_dwconv crosses chunk boundaries")
    if layout not in ("natural", "zigzag"):
        raise ValueError(f"unknown layout: {layout!r}")
    use_attn_drop = train and cfg.attn_pdrop > 0.0
    eps = cfg.layer_norm_epsilon
    zigzag = layout == "zigzag"
    self_attn = _self_attention(cfg, attn_impl, zigzag, use_attn_drop)
    ctx_attn = (zigzag_ring_attention_local_einsum if zigzag
                else ring_attention_local)

    def local_loss(params, ids, rng, mesh):
        gp = params["gpt"] if model == "backpack" else params
        if "moe" in gp["layers"]:
            raise NotImplementedError("MoE blocks are not ported yet "
                                      "(ROADMAP Queue 1 item 7)")
        ring = mesh_lib.ring_of(mesh, "seq")
        di, dn = mesh_lib.coord(mesh, "data")
        i, Sx = ring.rank, ring.size
        B = ids.shape[0]
        if B % dn:
            raise ValueError(f"batch {B} must divide by the data size {dn}")
        b = B // dn
        rows = ids[di * b:(di + 1) * b]
        x, y = rows[:, :-1], rows[:, 1:]
        s = x.shape[1]
        dev = ids.device
        if zigzag:
            if s % (2 * Sx):
                raise ValueError(f"sequence {s} must divide by 2 x {Sx}")
            c2 = s // (2 * Sx)
            c = 2 * c2
            off_a, off_b = i * c2, (2 * Sx - 1 - i) * c2
            cut = lambda t: torch.cat([t[:, off_a:off_a + c2],
                                       t[:, off_b:off_b + c2]], dim=1)
            pos = torch.cat([off_a + torch.arange(c2, device=dev),
                             off_b + torch.arange(c2, device=dev)])
        else:
            if s % Sx:
                raise ValueError(f"sequence {s} must divide by {Sx}")
            c = s // Sx
            off = i * c
            cut = lambda t: t[:, off:off + c]
            pos = off + torch.arange(c, device=dev)
        x_loc, y_loc = cut(x), cut(y)
        boff = di * b

        if train and rng is not None:
            # the single-device key chain, the same on every rank
            if model == "backpack":
                r_gpt, r_content = prng.split(rng)
            else:
                r_gpt, r_content = rng, None
            r_emb, r_layers = prng.split(r_gpt)
            layer_rngs = prng.split(r_layers, cfg.n_layer)
            # gidx is each element's flat position in the unsharded (B, s,
            # n_embd) tensor, which JAX hashes in int32: past 2**31 distant
            # elements would share masks, so refuse
            n_global = B * s * cfg.n_embd
            if n_global >= 2 ** 31:
                raise ValueError(
                    "CP per-token dropout indexes the global (B, S, n_embd) "
                    f"tensor in int32; B*S*n_embd = {n_global} >= 2**31 "
                    "would wrap. Reduce batch/seq or disable per-token "
                    "dropout (embd_pdrop=resid_pdrop=0).")
            gidx = (((torch.arange(b, device=dev)[:, None] + boff) * s
                     + pos[None, :])[:, :, None] * cfg.n_embd
                    + torch.arange(cfg.n_embd, device=dev))
        else:
            r_emb = r_content = layer_rngs = gidx = None

        det = not train
        hidden = gpt_lib.embed(gp, cfg, x_loc, pos[None])
        hidden, residual = norms.dropout_add_layer_norm(
            hidden, None, gp["ln_0"]["weight"], gp["ln_0"]["bias"],
            cfg.embd_pdrop if train else 0.0, eps, rng=r_emb,
            deterministic=det, dropout_idx=gidx)
        for li, scale in enumerate(gpt_lib._softmax_scales(cfg)):
            lp = gpt_lib.tree_index(gp["layers"], li)
            arng = r1 = r2 = None
            if layer_rngs is not None:
                r_attn, r1, r2 = prng.split(layer_rngs[li], 3)
                arng = r_attn if use_attn_drop else None
            qkv = dense.linear(hidden, lp["Wqkv"]).reshape(
                b, c, 3, cfg.n_head, cfg.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if cfg.rotary_emb_dim > 0:
                rot = lambda q_, k_, o_: rotary.apply_rotary_qk(
                    q_, k_, cfg.rotary_emb_dim, seqlen_offset=o_,
                    scale_base=cfg.rotary_emb_scale_base)
                if zigzag:
                    # the two sub-chunks sit at their own absolute offsets
                    qa, ka = rot(q[:, :c2], k[:, :c2], off_a)
                    qb, kb = rot(q[:, c2:], k[:, c2:], off_b)
                    q, k = torch.cat([qa, qb], dim=1), torch.cat([ka, kb], dim=1)
                else:
                    q, k = rot(q, k, off)
            ctx = self_attn(q, k, v, ring, scale, arng, boff)
            mixer_out = dense.linear(ctx.reshape(b, c, cfg.n_embd),
                                     lp["out_proj"])
            hidden, residual = norms.dropout_add_layer_norm(
                mixer_out, residual, lp["norm1"]["weight"], lp["norm1"]["bias"],
                cfg.resid_pdrop if train else 0.0, eps, rng=r1,
                deterministic=det, dropout_idx=gidx)
            mlp_out = dense.mlp(hidden, lp["mlp"], cfg.activation)
            hidden, residual = norms.dropout_add_layer_norm(
                mlp_out, residual, lp["norm2"]["weight"], lp["norm2"]["bias"],
                cfg.resid_pdrop if train else 0.0, eps, rng=r2,
                deterministic=det, dropout_idx=gidx)

        if model == "gpt":
            logits = gpt_lib.lm_logits(gp, cfg, hidden)
        else:
            # the Backpack tail: the contextualization on the einsum ring,
            # the d-wide sense vectors its values, the senses summed
            content = bp.content_forward(params, cfg, x_loc, train=train,
                                         rng=r_content, dropout_idx=gidx)
            q_ctx, k_ctx = bp.context_qk(params, cfg, hidden)
            per_sense = ctx_attn(q_ctx, k_ctx, content, ring=ring,
                                 softmax_scale=cfg.sense_head_dim ** -0.5)
            outputs = per_sense.float().sum(dim=2).to(hidden.dtype)
            logits = gpt_lib.lm_logits(gp, cfg, outputs)
        per_token, _ = cross_entropy(logits, y_loc, label_smoothing=label_smoothing)
        return per_token.mean(), per_token.detach()

    return local_loss


def make_cp_loss_fn(cfg, mesh, *, label_smoothing: float = 0.0,
                    attn_impl: str = "einsum", train: bool = False,
                    layout: str = "natural", model: str = "backpack",
                    return_per_token: bool = False):
    """loss(params, ids (B, s + 1)[, rng]) -> the global mean loss (a 0-d
    tensor, the same on every rank) with the sequence split over the
    mesh's 'seq' dimension and the batch over 'data' (JAX :253); params
    the same on every rank. After ``loss.backward()``, ``reduce_grads``
    gives every rank the global gradients. s must divide by the ring's
    size (2x under layout='zigzag'). train=True turns dropout on with the
    step key ``rng``. return_per_token: return (loss, this rank's per-token
    losses (b, c) f32, detached, in its chunk's order)."""
    body = _make_local_loss(cfg, label_smoothing=label_smoothing,
                            attn_impl=attn_impl, train=train, layout=layout,
                            model=model)

    def loss(params, ids, rng=None):
        local, per_token = body(params, ids, rng if train else None, mesh)
        mean = _WorldMean.apply(local)
        return (mean, per_token) if return_per_token else mean

    return loss


def reduce_grads(params: Params) -> None:
    """Sum every parameter's ``.grad`` over the world, in one message a
    dtype (absent gradients count as zeros)."""
    leaves = [t for _, t in train_lib.named_leaves(params) if t.requires_grad]
    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in leaves:
        by_dtype.setdefault(t.grad.dtype, []).append(t.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh_lib.all_reduce_(flat)
        o = 0
        for g in grads:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()


def broadcast_params(params: Params, src: int = 0) -> None:
    """Every rank's parameters set to rank ``src``'s (the replication
    JAX's in_shardings give)."""
    with torch.no_grad():
        for _, t in train_lib.named_leaves(params):
            mesh_lib.broadcast_(t, src)


def make_cp_train_step(cfg, tx: train_lib.Optimizer, mesh, *,
                       attn_impl: str = "einsum", train: bool = False,
                       layout: str = "natural",
                       model: str = "backpack") -> Callable:
    """step(params, opt, ids[, rng]) -> (params, opt, loss) (JAX :285):
    forward and backward on the ring, the gradients summed over the world,
    one update of ``tx`` (the port's Optimizer over ``params``, which it
    updates in place). train=True runs the dropout sites with ``rng``."""
    loss_fn = make_cp_loss_fn(cfg, mesh, attn_impl=attn_impl, train=train,
                              layout=layout, model=model)

    def step(params, opt, ids, rng=None):
        opt.adamw.zero_grad()
        loss = loss_fn(params, ids, rng)
        loss.backward()
        reduce_grads(params)
        opt.step()
        return params, opt, loss.detach()

    return step


def make_cp_sharded_train_step(cfg, tx: train_lib.Optimizer, mesh, *,
                               attn_impl: str = "flash",
                               layout: str = "natural",
                               label_smoothing: float = 0.0,
                               model: str = "backpack"):
    """The training CLI's CP step (JAX :311): (step(state, batch, rng) ->
    (state, {'loss', 'grad_norm'}), init(params) -> TrainState). The step's
    key is fold_in(rng, state.step); dropout on, every mask the
    single-device one; the gradient norm (before clipping) is taken after
    the gradients are summed over the world. init sets every rank's
    parameters to rank 0's."""
    loss_fn = make_cp_loss_fn(cfg, mesh, label_smoothing=label_smoothing,
                              attn_impl=attn_impl, layout=layout, train=True,
                              model=model)

    def step(state: train_lib.TrainState, batch, rng):
        step_rng = prng.fold_in(rng, state.step)
        opt = state.opt_state
        opt.adamw.zero_grad()
        loss = loss_fn(state.params, batch["input_ids"], step_rng)
        loss.backward()
        reduce_grads(state.params)
        gnorm = opt.step(state.step)
        return (train_lib.TrainState(state.params, opt, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    def init(params):
        broadcast_params(params)
        return train_lib.TrainState(params, tx, 0)

    return step, init
