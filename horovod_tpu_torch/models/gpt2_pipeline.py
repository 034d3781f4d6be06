"""GPT-2 staged over a pipeline (``pp``) line of ranks.

Port of ``horovod_tpu/models/gpt2_pipeline.py``. The ``L`` blocks of a
GPT-2 state dict (the port's names, ``nn.Linear``'s (out, in) weights; a
reference checkpoint through ``models.convert.gpt2_params_from_jax``) are
stacked by :func:`stack_block_params` into ``{name: (S, K, ...)}``: stage s
holds blocks [s·K, (s+1)·K). A rank holds its stage's ``(1, K, ...)``
block, as ``parallel.shard_pytree`` gives it (``P("pp")``), and ``rest``
= ``wte``, ``wpe`` and ``ln_f`` whole. The stacking is a restack of the
same tensors, so a checkpoint moves between the plain and the staged
layouts without loss.

The interleaved schedules (``parallel.pipeline.pipeline_loss_interleaved``
and ``pipeline_interleaved_1f1b``) give rank d R virtual stages:
:func:`stack_block_params_interleaved` stacks ``{name: (S, R, K, ...)}``,
rank d's round r holding layers [(r·S + d)·K, (r·S + d + 1)·K), and a rank
holds its ``(1, R, K, ...)`` block; each round runs its ``(K, ...)``
slice as a stage does.

Each stage runs its K blocks in order, the port's ``Block`` through
``torch.func.functional_call`` (``parallel/fsdp.module_block_fn``), so
with ``attention="flash"`` every block launches the flash kernels. The
embedding runs on stage 0, and the fp32 ``ln_f`` and the tied head inside
the loss on the last stage. Their parameters are in ``rest`` on every
stage, so the steps **sum** ``rest``'s gradients over the line: stage 0
holds the embedding's part of ``wte``'s gradient and the last stage the
head's (an average would divide both by S).

Tensor parallelism inside the stages (pp x tp): :func:`make_pp_tp_params`
re-lays the attention weights head-major (qkv (S, K, 3, H, hd, D), its
bias (S, K, 3, H, hd), the out projection (S, K, D, H, hd)) so that
:func:`block_specs_tp` splits them by whole heads over tp, fc by output
rows and proj by input columns. The stage's ``Block`` then takes a
``mp.TensorParallel`` over the tp line: Megatron's f at the
column-parallel inputs, g through ``Dense.reduce`` before the row-parallel
bias. ``rest`` stays whole on every tp member: the embedding and the head
run replicated, as the reference's pp x tp does (not vocab-parallel as
``mp.tensor_parallel`` splits them). The layout is this module's own: it
never reads ``HOROVOD_MP_RULES``. A dp axis beside pp and tp is the
caller's: average the loss and every gradient over
``mesh.process_set("dp")``, as the reference's dryrun does.

``process_set=`` / ``pp_set=`` / ``tp_set=`` take the place of the
reference's ``axis_name`` / ``pp_axis`` / ``tp_axis``: process sets (a
mesh's lines), or a ``parallel.pipeline.Line`` / ``mp.TensorParallel`` as
they are.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from horovod_tpu_torch.models.gpt2 import Block, GPT2Config, LayerNorm, \
    loss_fn
from horovod_tpu_torch.parallel.fsdp import module_block_fn
from horovod_tpu_torch.parallel.pipeline import (
    Line, pipeline_1f1b, pipeline_interleaved_1f1b, pipeline_loss,
    pipeline_loss_interleaved)
from horovod_tpu_torch.parallel.sharding import P, PartitionRules

__all__ = ["stack_block_params", "stack_block_params_interleaved",
           "make_pp_tp_params", "make_pp_tp_params_interleaved",
           "block_specs_tp",
           "gpt2_pp_loss", "gpt2_pp_loss_interleaved",
           "gpt2_pp_loss_and_grad", "gpt2_pp_loss_and_grad_interleaved",
           "gpt2_pp_1f1b_loss_and_grad", "gpt2_pp_tp_1f1b_loss_and_grad",
           "gpt2_pp_interleaved_1f1b_loss_and_grad",
           "gpt2_pp_tp_interleaved_1f1b_loss_and_grad",
           "gpt2_pp_tp_loss", "gpt2_pp_tp_loss_and_grad",
           "gpt2_pp_tp_loss_interleaved",
           "gpt2_pp_tp_loss_and_grad_interleaved"]

Tree = Dict[str, torch.Tensor]


def _layers(params) -> Tuple[Tree, list, Tree]:
    """(the state dict as tensors, the block indices in order, rest)."""
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    layers = sorted({int(k.split(".")[1]) for k in params
                     if k.startswith("h.")})
    rest = {k: v for k, v in params.items() if not k.startswith("h.")}
    return params, layers, rest


def _stack(params: Tree, idx: list, lead: tuple) -> Tree:
    """``{name: the blocks idx's tensors stacked, reshaped to lead + ...}``."""
    names = [k[len("h.0."):] for k in params if k.startswith("h.0.")]
    out = {}
    for n in names:
        v = torch.stack([params[f"h.{i}.{n}"] for i in idx])
        out[n] = v.reshape(lead + tuple(v.shape[1:]))
    return out


def stack_block_params(params, num_stages: int) -> Tuple[Tree, Tree]:
    """Split a GPT-2 state dict into (stacked blocks, rest).

    ``blocks`` maps each block parameter's name (``"attn.qkv.weight"``)
    to ``h.0..h.{L-1}``'s tensors stacked to ``(S, K, ...)``; ``rest``
    holds ``wte``, ``wpe`` and ``ln_f``. Numpy arrays are taken too."""
    params, layers, rest = _layers(params)
    L = len(layers)
    if L % num_stages:
        raise ValueError(f"num_layers {L} not divisible by {num_stages} "
                         "stages")
    return _stack(params, layers, (num_stages, L // num_stages)), rest


def stack_block_params_interleaved(params, num_stages: int,
                                   rounds: int) -> Tuple[Tree, Tree]:
    """Split a GPT-2 state dict for the interleaved schedules: with L = S·R·K
    layers, virtual stage r·S + d holds layers [(r·S + d)·K, (r·S + d +
    1)·K), so rank d's stack is ``(S, R, K, ...)[d]``. Returns (``{name: (S,
    R, K, ...)}``, rest)."""
    params, layers, rest = _layers(params)
    L = len(layers)
    S, R = num_stages, rounds
    if L % (S * R):
        raise ValueError(
            f"num_layers {L} not divisible by stages*rounds {S}*{R}")
    K = L // (S * R)
    idx = [layers[(r * S + d) * K + k]
           for d in range(S) for r in range(R) for k in range(K)]
    return _stack(params, idx, (S, R, K)), rest


def _stage_fn(cfg: GPT2Config, tp=None) -> Callable:
    """``(this stage's (K, ...) blocks, (mb, T, D)) -> (mb, T, D)``: the
    port's ``Block`` over each of the K blocks in order. Under ``tp`` (a
    ``mp.TensorParallel``) the block holds this rank's heads and features
    in the head-major layout of :func:`make_pp_tp_params` and places f
    and g."""
    with torch.device("meta"):
        block = Block(cfg)
    if tp is not None:
        block.attn.tp = block.mlp.tp = tp
        block.attn.out.reduce = block.mlp.proj.reduce = tp.g
    fn = module_block_fn(block)

    def layout(name: str, v: torch.Tensor) -> torch.Tensor:
        # The head-major weights back in nn.Linear's (out, in) layout.
        if name == "attn.qkv.weight":
            return v.reshape(-1, v.shape[-1])
        if name == "attn.qkv.bias":
            return v.reshape(-1)
        if name == "attn.out.weight":
            return v.reshape(v.shape[0], -1)
        return v

    def apply_blocks(blocks_k: Tree, h: torch.Tensor) -> torch.Tensor:
        for k in range(next(iter(blocks_k.values())).shape[0]):
            h = fn({n: layout(n, v[k]) for n, v in blocks_k.items()}, h)
        return h

    return apply_blocks


def _embed(cfg: GPT2Config, rest: Tree, tokens: torch.Tensor):
    """The port's GPT-2 embedding: rows cast to ``cfg.dtype``, then
    added."""
    pos = torch.arange(tokens.shape[-1], device=tokens.device)
    return rest["wte"][tokens].to(cfg.dtype) + rest["wpe"][pos].to(cfg.dtype)


def _head_loss(cfg: GPT2Config, rest: Tree, h: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """fp32 ``ln_f``, the tied head in fp32 and ``loss_fn``, as the port's
    GPT-2 computes them."""
    from torch.func import functional_call
    with torch.device("meta"):
        ln = LayerNorm(cfg.d_model, cfg.ln_eps)
    h = functional_call(ln, {"weight": rest["ln_f.weight"],
                             "bias": rest["ln_f.bias"]}, (h,))
    logits = torch.einsum("btd,vd->btv", h.float(), rest["wte"].float())
    return loss_fn(logits, targets)


def _local(blocks: Tree) -> Tree:
    """This stage's ``(1, K, ...)`` block as ``(K, ...)``."""
    return {k: v.squeeze(0) for k, v in blocks.items()}


def _first_stage_input(cfg: GPT2Config, rest: Tree, tokens: torch.Tensor,
                       line: Line) -> torch.Tensor:
    """The (M, mb, T, D) microbatches: the embedding on stage 0, a
    zero-stride stand-in of its shape and dtype on the others (only stage
    0 reads the values)."""
    if line.rank == 0:
        return _embed(cfg, rest, tokens)
    return torch.zeros((), dtype=cfg.dtype, device=tokens.device).expand(
        tuple(tokens.shape) + (cfg.d_model,))


def _pp_loss(cfg: GPT2Config, blocks: Tree, rest: Tree, tokens, line: Line,
             stage_fn: Callable,
             pipeline_fn: Callable = pipeline_loss) -> torch.Tensor:
    """Embedding -> the GPipe schedule ``pipeline_fn`` (plain or
    interleaved) -> ``ln_f`` and the tied head's loss, over the (M, mb, T)
    tokens; the loss replicated over the line."""
    M, mb, T = tokens.shape

    def loss_from_outputs(outs, mb_start):
        # Two-argument form: an interleaved run of M > S microbatches goes
        # in chunks, and the targets follow the chunk.
        mc = outs.shape[0]
        tgt = tokens[mb_start:mb_start + mc].reshape(mc * mb, T)
        return _head_loss(cfg, rest, outs.reshape(mc * mb, T, -1), tgt)

    return pipeline_fn(stage_fn, _local(blocks),
                       _first_stage_input(cfg, rest, tokens, line),
                       loss_from_outputs, line)


def gpt2_pp_loss(cfg: GPT2Config, blocks: Tree, rest: Tree,
                 tokens: torch.Tensor, process_set=None) -> torch.Tensor:
    """Pipelined GPT-2 LM loss over the line of ``process_set``.

    Args:
      blocks: this stage's ``(1, K, ...)`` block of
        :func:`stack_block_params`' ``(S, K, ...)`` stack.
      rest: ``wte``, ``wpe``, ``ln_f`` (every stage).
      tokens: (M, mb, T) token ids (every stage).

    Returns the next-token cross entropy over all M·mb sequences, the same
    on every stage and differentiable (run its backward on every stage):
    the blocks' gradients are this stage's, ``rest``'s are this stage's
    share, to be summed over the line (:func:`gpt2_pp_loss_and_grad`
    does both).
    """
    return _pp_loss(cfg, blocks, rest, tokens, Line.of(process_set),
                    _stage_fn(cfg))


def gpt2_pp_loss_interleaved(cfg: GPT2Config, blocks: Tree, rest: Tree,
                             tokens: torch.Tensor,
                             process_set=None) -> torch.Tensor:
    """:func:`gpt2_pp_loss` on the interleaved (circular) GPipe schedule
    over the ring of ``process_set``: ``blocks`` this rank's ``(1, R, K,
    ...)`` block of :func:`stack_block_params_interleaved`' stack; M > S
    microbatches run in chunks of S
    (``parallel.pipeline.pipeline_loss_interleaved``)."""
    return _pp_loss(cfg, blocks, rest, tokens,
                    Line.of(process_set, wrap=True), _stage_fn(cfg),
                    pipeline_loss_interleaved)


def _make_loss_and_grad(loss_call: Callable, line: Line) -> Callable:
    """``(blocks, rest, tokens) -> (loss, g_blocks, g_rest)`` of every
    layout: the blocks' gradients stay this stage's (and this tp rank's),
    ``rest``'s are summed over the pp line."""

    def step(blocks: Tree, rest: Tree, tokens: torch.Tensor):
        b = {k: v.detach().requires_grad_() for k, v in blocks.items()}
        r = {k: v.detach().requires_grad_() for k, v in rest.items()}
        loss = loss_call(b, r, tokens)
        leaves = list(b.values()) + list(r.values())
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        g_blocks = dict(zip(b, gs[:len(b)]))
        g_rest = {k: line.psum(g) for k, g in zip(r, gs[len(b):])}
        return loss.detach(), g_blocks, g_rest

    return step


def gpt2_pp_loss_and_grad(cfg: GPT2Config, process_set=None) -> Callable:
    """A ``(blocks, rest, tokens) -> (loss, g_blocks, g_rest)`` step over
    the line of ``process_set``: ``g_blocks`` this stage's ``(1, K, ...)``
    gradients, ``g_rest`` the whole ``rest`` gradients, summed over the
    line (the same on every stage)."""
    line, stage_fn = Line.of(process_set), _stage_fn(cfg)
    return _make_loss_and_grad(
        lambda b, r, t: _pp_loss(cfg, b, r, t, line, stage_fn), line)


def gpt2_pp_loss_and_grad_interleaved(cfg: GPT2Config,
                                      process_set=None) -> Callable:
    """:func:`gpt2_pp_loss_and_grad` on the interleaved GPipe schedule:
    ``g_blocks`` this rank's ``(1, R, K, ...)`` gradients."""
    line, stage_fn = Line.of(process_set, wrap=True), _stage_fn(cfg)
    return _make_loss_and_grad(
        lambda b, r, t: _pp_loss(cfg, b, r, t, line, stage_fn,
                                 pipeline_loss_interleaved), line)


# ---------------------------------------------------------------------------
# pipeline x tensor parallelism (Megatron inside GPipe)
# ---------------------------------------------------------------------------

def make_pp_tp_params(params, num_stages: int,
                      num_heads: int) -> Tuple[Tree, Tree]:
    """:func:`stack_block_params`, then the attention weights head-major
    for tensor parallelism: qkv ``(S, K, 3, H, hd, D)`` (its (3·D, D)
    rows are q | k | v, each head-major), its bias ``(S, K, 3, H, hd)`` and
    the out projection ``(S, K, D, H, hd)``, so a split of the head axis is
    whole heads. A reshape: the plain layout is a reshape back."""
    blocks, rest = stack_block_params(params, num_stages)
    return _relayout_heads(blocks, num_heads), rest


def make_pp_tp_params_interleaved(params, num_stages: int, rounds: int,
                                  num_heads: int) -> Tuple[Tree, Tree]:
    """:func:`stack_block_params_interleaved`, then the head-major
    attention weights of :func:`make_pp_tp_params` (with the ``(S, R, K)``
    lead)."""
    blocks, rest = stack_block_params_interleaved(params, num_stages,
                                                  rounds)
    return _relayout_heads(blocks, num_heads), rest


def _relayout_heads(blocks: Tree, num_heads: int) -> Tree:
    qkv = blocks["attn.qkv.weight"]
    lead, d = tuple(qkv.shape[:-2]), qkv.shape[-1]
    hd = d // num_heads
    blocks["attn.qkv.weight"] = qkv.reshape(lead + (3, num_heads, hd, d))
    blocks["attn.qkv.bias"] = blocks["attn.qkv.bias"].reshape(
        lead + (3, num_heads, hd))
    blocks["attn.out.weight"] = blocks["attn.out.weight"].reshape(
        lead + (d, num_heads, hd))
    return blocks


def block_specs_tp(pp_axis: str = "pp", tp_axis: str = "tp",
                   extra_dims: int = 0) -> PartitionRules:
    """The specs of :func:`make_pp_tp_params`' blocks, as the rules
    ``parallel.shard_pytree`` takes (one per block parameter's name): the
    stage axis over ``pp_axis``; the head axis of qkv, its bias and the
    out projection, fc's output rows and proj's input columns over
    ``tp_axis``; everything else whole on each stage. ``extra_dims``
    inserts that many whole axes after the stage axis (1 for the rounds
    of :func:`make_pp_tp_params_interleaved`' ``(S, R, K, ...)``)."""
    def spec(*tail):
        return P(pp_axis, *(None,) * extra_dims, None, *tail)

    return PartitionRules([
        (r"^attn\.qkv\.(weight|bias)$", spec(None, tp_axis)),
        (r"^attn\.out\.weight$", spec(None, tp_axis)),
        (r"^mlp\.fc\.(weight|bias)$", spec(tp_axis)),
        (r"^mlp\.proj\.weight$", spec(None, tp_axis)),
        (r"", spec()),
    ])


def _tensor_parallel(tp_set):
    from horovod_tpu_torch.parallel.mp import TensorParallel
    return tp_set if isinstance(tp_set, TensorParallel) \
        else TensorParallel(tp_set)


def gpt2_pp_tp_loss(cfg: GPT2Config, blocks: Tree, rest: Tree,
                    tokens: torch.Tensor, pp_set=None,
                    tp_set=None) -> torch.Tensor:
    """Pipelined and tensor-parallel GPT-2 LM loss: ``blocks`` this rank's
    block of :func:`make_pp_tp_params`' stack under
    :func:`block_specs_tp`, ``rest`` and ``tokens`` whole. Activations hop
    over the pp line; inside a stage every matmul is split over the tp
    line (default: ``mp.TensorParallel``'s, the mp set in scope). The
    embedding and the head run whole on every tp member, so the loss and
    ``rest``'s gradients are the same on the tp ranks."""
    return _pp_loss(cfg, blocks, rest, tokens, Line.of(pp_set),
                    _stage_fn(cfg, _tensor_parallel(tp_set)))


def gpt2_pp_tp_loss_and_grad(cfg: GPT2Config, pp_set=None,
                             tp_set=None) -> Callable:
    """The pp x tp ``(blocks, rest, tokens) -> (loss, g_blocks, g_rest)``
    step: block gradients this rank's (stage and tp part), ``rest``'s
    summed over the pp line only (they are the same on the tp ranks)."""
    line = Line.of(pp_set)
    stage_fn = _stage_fn(cfg, _tensor_parallel(tp_set))
    return _make_loss_and_grad(
        lambda b, r, t: _pp_loss(cfg, b, r, t, line, stage_fn), line)


def gpt2_pp_tp_loss_interleaved(cfg: GPT2Config, blocks: Tree, rest: Tree,
                                tokens: torch.Tensor, pp_set=None,
                                tp_set=None) -> torch.Tensor:
    """:func:`gpt2_pp_tp_loss` on the interleaved GPipe schedule: ``blocks``
    this rank's block of :func:`make_pp_tp_params_interleaved`' stack
    under ``block_specs_tp(extra_dims=1)``."""
    return _pp_loss(cfg, blocks, rest, tokens, Line.of(pp_set, wrap=True),
                    _stage_fn(cfg, _tensor_parallel(tp_set)),
                    pipeline_loss_interleaved)


def gpt2_pp_tp_loss_and_grad_interleaved(cfg: GPT2Config, pp_set=None,
                                         tp_set=None) -> Callable:
    """:func:`gpt2_pp_tp_loss_and_grad` on the interleaved GPipe
    schedule."""
    line = Line.of(pp_set, wrap=True)
    stage_fn = _stage_fn(cfg, _tensor_parallel(tp_set))
    return _make_loss_and_grad(
        lambda b, r, t: _pp_loss(cfg, b, r, t, line, stage_fn,
                                 pipeline_loss_interleaved), line)


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def gpt2_pp_1f1b_loss_and_grad(cfg: GPT2Config,
                               process_set=None) -> Callable:
    """GPT-2 on the 1F1B schedule (``parallel.pipeline.pipeline_1f1b``):
    the same ``(blocks, rest, tokens) -> (loss, g_blocks, g_rest)``
    contract as :func:`gpt2_pp_loss_and_grad`, with at most
    min(2(S - 1 - s) + 1, M) microbatches' activations alive on stage s.
    The embedding's backward runs from stage 0's microbatch cotangents,
    the fp32 ``ln_f`` and the head inside each microbatch's loss on the
    last stage; both land in ``g_rest``, summed over the line. The step's
    ``core`` is the 1F1B step it runs (``core.peak_in_flight``)."""
    return _make_1f1b_step(cfg, _stage_fn(cfg), Line.of(process_set))


def gpt2_pp_tp_1f1b_loss_and_grad(cfg: GPT2Config, pp_set=None,
                                  tp_set=None) -> Callable:
    """1F1B with Megatron tensor parallelism inside each stage (blocks
    from :func:`make_pp_tp_params`, split by :func:`block_specs_tp`): each
    tp rank stashes its own heads' and features' activations, and the f /
    g operators keep the backward's tp sums inside the hand-driven
    schedule."""
    return _make_1f1b_step(cfg, _stage_fn(cfg, _tensor_parallel(tp_set)),
                           Line.of(pp_set))


def gpt2_pp_interleaved_1f1b_loss_and_grad(cfg: GPT2Config, rounds: int,
                                           process_set=None) -> Callable:
    """GPT-2 on the interleaved 1F1B schedule
    (``parallel.pipeline.pipeline_interleaved_1f1b``) over the ring of
    ``process_set``: :func:`gpt2_pp_1f1b_loss_and_grad`'s contract with
    ``blocks`` this rank's ``(1, R, K, ...)`` block of
    :func:`stack_block_params_interleaved`' stack, the bubble shrunk about
    R-fold and the activations held bounded by the schedule's peak in
    flight (``step.core.peak_in_flight``, ``step.core.schedule``).
    Requires M % S == 0."""
    return _make_1f1b_step(cfg, _stage_fn(cfg),
                           Line.of(process_set, wrap=True), rounds)


def gpt2_pp_tp_interleaved_1f1b_loss_and_grad(cfg: GPT2Config, rounds: int,
                                              pp_set=None,
                                              tp_set=None) -> Callable:
    """Interleaved 1F1B with Megatron tensor parallelism inside each
    virtual stage (blocks from :func:`make_pp_tp_params_interleaved`,
    split by ``block_specs_tp(extra_dims=1)``)."""
    return _make_1f1b_step(cfg, _stage_fn(cfg, _tensor_parallel(tp_set)),
                           Line.of(pp_set, wrap=True), rounds)


def _make_1f1b_step(cfg: GPT2Config, stage_fn: Callable, line: Line,
                    rounds: Optional[int] = None) -> Callable:

    def step(blocks: Tree, rest: Tree, tokens: torch.Tensor):
        r = {k: v.detach().requires_grad_() for k, v in rest.items()}
        x = _first_stage_input(cfg, r, tokens, line)

        def head(lp, y, m):
            return _head_loss(cfg, lp, y, tokens[m])

        step.core = (pipeline_1f1b(stage_fn, head, line) if rounds is None
                     else pipeline_interleaved_1f1b(stage_fn, head, line,
                                                    rounds=rounds))
        loss, (g_blocks, g_rest, g_x) = step.core(_local(blocks), rest,
                                                  x.detach())
        if line.rank == 0:
            # The embedding's own backward, from the microbatches'
            # cotangents.
            gs = torch.autograd.grad(x, list(r.values()), g_x,
                                     allow_unused=True)
            g_rest = {k: g_rest[k] if g is None else g_rest[k] + g
                      for k, g in zip(r, gs)}
        g_rest = {k: line.psum(g) for k, g in g_rest.items()}
        return loss, {k: g[None] for k, g in g_blocks.items()}, g_rest

    step.core = None
    return step
