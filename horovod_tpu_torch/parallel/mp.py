"""Model parallelism over the named ``dp x mp`` mesh (``HOROVOD_MESH``).

Port of ``horovod_tpu/parallel/mp.py``. One process drives one GPU, so
where the reference lifts a program into ``shard_map`` over the ``"mp"``
axis and lets GSPMD place the collectives, the port's models place them
themselves, over this rank's line of the mesh (a process set). Three
consumers:

* **Tensor-parallel training.** :func:`mp_partition_rules` maps the model
  zoo's Megatron rule sets (``models/gpt2.py`` / ``llama.py``
  ``partition_rules``, over the port's parameter names) onto the ``"mp"``
  axis. :func:`tensor_parallel` turns a built GPT-2 or Llama into this
  rank's part (:func:`split_params`): Megatron's f
  (``identity_fwd_psum_bwd``) at each column-parallel input, g
  (``psum_fwd_identity_bwd``) at each row-parallel output with the
  replicated bias added once after the sum, the vocab-parallel embedding
  and head, and the attention at the local head count (so the flash
  kernels run at B * H / mp heads). The model returns this rank's
  (B, T, V/mp) logits, and :func:`vocab_parallel_loss` is the exact cross
  entropy over them: one max, one sum of exponentials and one target
  logit, reduced over the set; the logits are never gathered. A T5 splits
  by its own rules (``models/t5.py`` ``partition_rules``, as the
  reference's dryrun applies them, whatever ``HOROVOD_MP_RULES`` says) and
  trains on ``t5.seq2seq_loss``, which takes the same arithmetic; the
  rule-set, weight-split and decode functions below refuse it, as the
  reference's do. At mp = 1
  nothing changes: the model is the dense one and the loss is
  ``loss_fn``; so it is under ``HOROVOD_MP_RULES=off``, which
  :func:`mp_partition_rules` maps to no split at all. On a dp x mp mesh
  ``DistributedOptimizer`` averages over the dp set only, and the ranks
  of one mp set take the same batch. The other axes of a
  ``make_mesh({"dp": a, "sp": b, "tp": c})`` or ``{"dp", "ep", "tp"}``
  mesh come in through the same call: ``sp=`` binds the model's rings to
  its sp line (the kernels at B * H / tp heads a hop, the loss exact over
  the whole sequence with ``vocab_parallel_loss(..., sp=)``; the optimizer
  averages over the dp x sp plane, ``mesh.process_set(("dp", "sp"))``),
  and ``ep=`` keeps E/ep experts of every MoE layer a rank
  (``ops/moe.ExpertParallel``; the optimizer averages over the dp line,
  and the replicated weights' gradients are equal across ep and tp by
  construction).
* **ZeRO-2 / ZeRO-3 training**: gradients reduce-scatter to their owner's
  flat chunk, and parameters all-gather just in time per block. ZeRO-3 is
  ``parallel/fsdp.py``'s machinery under the ``zero3_*`` names, with a
  ``wire=`` option that puts the parameter all-gathers on the bf16 wire or
  the int8 / fp8 block formats of ``ops/quantized.py`` (lossy; the exact
  fp32 path is the default). Every state is this rank's row, as in ZeRO-1
  (``optimizer_sharded.py``).
* **Tensor-parallel decode**: :func:`tp_decode_step` and
  :func:`tp_decode_verify_step` run ``models/generate.py``'s registry
  steps over a model that holds :func:`split_params`' part, wired as
  :func:`tensor_parallel` wires it, and a cache of Hkv/mp kv heads; the
  head gathers the vocab slices in rank order, so the logits come back
  whole. At mp = 1 a step is ``decode_step`` itself.

``process_set=`` takes the place of the reference's ``axis=`` /
``axis_name=``; its default is the mp set that :func:`wrap_spmd` put in
scope, else this rank's line of ``core.mesh2d()``'s mp axis.
:func:`mp_stack`, :func:`mp_broadcast` and :func:`mp_fetch` are thin here:
this rank's row on its device, a value on the device, the host value.

Numerical contract (the reference's): replicated activations agree bit
for bit across the mp ranks (every member receives the same sum), the
column-parallel products and the vocab-parallel embedding are exact
against the replicated ones, and the row-parallel sums differ from the
replicated product only by the order of the terms.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from horovod_tpu_torch.optimizer_sharded import (ShardedAdamWState,
                                                 _adamw_chunk_update,
                                                 _flatten, _unflatten)
from horovod_tpu_torch.parallel import fsdp as _fsdp
from horovod_tpu_torch.parallel.conjugate import (identity_fwd_psum_bwd,
                                                  psum_fwd_identity_bwd)
from horovod_tpu_torch.parallel.fsdp import (fsdp_adamw, fsdp_apply,
                                             fsdp_scan_blocks,
                                             fsdp_shard_params,
                                             stack_layer_shards)
from horovod_tpu_torch.parallel.sharding import (P, PartitionRules,
                                                 _map_with_path)

__all__ = [
    "MP_AXIS", "validate_tp", "mp_partition_rules",
    "split_params", "merge_params", "param_bytes",
    "tp_decode_step", "tp_decode_verify_step", "wrap_spmd",
    "mp_stack", "mp_broadcast", "mp_fetch",
    "TensorParallel", "tensor_parallel", "vocab_parallel_loss",
    "gather_shard",
    "zero3_shard_params", "zero3_apply", "zero3_scan_blocks",
    "zero3_stack_layer_shards", "zero3_adamw",
    "zero2_grad_shard", "zero2_update",
]

#: name of the model-parallel axis of ``core.mesh2d()``
MP_AXIS = "mp"

# ZeRO-3 is fsdp under the one sharding story: the same flat-chunk layout,
# the same gather-is-the-remat Function, the same no-update-gather AdamW.
zero3_shard_params = fsdp_shard_params
zero3_scan_blocks = fsdp_scan_blocks
zero3_stack_layer_shards = stack_layer_shards
zero3_adamw = fsdp_adamw

# The mp sets that wrap_spmd put in scope, innermost last.
_SCOPE: list = []


def _mp_set(process_set=None):
    """``process_set``, else the one in :func:`wrap_spmd`'s scope, else
    this rank's line of ``mesh2d()``'s mp axis."""
    if process_set is not None:
        return process_set
    if _SCOPE:
        return _SCOPE[-1]
    from horovod_tpu_torch import core
    return core.mesh2d().process_set(MP_AXIS)


# ---------------------------------------------------------------------------
# validation and partition rules
# ---------------------------------------------------------------------------

def _family(cfg):
    from horovod_tpu_torch.models.generate import decode_family
    return decode_family(cfg)


def validate_tp(cfg, mp: int) -> None:
    """Raise unless ``cfg`` splits cleanly over ``mp`` tensor-parallel
    ranks: heads, kv heads, the MLP width and the vocab must all divide
    (the splits are head / vocab aligned, not element-striped)."""
    fam = _family(cfg)
    if fam.name not in ("gpt2", "llama"):
        raise NotImplementedError(
            f"tensor parallelism is implemented for the gpt2/llama "
            f"families, not {fam.name!r}")
    if mp < 1:
        raise ValueError(f"mp degree must be >= 1, got {mp}")
    if cfg.num_heads % mp:
        raise ValueError(
            f"mp={mp} must divide num_heads={cfg.num_heads} "
            f"(attention splits by whole heads)")
    kv = fam.kv_heads(cfg)
    if kv % mp:
        raise ValueError(
            f"mp={mp} must divide num_kv_heads={kv} "
            f"(the KV pool splits by whole kv heads)")
    if cfg.vocab_size % mp:
        raise ValueError(
            f"mp={mp} must divide vocab_size={cfg.vocab_size} "
            f"(the embedding/logits head splits by vocab rows)")
    d_ff = getattr(cfg, "d_ff", 4 * cfg.d_model)
    if d_ff % mp:
        raise ValueError(
            f"mp={mp} must divide the MLP width {d_ff}")


def mp_partition_rules(cfg, rules: Optional[str] = None) -> PartitionRules:
    """The model family's Megatron rule set rebased onto the ``"mp"``
    axis. ``rules`` is the ``HOROVOD_MP_RULES`` mode (default: the config
    knob): ``"auto"`` and ``"megatron"`` both give the family's column /
    row split; ``"off"`` replicates everything (the debugging escape hatch
    that keeps the mesh but removes the sharding)."""
    if rules is None:
        from horovod_tpu_torch.config import get_config
        rules = get_config().mp_rules
    if rules == "off":
        return PartitionRules([])
    fam = _family(cfg)
    if fam.name == "gpt2":
        from horovod_tpu_torch.models.gpt2 import partition_rules as base
    elif fam.name == "llama":
        from horovod_tpu_torch.models.llama import partition_rules as base
    else:
        raise NotImplementedError(
            f"no mp rule set for the {fam.name!r} family")
    return _on_mp(base())


def _on_mp(rules: PartitionRules) -> PartitionRules:
    """``rules`` with their ``"tp"`` axis renamed ``"mp"``."""
    return PartitionRules([
        (pat.pattern, P(*(MP_AXIS if s == "tp" else s for s in spec)))
        for pat, spec in rules.rules])


def _t5_rules(cfg, mp: int) -> PartitionRules:
    """T5's Megatron rules on the ``"mp"`` axis, after checking that ``mp``
    divides the heads, the gated-GELU width and the vocab. The reference
    trains T5 under GSPMD with ``models/t5.py``'s rules applied directly,
    so ``HOROVOD_MP_RULES`` does not enter."""
    from horovod_tpu_torch.models.t5 import partition_rules
    for what, n in (("num_heads", cfg.num_heads), ("d_ff", cfg.d_ff),
                    ("vocab_size", cfg.vocab_size)):
        if n % mp:
            raise ValueError(f"mp={mp} must divide T5's {what}={n} (the "
                             f"split is by whole heads, columns and vocab "
                             f"rows)")
    return _on_mp(partition_rules())


# ---------------------------------------------------------------------------
# explicit weight splitting (the layout of tensor-parallel training and
# decode)
# ---------------------------------------------------------------------------

def param_bytes(tree) -> int:
    """Total bytes of a tree of tensors or arrays (the per-rank footprint
    metric)."""
    sizes = []
    _map_with_path(lambda _, x: sizes.append(
        x.numel() * x.element_size() if torch.is_tensor(x)
        else np.asarray(x).nbytes), tree)
    return sum(sizes)


def _kind(rules: PartitionRules, name: str) -> str:
    """How parameter ``name`` splits under ``rules`` (an
    :func:`mp_partition_rules` set): ``"rows"`` of the (out, in) weight
    for ``P("mp", None)`` / ``P("mp")`` (column-parallel weights and biases,
    the vocab tables), ``"cols"`` for ``P(None, "mp")`` (row-parallel),
    ``"qkv"`` for GPT-2's packed q | k | v rows (by whole heads), anything
    else ``"whole"`` (wpe, the norms, the row-parallel biases)."""
    spec = tuple(rules.spec_for(name))
    if spec[:1] == (MP_AXIS,):
        return "qkv" if ".attn.qkv." in name else "rows"
    if spec == (None, MP_AXIS):
        return "cols"
    return "whole"


def _split_one(kind: str, v: torch.Tensor, n: int, r: int) -> torch.Tensor:
    if kind == "rows":
        c = v.shape[0] // n
        return v[r * c:(r + 1) * c]
    if kind == "cols":
        c = v.shape[1] // n
        return v[:, r * c:(r + 1) * c]
    if kind == "qkv":
        # (3 * H * hd, ...) rows, head-major within each of q, k and v: a
        # contiguous run of H * hd / n rows of each is whole heads. A
        # contiguous block of all the rows would put q alone on rank 0.
        rest = tuple(v.shape[1:])
        return v.reshape((3, n, v.shape[0] // (3 * n)) + rest)[:, r] \
            .reshape((-1,) + rest)
    return v


def _merge_one(kind: str, vs) -> torch.Tensor:
    if kind == "rows":
        return torch.cat(vs, 0)
    if kind == "cols":
        return torch.cat(vs, 1)
    if kind == "qkv":
        rest = tuple(vs[0].shape[1:])
        return torch.stack([v.reshape((3, -1) + rest) for v in vs], 1) \
            .reshape((-1,) + rest)
    return vs[0]


def _check_splittable(cfg, mp: int):
    validate_tp(cfg, mp)
    if getattr(cfg, "num_experts", 0) > 0:
        raise NotImplementedError(
            "split_params / merge_params refuse an MoE config, as the "
            "reference's do (a KeyError there); tensor_parallel(model, "
            "ep=...) keeps this rank's experts")


def _ep_split(rules: PartitionRules, name: str) -> bool:
    """Whether ``name`` is an expert weight (its rule's leading axis is
    ``"ep"``): rank e of the ep line keeps experts [e*E/ep, (e+1)*E/ep)."""
    return tuple(rules.spec_for(name))[:1] == ("ep",)


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if torch.is_tensor(v) else torch.as_tensor(
        np.asarray(v))


def split_params(cfg, params, mp: int, rank: int):
    """Rank ``rank``'s 1/mp part of a state dict in the port's layout
    (``{name: tensor}``, ``nn.Linear``'s (out, in) weights; numpy arrays
    are taken too): column-parallel weights (GPT-2's qkv by whole heads,
    fc; Llama's wq / wk / wv, gate, up) by output rows, row-parallel ones
    (out, proj; wo, down) by input columns, ``wte`` and Llama's
    ``lm_head`` by vocab rows; ``wpe``, the norms and the row-parallel
    biases whole. The parts are views of ``params`` where a slice allows.
    ``mp == 1`` returns the dict as it is."""
    _check_splittable(cfg, mp)
    if not 0 <= rank < mp:
        raise ValueError(f"rank {rank} outside the mp={mp} axis")
    if mp == 1:
        return {k: _as_tensor(v) for k, v in params.items()}
    rules = mp_partition_rules(cfg, "megatron")
    return {k: _split_one(_kind(rules, k), _as_tensor(v), mp, rank)
            for k, v in params.items()}


def merge_params(cfg, parts):
    """Inverse of :func:`split_params`: the whole state dict from all
    ``mp`` parts in rank order (checkpoint resharding onto another mp
    degree re-splits the merged dict)."""
    _check_splittable(cfg, len(parts))
    rules = mp_partition_rules(cfg, "megatron")
    return {k: _merge_one(_kind(rules, k), [_as_tensor(p[k])
                                             for p in parts])
            for k in parts[0]}


# ---------------------------------------------------------------------------
# this rank's row of the mp axis
# ---------------------------------------------------------------------------

def mp_stack(fn: Callable[[int], Any], mesh):
    """``fn(r)`` for this rank's coordinate ``r`` on ``mesh``'s mp axis,
    its leaves as tensors on this rank's device. The reference stacks the
    rows of every mp coordinate into global arrays; one process drives
    one device here, so a rank builds and holds its own row only."""
    from horovod_tpu_torch import core
    dev = core.device()
    return _map_with_path(lambda _, x: torch.as_tensor(x).to(dev),
                          fn(mesh.coords(core.rank())[MP_AXIS]))


def mp_broadcast(tree, mesh):
    """A value every rank computed alike (the step's tokens and
    positions), on this rank's device."""
    return mp_stack(lambda r: tree, mesh)


def mp_fetch(x) -> np.ndarray:
    """A replicated result (greedy picks, gathered logits) back on the
    host."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def wrap_spmd(body: Callable, mesh) -> Callable:
    """A callable that runs ``body`` with this rank's line of ``mesh``'s mp
    axis in scope: the default ``process_set`` of the tensor-parallel
    steps and of :class:`TensorParallel` inside it. The reference lifts
    ``body`` into ``shard_map`` over the ``"mp"`` axis; here each process
    is one position on that axis already."""
    ps = mesh.process_set(MP_AXIS)

    def wrapped(*args, **kwargs):
        _SCOPE.append(ps)
        try:
            return body(*args, **kwargs)
        finally:
            _SCOPE.pop()

    return wrapped


# ---------------------------------------------------------------------------
# tensor-parallel training
# ---------------------------------------------------------------------------

def _masked_lookup(table: torch.Tensor, tok: torch.Tensor,
                   rank: int) -> torch.Tensor:
    """The rows of a vocab-sliced ``table`` for the ids this rank owns,
    zeros elsewhere: summed over the ranks they are the replicated lookup,
    bit for bit (x + 0 == x)."""
    vl = table.shape[0]
    lo = rank * vl
    e = table[(tok - lo).clamp(0, vl - 1)]
    ok = ((tok >= lo) & (tok < lo + vl))[..., None]
    return torch.where(ok, e, torch.zeros((), dtype=e.dtype,
                                          device=e.device))


class TensorParallel:
    """This rank's place in a tensor-parallel set (default: the mp set in
    scope, see the module docstring): ``f`` and ``g`` over it, the max, the
    vocab-parallel lookup and the gather of vocab slices.
    :func:`tensor_parallel` hangs one on a model's modules."""

    def __init__(self, process_set=None):
        ps = _mp_set(process_set)
        self.process_set = ps
        self.size, self.rank = ps.size(), ps.rank()
        self.f = identity_fwd_psum_bwd(ps)
        self.g = psum_fwd_identity_bwd(ps)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the set (no gradient)."""
        from horovod_tpu_torch import collective as C
        return C._in_step_allreduce(x.detach().contiguous(), C.Max,
                                    self.process_set, name="tp/max")

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """The vocab-parallel embedding: this rank's rows, one sum over the
        set (its gradient reaches the rows this rank owns)."""
        return self.g(_masked_lookup(table, tokens, self.rank))

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V/mp) slices -> the (B, V) logits, the ranks' slices in
        order (decode's head; no gradient)."""
        from horovod_tpu_torch import collective as C
        b, vl = logits.shape
        flat = C._in_step_allgather(logits.contiguous().reshape(-1),
                                    self.process_set, name="tp/logits")
        return flat.reshape(self.size, b, vl).permute(1, 0, 2) \
            .reshape(b, self.size * vl)

    def __repr__(self) -> str:
        return f"TensorParallel(rank {self.rank} of {self.process_set})"


def _bind(model, attr: str, value) -> None:
    """Set ``attr`` on ``model`` and each of its modules whose class
    declares it."""
    for m in model.modules():
        if attr in vars(type(m)):
            setattr(m, attr, value)


def _wire(model, tp: TensorParallel, rules: PartitionRules):
    """Hang ``tp`` on ``model``'s modules, whose parameters are this rank's
    part under ``rules``: the attention, the MLP and the model place f and
    the vocab-parallel lookup, each row-parallel ``Dense`` sums its
    partial product with g before its bias."""
    from horovod_tpu_torch.models.gpt2 import Dense
    _bind(model, "tp", tp)
    for name, m in model.named_modules():
        if isinstance(m, Dense) and _kind(rules, f"{name}.weight") == "cols":
            m.reduce = tp.g


def _rules_off() -> bool:
    from horovod_tpu_torch.config import get_config
    return get_config().mp_rules == "off"


def tensor_parallel(model, process_set=None, *, sp=None, ep=None):
    """Turn a built GPT-2, Llama or T5 into this rank's tensor-parallel
    part, in place, and return it. Each parameter becomes its
    :func:`split_params` slice of the model's own weights (every rank
    builds them alike), and the modules place the collectives: f at the
    column-parallel inputs of the attention, the MLP and the head, g at
    the row-parallel outputs
    (the bias after the sum), the vocab-parallel embedding. The model's
    forward then returns this rank's (B, T, V/mp) fp32 logits: train it
    with :func:`vocab_parallel_loss`. Build the optimizer after this call.
    Over a one-rank set, or with ``HOROVOD_MP_RULES=off`` (no weight is
    split: every rank holds and runs the whole model, and
    :func:`vocab_parallel_loss` is ``loss_fn``), the weights stay whole.

    ``sp`` (this rank's line of the mesh's sp axis) binds the model's
    sequence parallelism (``use_ring_attention``) to that line: the rings
    or Ulysses run over it at the local head count, wpe / RoPE follow the
    shard's global positions on it, and :func:`vocab_parallel_loss` takes
    it as ``sp=``. Without it the rings run over the global set, which
    holds the tp ranks too, so a split model refuses that.

    ``ep`` (this rank's line of the mesh's ep axis) splits an MoE model's
    experts over it (``ops/moe.ExpertParallel``): this rank keeps experts
    [e*E/ep, (e+1)*E/ep) of every layer, by the models' ``ep`` rules; the
    router stays whole, and tokens are replicated over ep. The experts
    are not split over tp (the reference's rules give ``P("ep", None,
    None)``). Under ``HOROVOD_MP_RULES=off`` every rank keeps every
    expert.

    A T5 splits by ``models/t5.py``'s ``partition_rules`` whatever
    ``HOROVOD_MP_RULES`` says (the reference's dryrun applies them
    directly); the line must divide its heads, gated-GELU width and
    vocab. Its modules then place f at the query input of every
    attention, separately at the cross attention's kv (the encoder's
    states), at the gated-GELU input and at the head, g at ``o`` and
    ``wo``, the vocab-parallel lookup for both stacks, and f on each bias
    table before this rank's heads' columns. Train it with
    ``t5.seq2seq_loss``. T5 has no sequence or expert parallelism:
    ``sp=`` and ``ep=`` are refused.

    The reference annotates the whole parameters with
    :func:`mp_partition_rules` and lets GSPMD place the same collectives,
    naming the ``"sp"`` and ``"ep"`` axes where the port takes their
    lines."""
    from horovod_tpu_torch.ops.moe import ExpertParallel
    from horovod_tpu_torch.ops.ring_attention import Ring
    cfg = model.cfg
    tp = TensorParallel(process_set)
    if model.tp is not None or model.sp is not None:
        raise ValueError(f"the model is tensor-parallel already "
                         f"({model.tp}, sp {model.sp})")
    if _family(cfg).name == "t5":
        if sp is not None or ep is not None:
            raise ValueError("T5 has no sequence or expert parallelism: "
                             "tensor_parallel refuses sp= and ep= for it")
        rules = _t5_rules(cfg, tp.size)
    else:
        validate_tp(cfg, tp.size)
        rules = mp_partition_rules(cfg)
    split_tp = tp.size > 1 and bool(rules.rules)
    if sp is not None and not cfg.use_ring_attention:
        raise ValueError("sp= binds the sequence-parallel attention: the "
                         "config needs use_ring_attention=True")
    if getattr(cfg, "use_ring_attention", False) and sp is None \
            and split_tp:
        raise ValueError(
            "a tensor-parallel model with use_ring_attention needs its sp "
            "line: tensor_parallel(model, process_set=mesh.process_set("
            "'tp'), sp=mesh.process_set('sp')); over the global set the "
            "rings would hold the tp ranks too")
    experts = getattr(cfg, "num_experts", 0)
    if ep is not None and experts <= 0:
        raise ValueError("ep= splits the experts of an MoE config; this "
                         "one has none")
    if ep is not None and experts % ep.size():
        raise ValueError(f"ep={ep.size()} must divide num_experts="
                         f"{experts} (each rank keeps whole experts)")
    moe_ep = ExpertParallel(ep) if ep is not None and ep.size() > 1 \
        and rules.rules else None
    if split_tp or moe_ep is not None:
        state = model.state_dict()
        with torch.no_grad():
            for name, p in model.named_parameters():
                v = state[name]
                if split_tp:
                    v = _split_one(_kind(rules, name), v, tp.size, tp.rank)
                if moe_ep is not None and _ep_split(rules, name):
                    v = _split_one("rows", v, moe_ep.size, moe_ep.rank)
                p.data = v.to(device=p.device, dtype=p.dtype, copy=True)
    if split_tp:
        _wire(model, tp, rules)
    if sp is not None:
        _bind(model, "sp", Ring(sp))
    if moe_ep is not None:
        _bind(model, "ep", moe_ep)
    return model


def vocab_parallel_loss(logits: torch.Tensor, tokens: torch.Tensor,
                        process_set=None,
                        segment_ids: Optional[torch.Tensor] = None,
                        *, sp=None, layout: str = "contiguous"
                        ) -> torch.Tensor:
    """``loss_fn`` (next-token cross entropy; with ``segment_ids`` the
    targets that cross a packed document boundary are left out) over
    this rank's vocab slice of the logits, (B, T, V/mp): the row max is
    maxed over the set, the sum of exponentials and the target's logit
    (from the rank that owns it) summed, so every rank returns the loss of
    the whole vocab and its logits' gradient; the logits are never
    gathered. Over a one-rank set, or with ``HOROVOD_MP_RULES=off`` (the
    logits are whole), it is ``loss_fn``.

    ``sp`` (the model's sp line, or a ``Ring`` over it) takes the logits
    and tokens as this rank's sequence shard in ``layout`` (the model's
    ``ring_layout``): the loss is then ``loss_fn`` over the whole
    sequence, each shard's last target fetched from the next shard
    (``models.gpt2.sharded_lm_loss``), the sums reduced over the line, so
    every rank returns the global mean and each rank's gradient is sp
    times its share (the optimizer's average over the dp x sp plane
    cancels it). Packed sequences under sp are refused."""
    from horovod_tpu_torch.models.gpt2 import loss_fn, sharded_lm_loss
    ps = _mp_set(process_set)
    whole = ps.size() == 1 or _rules_off()
    if sp is not None:
        if segment_ids is not None:
            raise ValueError("vocab_parallel_loss: packed sequences under "
                             "sp are not supported (segment_ids with sp=)")
        return sharded_lm_loss(
            logits, tokens, sp, layout,
            None if whole else functools.partial(_vocab_parallel_ll,
                                                 TensorParallel(ps)))
    if whole:
        return loss_fn(logits, tokens, segment_ids)
    return _vocab_parallel_loss(TensorParallel(ps), logits, tokens,
                                segment_ids)


def _vocab_parallel_ll(tp, logits, targets):
    """The (B, t) log-likelihoods of ``targets`` under this rank's vocab
    slice of ``logits``, over ``tp``'s ``max`` and ``g``."""
    lg = logits.float()
    tgt = targets.long()
    vl = lg.shape[-1]
    lo = tp.rank * vl
    m = tp.max(lg.detach().amax(-1))
    own = (tgt >= lo) & (tgt < lo + vl)
    t_own = lg.gather(-1, (tgt - lo).clamp(0, vl - 1)[..., None])[..., 0]
    t_own = torch.where(own, t_own, torch.zeros((), device=lg.device))
    se = torch.exp(lg - m[..., None]).sum(-1)
    se, t = tp.g(torch.stack([se, t_own]))
    return t - m - torch.log(se)


def _vocab_parallel_loss(tp, logits, tokens, segment_ids=None):
    """:func:`vocab_parallel_loss`'s arithmetic over ``tp``'s ``max`` and
    ``g``."""
    ll = _vocab_parallel_ll(tp, logits[:, :-1], tokens[:, 1:])
    if segment_ids is None:
        return -ll.mean()
    w = (segment_ids[:, 1:] == segment_ids[:, :-1]).to(ll.dtype)
    return -(ll * w).sum() / w.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# tensor-parallel decode: the models/generate.py registry steps over a
# model that holds this rank's part
# ---------------------------------------------------------------------------

def _part_model(cfg, params, tp: TensorParallel):
    """A GPT-2, Llama or T5 built on the meta device whose parameters are
    ``params`` (this rank's part, any device: :func:`split_params`', or
    for T5 :func:`_split_t5`'s), wired as :func:`tensor_parallel` wires it
    (over a one-rank set: the dense model)."""
    from horovod_tpu_torch.models.gpt2 import GPT2
    from horovod_tpu_torch.models.llama import Llama
    from horovod_tpu_torch.models.t5 import T5
    fam = _family(cfg).name
    with torch.device("meta"):
        model = {"gpt2": GPT2, "llama": Llama, "t5": T5}[fam](cfg)
    for name, t in params.items():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        setattr(model.get_submodule(owner), leaf,
                torch.nn.Parameter(t, requires_grad=False))
    if tp.size > 1:
        _wire(model, tp, _t5_rules(cfg, tp.size) if fam == "t5"
              else mp_partition_rules(cfg, "megatron"))
    return model


def _split_t5(cfg, params, mp: int, rank: int):
    """Rank ``rank``'s 1/mp part of a T5 state dict, as
    :func:`tensor_parallel` splits the model (:func:`split_params` refuses
    T5, as the reference's does)."""
    rules = _t5_rules(cfg, mp)
    return {k: _split_one(_kind(rules, k), _as_tensor(v), mp, rank)
            for k, v in params.items()}


def tp_decode_step(cfg, process_set=None):
    """Tensor-parallel ``(params, cache, tok, pos, extras=None) -> (cache,
    logits)``: the registry decode step (``models.generate.decode_step``)
    over this rank's :func:`split_params` part and a cache of 1/mp of the
    kv heads (``process_set``: see the module docstring). The part is put
    into a model built on the meta device and wired as
    :func:`tensor_parallel` wires it; the step's head gathers the vocab
    slices, so the logits come back whole and ``greedy_token``, the verify
    loop and sampling work unchanged. Over a one-rank set it is
    ``decode_step`` on the whole parameters."""
    from horovod_tpu_torch.models.generate import decode_step
    fam = _family(cfg)
    if fam.name not in ("gpt2", "llama"):
        raise NotImplementedError(
            f"tensor-parallel decode is implemented for gpt2/llama, "
            f"not {fam.name!r}")
    step = decode_step(cfg)
    held = {}

    def tp_step(params, cache, tok, pos, extras=None):
        tp = TensorParallel(process_set)
        validate_tp(cfg, tp.size)
        key = (id(tp.process_set), tuple(map(id, params.values())))
        if held.get("key") != key:
            # The set and the tensors stay referenced, so their ids are not
            # reused while the model is held.
            held.update(key=key, refs=(tp, list(params.values())),
                        model=_part_model(cfg, params, tp))
        return step(held["model"], cache, tok, pos, extras)

    return tp_step


def tp_decode_verify_step(cfg, process_set=None):
    """Tensor-parallel twin of ``models.generate.decode_verify_step``: the
    same K-token chain (K = 1 is the one-token step) over
    :func:`tp_decode_step`."""
    from horovod_tpu_torch.models.generate import greedy_token
    step = tp_decode_step(cfg, process_set)

    @torch.no_grad()
    def verify(params, cache, tok_seq, pos0, counts=None, extras=None,
               mask_fn=None):
        pos0 = torch.as_tensor(pos0, dtype=torch.long,
                               device=tok_seq.device)
        first, greedy = None, []
        for j in range(tok_seq.shape[0]):
            if mask_fn is not None and counts is not None:
                cache = mask_fn(cache, j < counts)
            cache, logits = step(params, cache, tok_seq[j], pos0 + j, extras)
            if first is None:
                first = logits.float()
            greedy.append(greedy_token(logits))
        return cache, first, torch.stack(greedy)

    return verify


# ---------------------------------------------------------------------------
# ZeRO-2 / ZeRO-3
# ---------------------------------------------------------------------------

def gather_shard(shard: torch.Tensor, process_set=None,
                 wire: Optional[str] = None) -> torch.Tensor:
    """``(c,)`` row -> the ``(n * c,)`` vector over ``process_set``,
    optionally on a reduced-precision wire: None / ``"fp32"`` is the exact
    all-gather, ``"bf16"`` casts the payload around it, ``"int8"`` /
    ``"fp8"`` ship the 1-byte block format with one fp32 scale per 256
    values (``ops/quantized.py``), gathered as per-rank rows so each
    rank's ragged scale tail stays with its payload (lossy: bit-exact
    checks stay on the default wire). In-step all-gathers: no negotiation
    round."""
    return _fsdp._gather(shard, _fsdp._set(process_set), wire,
                         "gather_shard")


def zero3_apply(block_fn: Callable, template: Any, shard: torch.Tensor, x,
                process_set=None, wire: Optional[str] = None):
    """ZeRO-3 block apply: :func:`parallel.fsdp.fsdp_apply` (the exact
    fp32 path) unless ``wire`` picks a reduced-precision gather; then the
    forward's gather and the backward's gather-again ride that wire (the
    recompute sees the forward's weights) and the gradient's
    reduce-scatter stays fp32."""
    if not wire or wire == "fp32":
        return fsdp_apply(block_fn, template, shard, x,
                          process_set=process_set)
    ps = _fsdp._set(process_set)
    length = _fsdp._check(template, shard.shape[-1], ps.size())
    return _fsdp._apply(block_fn, _fsdp._as_struct(template), length, shard,
                        x, ps, wire)


def zero2_grad_shard(grads, process_set=None) -> torch.Tensor:
    """ZeRO-2 gradient ownership: a tree of this rank's gradients -> its
    ``(c,)`` chunk of their mean over ``process_set``, by one
    reduce-scatter: the data-parallel sync and the sharding are the same
    collective."""
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.ops.quantized import true_div
    ps = _fsdp._set(process_set)
    n = ps.size()
    flat = _flatten(grads)
    c = -(-flat.shape[0] // n)
    flat = torch.nn.functional.pad(flat, (0, n * c - flat.shape[0]))
    return true_div(C._in_step_reducescatter(flat, ps, "zero2/grads",
                                                trace_one=True), n)


def zero2_update(params, g_shard: torch.Tensor, state: ShardedAdamWState,
                 *, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, process_set=None,
                 wire: Optional[str] = None):
    """One ZeRO-2 step: AdamW on this rank's owned chunk (its state stays
    ``(c,)``), then one all-gather of the update, optionally on a
    reduced-precision wire (:func:`gather_shard`), added to the still
    replicated parameters. Returns ``(new_params, new_state)``: new
    tensors in ``params``' structure and dtypes.

    The stage between ``sharded_adamw`` (ZeRO-1) and :func:`zero3_apply`
    (parameters sharded too): parameters replicated, gradients and
    optimizer state owned. ``state`` is this rank's row of
    ``zero3_adamw(...).init``'s layout."""
    ps = _fsdp._set(process_set)
    n, r = ps.size(), ps.rank()
    flat_p = _flatten(params)
    c = g_shard.shape[0]
    p_pad = torch.nn.functional.pad(flat_p, (0, n * c - flat_p.shape[0]))
    upd, (step, mu, nu) = _adamw_chunk_update(
        g_shard, state, p_pad[r * c:(r + 1) * c], learning_rate, b1, b2,
        eps, weight_decay)
    full_upd = _fsdp._gather(upd, ps, wire, "zero2/updates")[
        :flat_p.shape[0]]
    return _unflatten(flat_p + full_upd, params), \
        ShardedAdamWState(step=step, mu=mu, nu=nu)

