"""Operation-stream cost model (flops + device-memory bytes + collectives) of a
torch program, the port of the reference's ``hlocount.py``.

The reference walks the post-optimisation XLA HLO of a compiled SPMD
program.  The port has no HLO: it runs eagerly, so ``analyze(fn, *args)``
runs ``fn`` under a ``TorchDispatchMode`` and counts the ATen operations
that reach the dispatcher, forward and backward.  Real tensors and
``meta`` tensors are both allowed; on ``meta`` nothing is allocated or
computed, which is the port's form of the reference's compile-only dry
run.  The reference's rules, applied to that stream:

  * flops: a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm`` ...) = 2 x result
    elements x contracted extent (plus the result elements of a fused
    bias add); an elementwise op = result elements; a reduction = input
    elements;
  * bytes: every materialising op contributes its result + operand
    bytes.  In eager every op materialises (there is no fusion), which is
    the reference's rule for a top-level op; views cost nothing; a slice
    or gather (``index``, ``gather``, ``index_select``, ``embedding``)
    reads only its window (2 x result bytes) and an in-place window write
    (``copy_``, ``index_put_``) costs 2 x the update's bytes, as the
    reference's dynamic-slice and dynamic-update-slice rules say.  Dtype
    casts are charged, where the reference charges nothing for
    ``convert``: on the card an eager cast is a kernel that reads and
    writes device memory;
  * collectives: the ones the port makes (the sharded steps' gathers and
    reductions, the pipeline's moves; ``distributed.sharding.
    collective_log``), each with its kind, group size and result bytes,
    their wire bytes by the reference's per-kind formulas.

The program counted is whatever ``fn`` runs: for the dry run, one
shard's program (``distributed/spmd.py``'s ``shard_program``), so the
results are per shard, as the reference's are per device.  Loops need no
trip count: a Python loop's ops reach the dispatcher once a pass.

Not mapped: ``max_trip_count`` and ``total_trip_count`` read the HLO's
loop trip counts, the program's sequential depth.  The port's sequential
depth is inside its kernels (K1's T radix steps are one launch), where
no operation stream sees it, so both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HloCost", "analyze", "affine", "wire_bytes", "max_trip_count",
           "total_trip_count"]

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv"}

_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp",
    "prod", "any", "all", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "cumsum", "cumprod", "count_nonzero",
}

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "exp", "exp2", "expm1", "log",
    "log1p", "log2", "tanh", "sigmoid", "silu", "gelu", "relu", "rsqrt", "sqrt",
    "pow", "abs", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "__lshift__", "__rshift__", "__and__", "__or__", "__xor__",
    "remainder", "fmod", "floor", "ceil", "round", "trunc", "sign", "cos",
    "sin", "softplus", "erf", "reciprocal", "square", "atan2", "isfinite",
    "isnan", "isinf", "masked_fill", "lerp", "addcmul", "addcdiv", "floor_divide",
    "_softmax", "_log_softmax", "silu_backward", "sigmoid_backward",
    "tanh_backward", "threshold_backward", "softplus_backward",
    "_softmax_backward_data", "_log_softmax_backward_data", "gelu_backward",
    "logit", "hypot", "copysign", "nan_to_num", "mse_loss",
}

# ops that materialise without arithmetic (result + operand bytes, or the
# window rules below)
_MOVES = {
    "cat", "stack", "clone", "_to_copy", "repeat", "repeat_interleave",
    "constant_pad_nd", "roll", "flip", "tril", "triu", "scatter", "scatter_add",
    "index_add", "index_copy", "sort", "topk", "cumsum_backward", "one_hot",
    "_unsafe_index", "masked_scatter", "embedding_dense_backward",
    "index_put", "convolution", "convolution_backward", "_unsafe_index_put",
    "select_backward", "slice_backward",
}
_WINDOW_READS = {"index", "gather", "index_select", "embedding", "take"}
_WINDOW_WRITES = {"copy_", "index_put_", "_index_put_impl_", "slice_scatter",
                  "select_scatter", "masked_scatter_"}
_FILLS = {"fill", "zero", "zeros", "ones", "full", "zeros_like", "ones_like",
          "full_like", "arange", "linspace", "normal", "uniform", "randint",
          "random", "bernoulli", "scalar_tensor", "new_zeros", "new_ones",
          "new_full"}
# no bytes and no flops: views, metadata and allocation without a write
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "slice", "select", "unsqueeze", "squeeze", "as_strided",
    "detach", "alias", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "diagonal", "unflatten", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "resize_", "set_", "_local_scalar_dense", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_has_compatible_shallow_copy_type",
    "clone_preserve_strides", "expand_as", "view_as", "contiguous", "numpy_T",
    "_conj", "conj", "_neg_view", "resolve_conj", "resolve_neg", "real",
    "_unsafe_split",
}


@dataclasses.dataclass
class HloCost:
    """Counts of one program (the reference's fields), plus the records
    of its collectives."""

    flops: float = 0.0
    bytes: float = 0.0
    dot_flops: float = 0.0
    wire_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    unknown_ops: tuple = ()
    collectives: list = dataclasses.field(default_factory=list)
    op_counts: dict = dataclasses.field(default_factory=dict)


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors among an op's arguments or results (tensors, and lists
    or tuples of them, as ATen passes them)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out: torch.Tensor) -> Tuple[float, float]:
    """(dot flops, fused bias-add flops) of a dot op."""
    if name in ("mm", "bmm", "dot", "vdot", "mv"):
        lhs = args[0]
        bias = 0
    else:  # addmm, baddbmm, addbmm, addmv: (bias, lhs, rhs)
        lhs = args[1]
        bias = out.numel()
    contracted = lhs.shape[-1] if lhs.dim() else 1
    return 2.0 * out.numel() * contracted, float(bias)


def wire_bytes(kind: str, group_size: int, result_bytes: float) -> float:
    """The reference's ring-model wire bytes of one collective
    (``src/repro/hlocount.py:165-188``)."""
    g = group_size
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind == "all-gather":
        return (g - 1) / g * result_bytes
    if kind == "reduce-scatter":  # result is the shard
        return (g - 1) * result_bytes
    if kind == "all-to-all":
        return (g - 1) / g * result_bytes
    return float(result_bytes)  # collective-permute


_BOOL_OUT = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
             "logical_not", "logical_xor", "isnan", "isinf", "isfinite"}
_PROMOTE = {"add", "sub", "rsub", "mul", "maximum", "minimum", "pow"}
_SAME = {"neg", "abs", "square", "masked_fill"}
_FLOAT_OUT = {"exp", "log", "tanh", "sigmoid", "silu", "rsqrt", "sqrt", "reciprocal"}


def _meta_elementwise(name: str, base: str, args, kwargs):
    """The result of an elementwise op on ``meta`` tensors, made without
    running the op (whose meta form is a slow Python reference in
    torch), or None where the rule below does not cover the call."""
    if kwargs and set(kwargs) - {"alpha"}:
        return None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "meta" for t in tensors):
        return None
    if name != base:  # in place: the result is the first argument
        return args[0] if base in _PROMOTE | _SAME | _FLOAT_OUT else None
    if base in _BOOL_OUT:
        dtype = torch.bool
    elif base == "where" and len(args) == 3:
        dtype = torch.result_type(args[1], args[2])
    elif base in _PROMOTE:
        dtype = torch.result_type(*args[:2]) if len(args) >= 2 else None
    elif base in _SAME:
        dtype = args[0].dtype
    elif base in _FLOAT_OUT or base == "div":
        if base == "div" and len(args) != 2:
            return None
        dtype = torch.result_type(*args) if base == "div" else args[0].dtype
        if not dtype.is_floating_point:
            dtype = torch.get_default_dtype()
    else:
        return None
    if dtype is None:
        return None
    # contiguous: an op after it that needs a layout copies no more than
    # it would on the real result
    return torch.empty(torch.broadcast_shapes(*[t.shape for t in tensors]),
                       dtype=dtype, device="meta")


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.unknown = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and not name.endswith("__") else name
        out = _meta_elementwise(name, base, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        c = self.cost
        c.op_counts[name] = c.op_counts.get(name, 0) + 1
        if name in _FREE or base in _FREE:
            return out
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        res_b = sum(_nbytes(t) for t in outs)
        in_b = sum(_nbytes(t) for t in ins)
        if name in _WINDOW_WRITES:
            upd = ins[1] if len(ins) > 1 else (outs[0] if outs else None)
            c.bytes += 2 * (_nbytes(upd) if upd is not None else 0)
        elif base in _WINDOW_READS:
            c.bytes += 2 * res_b
        elif base in _DOTS:
            dot, bias = _dot_flops(base, args, outs[0])
            c.flops += dot + bias
            c.dot_flops += dot
            c.bytes += res_b + in_b
        elif base in _REDUCE:
            c.flops += ins[0].numel() if ins else 0
            c.bytes += res_b + in_b
        elif base in _ELEMENTWISE:
            c.flops += sum(t.numel() for t in outs)
            c.bytes += res_b + in_b
        elif base in _MOVES:
            c.bytes += res_b + in_b
        elif base in _FILLS:
            c.bytes += res_b
        else:
            self.unknown.add(name)
            c.bytes += res_b
        return out


def affine(c1: HloCost, c2: HloCost, n: int) -> HloCost:
    """The cost at depth ``n`` of a program whose costs at depths 1 and 2
    are ``c1`` and ``c2``, for a program affine in its depth (a stack of
    identical layers: every count is a fixed part plus one layer's part
    a layer): ``c1 + (n - 1) (c2 - c1)``.  It is the reference's while-loop
    rule, a body's count times its trip count, for a Python loop."""
    def lin(a, b):
        return a + (n - 1) * (b - a)

    out = HloCost(
        flops=lin(c1.flops, c2.flops), bytes=lin(c1.bytes, c2.bytes),
        dot_flops=lin(c1.dot_flops, c2.dot_flops),
        wire_bytes=lin(c1.wire_bytes, c2.wire_bytes),
        unknown_ops=tuple(sorted(set(c1.unknown_ops) | set(c2.unknown_ops))),
    )
    for attr in ("coll_counts", "op_counts"):
        d1, d2 = getattr(c1, attr), getattr(c2, attr)
        setattr(out, attr, {k: lin(d1.get(k, 0), d2.get(k, 0)) for k in {*d1, *d2}})
    if len(c1.collectives) != len(c2.collectives):
        raise ValueError("the two depths make different collectives")
    for r1, r2 in zip(c1.collectives, c2.collectives):
        r = dict(r2)
        r["result_bytes"] = lin(r1["result_bytes"], r2["result_bytes"])
        r["shape"] = tuple(lin(a, b) for a, b in zip(r1["shape"], r2["shape"]))
        out.collectives.append(r)
    return out


def analyze(fn, *args, **kwargs) -> HloCost:
    """Run ``fn(*args, **kwargs)`` and count its operations and the
    collectives it records (module docstring)."""
    from repro_torch.distributed.sharding import collective_log

    counter = _Counter()
    with collective_log() as log, counter:
        fn(*args, **kwargs)
    cost = counter.cost
    cost.unknown_ops = tuple(sorted(counter.unknown))
    cost.collectives = list(log)
    for r in log:
        cost.wire_bytes += wire_bytes(r["kind"], r["group_size"], r["result_bytes"])
        cost.coll_counts[r["kind"]] = cost.coll_counts.get(r["kind"], 0) + 1
    return cost


def _not_mapped(name: str):
    raise NotImplementedError(
        f"hlocount.{name} reads XLA loop trip counts, which the port does not "
        "have: its sequential depth is inside its kernels (K1's radix steps "
        "are one launch), where no operation stream sees it")


def max_trip_count(*_args, **_kwargs) -> int:
    """Not mapped (module docstring); raises ``NotImplementedError``."""
    _not_mapped("max_trip_count")


def total_trip_count(*_args, **_kwargs) -> int:
    """Not mapped (module docstring); raises ``NotImplementedError``."""
    _not_mapped("total_trip_count")
