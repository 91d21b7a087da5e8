"""Roofline terms of a dry-run step: the port's copy of
``repro.launch.analysis``.

  compute term    = FLOPs / peak FLOP/s                (per rank)
  memory term     = bytes / HBM bandwidth              (per rank)
  collective term = collective bytes / link bandwidth  (per rank)

The denominators are a :class:`launch.mesh.Hardware` (one H100 SXM 80GB by
default).  :func:`analytic_roofline` prices the step from the program's
structure, as the reference does; the "raw" terms come from what the dry
run counted on rank 0: ``FlopCounterMode``'s FLOPs and the result bytes of
every collective the step issued (:class:`StepCounter`, a dispatch mode
over rank 0's local ops: the functional collectives that DTensor and
``_functional_collectives`` issue, and ``c10d`` send / recv).  The port
has no HLO text, so :func:`collective_bytes` sums those records by kind.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..distributed.sharding import axis_sizes
from .mesh import H100, Hardware

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ATen op name prefix -> collective kind
_OP_KINDS = (
    ("all_gather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
    ("send", "collective-permute"),
    ("recv", "collective-permute"),
)


def _op_kind(name: str) -> str | None:
    """``_c10d_functional.all_gather_into_tensor.default`` ->
    "all-gather"; None for an op that is no collective (``wait_tensor``
    included)."""
    ns, _, op = name.partition(".")
    if ns not in ("_c10d_functional", "c10d", "_c10d_functional_autograd"):
        return None
    for prefix, kind in _OP_KINDS:
        if op.startswith(prefix) or op.startswith("_" + prefix):
            return kind
    return None


def _bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_bytes(o) for o in out)
    return 0


#: DTensor's functions that derive a new op's output shapes by running it
#: once on fake whole tensors (torch 2.11 to 2.13)
_PROPAGATION = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


class StepCounter(TorchDispatchMode):
    """What one rank's step does, counted on its local tensors (a DTensor
    op is let through to DTensor, which desugars it into local ops and
    collectives that this mode then sees, as ``CommDebugMode`` does).
    While it is active, DTensor's shape propagation (which runs each new
    op once on fake whole tensors) is wrapped to raise a flag, and the ops
    it runs are skipped.  ``FlopCounterMode`` counts a DTensor op on its
    whole tensors, not a rank's share, and ``CommDebugMode`` counts
    collectives but not their bytes, so neither serves as it is.

    * ``flops``: ``torch.utils.flop_counter``'s count of every op it
      prices (matmuls, convolutions, attention);
    * ``bytes_accessed``: every op's tensor operands' and results' bytes
      (XLA cost analysis's "bytes accessed", op by op);
    * ``records``: (collective kind, result bytes) of every collective;
    * ``peak_bytes``: the most bytes held at once by the tensors made
      inside it (storages counted once, freed when their last view goes).
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.records: list[tuple[str, int]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: set[int] = set()
        self._propagating = 0
        self._saved: dict = {}

    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        for name in _PROPAGATION:
            fn = getattr(prop, name, None)
            if fn is not None:
                self._saved[name] = prop.__dict__.get(name)
                setattr(prop, name, self._flagged(fn))
        if not self._saved:
            raise RuntimeError("DTensor's shape propagation not found: "
                               f"none of {_PROPAGATION}")
        return super().__enter__()

    def __exit__(self, *a):
        prop = DTensor._op_dispatcher.sharding_propagator
        for name, own in self._saved.items():
            if own is None:
                delattr(prop, name)         # the class's method again
            else:
                setattr(prop, name, own)
        self._saved.clear()
        return super().__exit__(*a)

    def _flagged(self, fn):
        def run(*args, **kwargs):
            self._propagating += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._propagating -= 1
        return run

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (the step's arguments:
        DTensors by their shards) as held before the step: views of them
        are no new bytes."""
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._storages.add(id(t.untyped_storage()))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        self._storages.add(key)
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, st.nbytes())

    def _free(self, key: int, nbytes: int) -> None:
        self._storages.discard(key)
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating:
            return out         # DTensor's shape propagation: no work
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _op_kind(str(func))
        if kind is not None:
            self.records.append((kind, _bytes(out)))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes_accessed += _bytes([t for t in tree_leaves((args, kwargs))
                                       if isinstance(t, torch.Tensor)]) + \
            _bytes(outs)
        for t in outs:
            if t.device.type != "meta":       # no storage behind it
                self._track(t)
        return out


def collective_bytes(records) -> dict[str, int]:
    """Sum result bytes per collective kind over (kind, bytes) records."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in records:
        out[kind] += nbytes
        out["count"] += 1
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                  # per-rank flops
    hbm_bytes: float              # per-rank bytes accessed
    coll_bytes: float             # per-rank collective bytes
    model_flops_per_chip: float   # 6ND (or 2ND) / ranks
    hw: Hardware = H100
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops / self.hw.peak_flops_bf16
        self.memory_s = self.hbm_bytes / self.hw.hbm_bw
        self.collective_s = self.coll_bytes / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much compute is 'useful'
        (catches remat/redundancy waste)."""
        return (self.model_flops_per_chip / self.flops) if self.flops else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Roofline fraction: useful FLOPs / (peak * bound time)."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops_per_chip / (self.hw.peak_flops_bf16
                                            * self.bound_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "model_flops_per_chip": self.model_flops_per_chip,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.mfu_upper_bound,
        }


def model_flops(cfg, cell, n_chips: int) -> float:
    """6*N*D for training, 2*N*D for forward-only (per whole step)."""
    n_active = cfg.active_param_estimate()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6 if cell.kind == "train" else 2
    return mult * n_active * tokens / n_chips


# ---------------------------------------------------------------------------
# analytic roofline model: the reference's, term for term
# ---------------------------------------------------------------------------


def _subquadratic_attn(cfg, B: int, S: int, d: int, L: int,
                       mult: float) -> float:
    """SSD intra-chunk quadratic + xLSTM D-matrix quadratic."""
    from ..models.xlstm import MLSTM_CHUNK, MLSTM_CHUNK_THRESHOLD
    if cfg.family == "hybrid":
        q = cfg.ssm_chunk
    else:
        q = MLSTM_CHUNK if S >= MLSTM_CHUNK_THRESHOLD else S
    heads = (cfg.ssm_expand * d // cfg.ssm_head_dim
             if cfg.family == "hybrid" else cfg.n_heads)
    hd = (cfg.ssm_head_dim if cfg.family == "hybrid" else d // cfg.n_heads)
    return mult * B * S * q * heads * hd * L


def analytic_roofline(cfg, cell, mesh, rules, microbatches: int = 1,
                      remat_policy: str = "full",
                      hw: Hardware = H100) -> dict:
    shape = axis_sizes(mesh)
    n_chips = 1
    for v in shape.values():
        n_chips *= v
    dp = 1
    for a in ("pod", "data"):
        if a in shape:
            dp *= shape[a]
    tp = shape.get("model", 1)

    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    n_active = cfg.active_param_estimate()
    dtype_b = 2  # bf16

    batch_shardable = B % dp == 0 and B >= dp
    b_local = B // dp if batch_shardable else B
    attn_layers = L if cfg.family not in ("ssm", "hybrid") else \
        (L // cfg.shared_attn_every if cfg.shared_attn_every else 0)
    sub_quad = cfg.family in ("ssm", "hybrid")

    # ---- FLOPs per rank ----------------------------------------------------
    no_recompute = remat_policy in ("dots", "block_outs")
    passes = 2 if no_recompute else 3  # fwd(+recompute)+bwd collect. passes
    if cell.kind == "train":
        tokens = B * S
        # fwd 2N + bwd 4N (+ recompute 2N under full remat; block_outs
        # still recomputes the intra-block math, but that re-issues no
        # collectives -- only the flops term keeps the recompute share)
        lin = (6.0 if remat_policy == "dots" else 8.0) * n_active * tokens
        quad_mult = 12.0 if no_recompute and remat_policy == "dots" else 16.0
        attn = quad_mult * B * S * S * cfg.n_heads * cfg.head_dim \
            * attn_layers
        if sub_quad:
            attn += _subquadratic_attn(cfg, B, S, d, L, quad_mult)
        flops = (lin + attn) / n_chips
    elif cell.kind == "prefill":
        tokens = B * S
        lin = 2.0 * n_active * tokens
        attn = 4.0 * B * S * S * cfg.n_heads * cfg.head_dim * attn_layers
        if sub_quad:
            attn += _subquadratic_attn(cfg, B, S, d, L, 4.0)
        flops = (lin + attn) / n_chips
    else:  # decode: one token over the whole batch
        lin = 2.0 * n_active * B
        attn = 4.0 * B * S * cfg.n_heads * cfg.head_dim * attn_layers
        flops = (lin + attn) / n_chips

    # ---- HBM bytes per rank -------------------------------------------------
    params_local = n_active * dtype_b / tp  # active weights, TP-sharded
    if cell.kind == "train":
        # per microbatch: read weights fwd + recompute + bwd grad writes;
        # optimizer: read/write mu, nu (f32) + params
        weight_traffic = 3.0 * microbatches * params_local
        opt_traffic = (4 + 4 + 4 + 4 + 2 + 2) * n_active / tp
        act_traffic = 12.0 * B * S * d * L * dtype_b / n_chips
        hbm = weight_traffic + opt_traffic + act_traffic
    elif cell.kind == "prefill":
        hbm = params_local + 8.0 * B * S * d * L * dtype_b / n_chips
    else:
        kv_byte = 1 + 2 / cfg.head_dim if cfg.kv_cache_dtype == "int8" \
            else dtype_b
        kv_bytes = (2 * attn_layers * cfg.n_kv_heads * cfg.head_dim
                    * S * B * kv_byte) if cfg.family not in ("ssm",) else 0
        if sub_quad:
            d_in = cfg.ssm_expand * d
            state = (d_in // max(cfg.ssm_head_dim, 1)) * cfg.ssm_head_dim \
                * cfg.ssm_state * 4
            kv_bytes += L * B * state
        hbm = params_local + kv_bytes / n_chips * 1.0

    # ---- collective bytes per rank ------------------------------------------
    # family-aware TP all-reduce counts: an attention block has 2 row-
    # parallel matmuls (attn-out, mlp-down); a Mamba2 block 1 (out_proj);
    # an mLSTM block 1 (m_out) -- and only when the corresponding logical
    # axis actually maps onto the model mesh axis for this config.
    def ring(p):
        return 2.0 * (p - 1) / max(p, 1)
    attn_tp = 2 if (rules.axis("heads") or rules.axis("kv_heads")
                    or rules.axis("ff")) else 0
    if cfg.moe:
        attn_tp += 2 if rules.axis("experts") else 0  # dispatch/combine
    mamba_tp = 1 if rules.axis("ff") else 0
    mlstm_tp = 1 if rules.axis("heads") else 0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        ars = attn_tp * L
    elif cfg.family == "hybrid":
        n_attn = L // cfg.shared_attn_every if cfg.shared_attn_every else 0
        ars = mamba_tp * L + attn_tp * n_attn
    else:  # ssm / xlstm
        n_slstm = L // cfg.slstm_every if cfg.slstm_every else 0
        ars = mlstm_tp * (L - n_slstm)
    if rules.axis("vocab"):
        ars += 1  # unembed boundary

    coll = 0.0
    if cell.kind == "train":
        grad_local = 4.0 * n_active / tp          # f32 grads, TP-sharded
        if getattr(rules, "grad_compression", None) == "int8":
            grad_local /= 4.0                     # int8 payload (+scales)
        coll += ring(dp) * grad_local             # DP all-reduce
        # x (fwd, bwd [, recompute]) passes over b_local total rows
        if tp > 1:
            coll += ring(tp) * b_local * S * d * dtype_b * passes * ars
    elif cell.kind == "prefill":
        if tp > 1:
            coll += ring(tp) * b_local * S * d * dtype_b * ars
    else:
        if tp > 1:
            coll += ring(tp) * b_local * 1 * d * dtype_b * ars

    roof = Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                    model_flops_per_chip=model_flops(cfg, cell, n_chips),
                    hw=hw)
    out = roof.as_dict()
    out["source"] = "analytic"
    out["hardware"] = dataclasses.asdict(hw)
    return out
