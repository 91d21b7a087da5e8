"""Carry the JAX package's planned state and keys into the port.

A planned memory program crosses as the fixed-width instruction records
both packages share (``core.bytecode``: same opcodes, same layout) plus a
header of the program's fields, so neither side imports the other: the
JAX package's ``encode_chunk(program.instrs)`` produces ``rec``.

A CKKS context crosses as its keys, NumPy arrays (``ckks_context_from_keys``),
a language model as its parameter tree, NumPy arrays
(``lm_params_from_jax``, ``encdec_params_from_jax``; a gradient tree
crosses the same way), and a training run's optimizer state as its moments
and step (``opt_state_from_jax``).  The garbler's state
needs no converter: R and every fresh label come from
``numpy.random.default_rng(seed)`` in the same order in both packages, as
do a CKKS context's keys when both are built from one seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.bytecode import Program, decode_chunk
from .models.config import ModelConfig
from .protocols.ckks.cipher import CkksContext
from .protocols.ckks.params import CkksParams

HEADER_FIELDS = ("page_shift", "phase", "num_frames", "prefetch_slots",
                 "vspace_slots", "meta")


def program_from_records(rec: np.ndarray, header: dict) -> Program:
    """Build the port's Program from ``rec``, an ``[n, RECORD_WORDS]``
    int64 record array, and ``header`` with the program's page_shift,
    phase, num_frames, prefetch_slots, vspace_slots and meta (protocol,
    worker and num_workers are optional: gc, 0 and 1)."""
    missing = [k for k in HEADER_FIELDS if k not in header]
    if missing:
        raise ValueError(f"header lacks {missing}")
    return Program(instrs=decode_chunk(np.asarray(rec, dtype=np.int64)),
                   page_shift=int(header["page_shift"]),
                   protocol=header.get("protocol", "gc"),
                   phase=header["phase"],
                   worker=int(header.get("worker", 0)),
                   num_workers=int(header.get("num_workers", 1)),
                   vspace_slots=int(header["vspace_slots"]),
                   num_frames=int(header["num_frames"]),
                   prefetch_slots=int(header["prefetch_slots"]),
                   meta=dict(header["meta"]))


def ckks_context_from_keys(
        params: CkksParams, s_int: np.ndarray,
        evk: dict[int, Sequence[tuple[np.ndarray, np.ndarray]]],
        device: str | torch.device | None = None,
        rng: np.random.Generator | None = None) -> CkksContext:
    """The port's CKKS context holding another context's keys.

    ``s_int`` is the ternary secret (N,) int64; ``evk`` maps each level to
    its evaluation keys, one ``(b, a)`` pair per digit, each (level+2, N)
    over the level's primes and the special prime in the NTT domain (the
    JAX package's ``CkksContext.s_int`` and ``_evk[level][i].b / .a``).
    Encryptions draw from ``rng`` (a fresh ``default_rng(0xCEC5)`` if
    None)."""
    stacked = {}
    for lvl in range(1, params.levels + 1):
        pairs = evk[lvl]
        if len(pairs) != lvl + 1:
            raise ValueError(f"level {lvl} needs {lvl + 1} digit keys, got "
                             f"{len(pairs)}")
        b = np.stack([np.asarray(k[0]) for k in pairs]).astype(np.int64)
        a = np.stack([np.asarray(k[1]) for k in pairs]).astype(np.int64)
        if b.shape != (lvl + 1, lvl + 2, params.n_ring) or a.shape != b.shape:
            raise ValueError(f"level {lvl} keys have shapes {b.shape}, "
                             f"{a.shape}")
        stacked[lvl] = (b, a)
    return CkksContext(params, device=device, rng=rng,
                       keys=(np.asarray(s_int, dtype=np.int64), stacked))


def _tensor(x) -> torch.Tensor:
    """A NumPy array (or anything ``np.asarray`` takes) -> a CPU tensor of
    the same type, bit for bit.  NumPy has no bfloat16: the JAX package's
    bf16 arrays come out as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, so they cross as their uint16 bits."""
    a = np.array(x, order="C")       # a copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree: dict, prefix: str = ""):
    """(dotted path, leaf) of a nested dict of arrays, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _unstack(stacked: dict, index: tuple, prefix: str, out: dict) -> None:
    """One layer's leaves of a stacked parameter tree, at ``index`` of its
    leading axes, into ``out`` under ``prefix``."""
    for path, leaf in _leaves(stacked):
        out[prefix + path] = _tensor(np.asarray(leaf)[index])


def lm_params_from_jax(params: dict, cfg: ModelConfig) -> dict:
    """The JAX package's ``init_lm`` parameter tree (leaves as arrays) ->
    the port's ``LM`` state dict, bit for bit.  A scan group stacks its
    layers on a leading axis (``lm._stack_init``), a rep group each
    segment's on two, ``(n_rep, count)``; every layer goes to its block
    ``blocks.<i>`` in layer order (``models.lm.applications``), and the
    hybrid's one shared block to ``shared_attn``."""
    from .models.lm import applications, grouped_layout
    groups = grouped_layout(cfg)
    if len(params["groups"]) != len(groups):
        raise ValueError(f"{cfg.name}: the layout has {len(groups)} groups, "
                         f"the tree {len(params['groups'])}")
    out = {f"embed.{k}": _tensor(v) for k, v in params["embed"].items()}
    out["final_norm.scale"] = _tensor(params["final_norm"]["scale"])
    for app in applications(cfg):
        if app.block is None:
            continue
        tree = params["groups"][app.group]
        if app.seg is not None:
            tree = tree[app.seg]
        first = next(_leaves(tree))[1]
        if any(i >= n for i, n in zip(app.index, np.shape(first))):
            raise ValueError(f"{cfg.name}: group {app.group} stacks "
                             f"{np.shape(first)}, the layout reaches "
                             f"{app.index}")
        _unstack(tree, app.index, f"blocks.{app.block}.", out)
    if "shared_attn" in params:
        out.update({f"shared_attn.{k}": _tensor(v)
                    for k, v in _leaves(params["shared_attn"])})
    return out


def encdec_params_from_jax(params: dict, cfg: ModelConfig) -> dict:
    """The JAX package's ``init_encdec`` parameter tree -> the port's
    ``EncDec`` state dict, bit for bit: the stacked encoder and decoder
    layers to ``enc.<i>`` and ``dec.<i>``."""
    out = {f"embed.{k}": _tensor(v) for k, v in params["embed"].items()}
    for norm in ("enc_norm", "final_norm"):
        out[f"{norm}.scale"] = _tensor(params[norm]["scale"])
    for part, n in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
        for i in range(n):
            _unstack(params[part], (i,), f"{part}.{i}.", out)
    return out


def opt_state_from_jax(opt_state: dict, cfg: ModelConfig) -> dict:
    """The JAX package's ``init_opt_state`` / ``adamw_update`` state
    (``{"mu", "nu", "step"}``, leaves as arrays) -> the port's
    (``train.optimizer.init_opt_state``'s layout): each moment tree through
    the model's parameter carrier, bit for bit, and the int32 step."""
    conv = encdec_params_from_jax if cfg.is_encdec else lm_params_from_jax
    return {"mu": conv(opt_state["mu"], cfg),
            "nu": conv(opt_state["nu"], cfg),
            "step": _tensor(opt_state["step"]).to(torch.int32)}
