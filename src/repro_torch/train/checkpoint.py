"""Fault-tolerant checkpointing, atomic and async-capable: the port's copy
of ``repro.train.checkpoint``, in the reference's on-disk format.

One directory per save, ``step_%010d/``: ``params.npz`` (the model's state
dict, its names as keys), ``opt.npz`` (``mu/<name>``, ``nu/<name>`` and
``step``) and ``manifest.json`` (step, meta, ``"complete": true``).  bf16
leaves are stored as their uint16 bits under the key + ``__bf16`` (npz
cannot hold bfloat16).  Writes go to a ``.tmp_`` directory that is renamed
into place, so a crash mid-save never corrupts the newest checkpoint;
``latest_step`` skips incomplete or corrupt manifests; the newest ``keep``
saves are kept.  A restore writes into the model and optimizer state it is
given, in place (``device=`` moves them first), so a rollback leaves them
exactly as the checkpoint holds them.  Elastic resharding: ``restore(...,
shardings=(param shardings, opt shardings))`` loads each array as a
DTensor on its ``distributed.sharding.NamedSharding`` (a checkpoint saved
on one mesh reloads onto any other); a DTensor is saved whole
(``full_tensor``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..distributed.sharding import distribute
from ..kernels import resolve_device

def _flat(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A model (its state dict) or a nested dict of tensors -> tensors by
    '/'-joined key."""
    if isinstance(tree, nn.Module):
        return {prefix + k: v for k, v in tree.state_dict().items()}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _to_numpy(flat: dict) -> dict[str, np.ndarray]:
    """Tensors by key -> npz arrays by key (bf16 as bits); arrays of a
    snapshot pass as they are."""
    out = {}
    for key, t in flat.items():
        if isinstance(t, np.ndarray):
            out[key] = t
            continue
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            out[key + "__bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out


def _snapshot(tree) -> dict[str, np.ndarray]:
    """Host copies of every leaf: never the live tensors (``Tensor.cpu``
    returns a CPU tensor itself, which the next in-place step would
    change under the writer)."""
    return _to_numpy({k: (t.detach().full_tensor() if isinstance(t, DTensor)
                          else t.detach()).to("cpu", copy=True)
                      for k, t in _flat(tree).items()})


def save(ckpt_dir: str, step: int, params, opt_state,
         meta: dict | None = None, keep: int = 3) -> str:
    """Write one checkpoint of ``params`` (a model) and ``opt_state``, or
    of their snapshots (``save_async``); returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        for name, tree in (("params", params), ("opt", opt_state)):
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     **_to_numpy(_flat(tree)))
        manifest = {"step": int(step), "meta": meta or {}, "complete": True}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{int(step):010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, params, opt_state,
               meta: dict | None = None) -> threading.Thread:
    """Snapshot to host memory synchronously (copies), write on a
    thread."""
    t = threading.Thread(target=save,
                         args=(ckpt_dir, step, _snapshot(params),
                               _snapshot(opt_state), meta), daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in sorted(os.listdir(ckpt_dir)):
        if not d.startswith("step_"):
            continue
        mf = os.path.join(ckpt_dir, d, "manifest.json")
        try:
            with open(mf) as f:
                if json.load(f).get("complete"):
                    best = int(d.split("_")[1])
        except (OSError, json.JSONDecodeError):
            continue  # incomplete/corrupt save: skip (crash tolerance)
    return best


def _leaf(data, key: str) -> torch.Tensor:
    if key + "__bf16" in data:
        bits = np.array(data[key + "__bf16"])
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(data[key]))


def _load_sharded(npz_path: str, tree, shardings) -> None:
    """Every leaf of ``tree`` with a sharding in ``shardings`` (same
    keys) replaced by a DTensor of the npz's array on it: a model's
    parameters re-registered (``requires_grad`` kept), a dict's entries
    set; leaves without one loaded in place."""
    with np.load(npz_path) as data:
        if isinstance(tree, nn.Module):
            with torch.no_grad():
                for key, t in tree.state_dict(keep_vars=True).items():
                    sh = shardings.get(key)
                    if sh is None:
                        t.copy_(_leaf(data, key))
                        continue
                    mod, _, attr = key.rpartition(".")
                    owner = tree.get_submodule(mod) if mod else tree
                    arr = _leaf(data, key).to(sh.mesh.device_type)
                    owner.register_parameter(attr, nn.Parameter(
                        distribute(arr, sh), requires_grad=t.requires_grad))
            return

        def walk(d: dict, sh: dict, prefix: str) -> None:
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, (sh or {}).get(k) or {}, f"{prefix}{k}/")
                    continue
                arr = _leaf(data, prefix + k)
                s = (sh or {}).get(k)
                if s is None:
                    v.copy_(arr)
                else:
                    d[k] = distribute(arr.to(s.mesh.device_type), s)
        walk(tree, shardings, "")


def _load_into(npz_path: str, tree, device) -> None:
    """Every leaf of ``tree`` (a model or a nested dict of tensors) from
    the npz, written in place; a dict's leaves are replaced by tensors on
    ``device`` where that is not their device."""
    with np.load(npz_path) as data:
        if isinstance(tree, nn.Module):
            if device is not None:
                tree.to(resolve_device(device))
            with torch.no_grad():
                for key, t in tree.state_dict(keep_vars=True).items():
                    t.copy_(_leaf(data, key))
            return

        def walk(d: dict, prefix: str) -> None:
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                    continue
                arr = _leaf(data, prefix + k)
                dev = v.device if device is None else resolve_device(device)
                if dev == v.device:
                    v.copy_(arr)
                else:
                    d[k] = arr.to(dev)
        walk(tree, "")


def restore(ckpt_dir: str, step: int, params_like, opt_like,
            device: str | torch.device | None = None, shardings=None):
    """Load step ``step`` into ``params_like`` (a model) and ``opt_like``
    in place, on ``device`` if given (else where they are).
    ``shardings`` = (param shardings, opt shardings), each
    ``{name: NamedSharding}`` (the opt's ``{"mu": {...}, "nu": {...}}``)
    or None: the leaves named load as DTensors on them (elastic reload
    onto another mesh).  Returns (params, opt, manifest)."""
    d = os.path.join(ckpt_dir, f"step_{int(step):010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    p_sh, o_sh = shardings if shardings is not None else (None, None)
    for name, tree, sh in (("params", params_like, p_sh),
                           ("opt", opt_like, o_sh)):
        path = os.path.join(d, f"{name}.npz")
        if sh is None:
            _load_into(path, tree, device)
        else:
            _load_sharded(path, tree, sh)
    return params_like, opt_like, manifest
