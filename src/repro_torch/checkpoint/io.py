"""Pytree checkpoints in the JAX package's on-disk format — port of
``repro.checkpoint.io``.

Format (``io.py:1-8``): a compressed MessagePack map
    {"__meta__": {"version": 1}, "<leaf path>": {"dtype","shape","data"}}
whose leaf paths are the ``jax.tree_util`` key paths joined by ``/`` (dict
keys sorted, list and tuple items by index).  This port writes zlib at
level 6, the reference's fallback codec, through its own MessagePack
codec (:mod:`._msgpack`, equal to ``msgpack.packb(use_bin_type=True)``
byte for byte), so the files load in either package on either machine.
It reads zlib always, and zstd frames where ``zstandard`` can be
imported (else the reference's ``RuntimeError``).

Leaves are numpy arrays and scalars, or torch tensors on any device: the
tensors reach the host in ONE batched pull (:func:`repro_torch.device.
to_host`).  A bfloat16 tensor is written with the reference's dtype string
``"bfloat16"`` and its raw 2-byte data, and read back as a bfloat16
tensor (numpy has no such dtype without ``ml_dtypes``).
"""
from __future__ import annotations

import dataclasses
import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import to_host

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
BF16 = "bfloat16"

# Leaf paths a FleetState checkpoint carries, in pytree order: the
# reference's tuple (io.py:31-35), which must stay set-equal to the port's
# FleetState tensor fields (its dataclass fields less ``tiers``/``modes``)
FLEET_CHECKPOINT_FIELDS = ("compute", "p_train", "p_com", "bandwidth",
                           "battery", "remaining", "data_size",
                           "mode_compute", "mode_power", "alive",
                           "busy_until", "charge_rate", "tz_phase")


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A template leaf without data: the shape and dtype name a loaded
    leaf must have."""
    shape: Tuple[int, ...]
    dtype: str


def dtype_name(leaf) -> str:
    """The reference's dtype string of a numpy or torch leaf (numpy's
    name: ``float32``, ``bool``, ``int64``, ... and ``bfloat16``)."""
    if isinstance(leaf, ArraySpec):
        return leaf.dtype
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _compress(raw: bytes) -> bytes:
    return zlib.compress(raw, 6)


def _decompress(blob: bytes) -> bytes:
    # sniff the frame magic: the reference writes zstd where it can
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard package is not installed") from None
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _flatten_with_path(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) in ``jax.tree_util`` order: dicts by sorted key,
    lists and tuples by index; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in _flatten_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def _path_str(kp) -> str:
    return "/".join(str(k) for k in kp)


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        return next(it)
    return build(tree)


def _host_arrays(leaves) -> List[Tuple[str, np.ndarray]]:
    """(dtype name, host numpy array) per leaf; the torch leaves come over
    in one batched pull, a bfloat16 one as its raw int16 bits."""
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    pulled = iter(to_host(*[
        t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        for t in tensors]) if tensors else [])
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append((dtype_name(leaf), next(pulled)))
        else:
            a = np.asarray(leaf)
            out.append((str(a.dtype), a))
    return out


def save_pytree(path: str, tree: Any, step: Optional[int] = None) -> str:
    if step is not None:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"step_{step:08d}.ckpt")
    payload: Dict[str, Any] = {"__meta__": {"version": 1}}
    flat = _flatten_with_path(tree)
    keys, seen = [], set(payload)
    for kp, _ in flat:
        key = _path_str(kp)
        if key in seen:
            raise ValueError(f"duplicate leaf path {key!r}: two pytree "
                             "leaves flatten to the same checkpoint key")
        seen.add(key)
        keys.append(key)
    for key, (dt, arr) in zip(keys, _host_arrays([l for _, l in flat])):
        payload[key] = {"dtype": dt, "shape": list(arr.shape),
                        "data": np.ascontiguousarray(arr).tobytes()}
    raw = _msgpack.packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_compress(raw))
    os.replace(tmp, path)
    return path


def read_payload(path: str) -> dict:
    """Decompress and unpack a checkpoint file into its raw payload map;
    ``ValueError`` on truncated or corrupt files (the codec's error
    chained), the ``RuntimeError`` of a zstd file without ``zstandard``
    as it is."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        payload = _msgpack.unpackb(_decompress(blob))
    except RuntimeError:
        raise
    except Exception as e:
        raise ValueError(f"corrupt or truncated checkpoint {path!r}: "
                         f"{type(e).__name__}: {e}") from e
    if not isinstance(payload, dict) or "__meta__" not in payload:
        raise ValueError(f"corrupt checkpoint {path!r}: missing __meta__")
    return payload


def _record_array(rec: dict):
    """A payload record as a writable numpy array (a bfloat16 one as a
    CPU bfloat16 tensor)."""
    shape = tuple(rec["shape"])
    if rec["dtype"] == BF16:
        a = np.frombuffer(rec["data"], np.int16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    return np.frombuffer(rec["data"], np.dtype(rec["dtype"])).reshape(
        shape).copy()


def load_pytree(path: str, template: Any) -> Any:
    """The leaves of ``template``'s paths, validated against its leaves'
    shapes and dtypes (numpy arrays, tensors or :class:`ArraySpec`), as
    numpy arrays (a bfloat16 leaf as a CPU bfloat16 tensor)."""
    payload = read_payload(path)
    out = []
    for kp, tl in _flatten_with_path(template):
        key = _path_str(kp)
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _record_array(payload[key])
        want_shape = tuple(tl.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"shape mismatch at {key}: ckpt "
                             f"{tuple(arr.shape)} vs template {want_shape}")
        got, want = payload[key]["dtype"], dtype_name(tl)
        if got != want:
            raise ValueError(f"dtype mismatch at {key}: ckpt {got} vs "
                             f"template {want}")
        out.append(arr)
    return _unflatten(template, out)


def latest_step(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)\.ckpt$", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, name), int(m.group(1))
    return best
