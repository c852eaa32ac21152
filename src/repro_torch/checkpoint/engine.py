"""Full-engine checkpoints: versioned manifest + arrays file — port of
``repro.checkpoint.engine``.

A checkpoint is two files written in order (``engine.py:1-20``):

    ep0000_step00000012.ckpt            -- every array leaf, via save_pytree
    ep0000_step00000012.manifest.json   -- skeleton + meta, written LAST

The manifest's skeleton describes the exact Python structure of the engine
state (dicts with int keys, lists, tuples, None, bools, arbitrary-precision
ints, exact-repr floats, strings), with each array leaf replaced by
``{"t": "arr", "key", "dtype", "shape", "jax", "scalar", "torch"}``
pointing into the arrays file; ``jax`` is always false here and ``torch``
marks tensor leaves.  The manifest is written last with tmp +
``os.replace``, so a crash mid-save leaves at most an orphaned ``.ckpt``
that :meth:`EngineCheckpointer.latest` never sees.

Restore is bit-for-bit: numpy leaves come back as numpy with their saved
dtype (the engine's float64 ``busy64`` clocks stay float64), tensor leaves
as CPU tensors (the engine moves them to its device), Python floats
exactly through JSON repr.

The port's manifests say ``"format": "drfl-engine-torch"``: their CNN
weights are in torch layout (OIHW convolutions, :mod:`repro_torch.
convert`), so the JAX package refuses them with its own ``ValueError``.
The port reads both its own and the JAX package's ``"drfl-engine"``
manifests; the JAX leaves (``"jax": true``) come back as numpy, for
:mod:`repro_torch.checkpoint.from_jax` to carry over.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import (ArraySpec, dtype_name, load_pytree,
                                       save_pytree)

MANIFEST_VERSION = 1
FORMAT = "drfl-engine-torch"
#: the JAX package's manifest format
JAX_FORMAT = "drfl-engine"
_NAME_RE = re.compile(r"ep(\d+)_step(\d+)\.manifest\.json$")

# FLConfig fields that describe how this process runs rather than what is
# computed: left out of the resume fingerprint (engine.py:40-44)
FINGERPRINT_EXCLUDE = ("checkpoint_dir", "checkpoint_every",
                       "checkpoint_keep", "resume", "log_every")


class CheckpointHalt(RuntimeError):
    """Raised by the engine right after a scheduled checkpoint save when a
    test or benchmark asked for a simulated crash (``halt_after_saves``)."""


def config_fingerprint(cfg: Any) -> str:
    """Stable hash of the semantic config (the reference's, so the same
    config hashes alike in both packages); a mismatch blocks resume."""
    d = dataclasses.asdict(cfg)
    for k in FINGERPRINT_EXCLUDE:
        d.pop(k, None)
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def rng_state(gen: Optional[np.random.Generator]) -> Optional[dict]:
    """JSON-able snapshot of a numpy Generator (arbitrary-precision ints).
    The twin of the reference's helper; the selectors, as the reference's
    do, read ``bit_generator.state`` themselves."""
    if gen is None:
        return None
    return gen.bit_generator.state


def set_rng_state(gen: np.random.Generator, state: dict) -> None:
    gen.bit_generator.state = state


# ----------------------------------------------------------------------
# skeleton encode / decode
# ----------------------------------------------------------------------

def encode_state(tree: Any) -> Tuple[dict, Dict[str, Any]]:
    """Split a state tree into a JSON-able skeleton and a flat dict of
    array leaves (numpy, or tensors still where they live: ``save_pytree``
    pulls them in one batch)."""
    arrays: Dict[str, Any] = {}

    def enc(x: Any) -> Any:
        if x is None:
            return {"t": "none"}
        # numpy scalars keep their dtype through the array path below;
        # np.float64 subclasses float, so it is screened out here
        if isinstance(x, bool) and not isinstance(x, np.generic):
            return {"t": "bool", "v": x}
        if isinstance(x, int) and not isinstance(x, np.generic):
            return {"t": "int", "v": x}
        if isinstance(x, float) and not isinstance(x, np.generic):
            return {"t": "float", "v": x}       # json repr round-trips
        if isinstance(x, str):
            return {"t": "str", "v": x}
        if isinstance(x, dict):
            for k in x:
                if not isinstance(k, (str, int)):
                    raise TypeError(f"unsupported dict key type {type(k)}")
            return {"t": "dict", "k": list(x.keys()),
                    "v": [enc(v) for v in x.values()]}
        if isinstance(x, tuple):
            return {"t": "tuple", "v": [enc(v) for v in x]}
        if isinstance(x, list):
            return {"t": "list", "v": [enc(v) for v in x]}
        if isinstance(x, torch.Tensor):
            key = f"a{len(arrays):06d}"
            arrays[key] = x.detach()
            return {"t": "arr", "key": key, "dtype": dtype_name(x),
                    "shape": list(x.shape), "jax": False, "scalar": False,
                    "torch": True}
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)
            key = f"a{len(arrays):06d}"
            arrays[key] = a
            return {"t": "arr", "key": key, "dtype": str(a.dtype),
                    "shape": list(a.shape), "jax": False,
                    "scalar": isinstance(x, np.generic)}
        raise TypeError(f"unsupported leaf type in engine state: {type(x)}")

    return enc(tree), arrays


def decode_state(skeleton: dict, arrays: Dict[str, Any]) -> Any:
    """The inverse of :func:`encode_state`: tensor leaves as CPU tensors,
    numpy (and JAX) leaves as numpy."""

    def dec(d: dict) -> Any:
        t = d["t"]
        if t == "none":
            return None
        if t in ("bool", "int", "float", "str"):
            return d["v"]
        if t == "dict":
            return {k: dec(v) for k, v in zip(d["k"], d["v"])}
        if t == "tuple":
            return tuple(dec(v) for v in d["v"])
        if t == "list":
            return [dec(v) for v in d["v"]]
        if t == "arr":
            a = arrays[d["key"]]
            if d.get("torch"):
                return torch.as_tensor(a).cpu()
            if d.get("scalar"):
                return a[()]
            return a
        raise ValueError(f"unknown skeleton tag {t!r}")

    return dec(skeleton)


def _collect_array_descs(skeleton: Any, out: Dict[str, dict]) -> None:
    if isinstance(skeleton, dict):
        if skeleton.get("t") == "arr":
            out[skeleton["key"]] = skeleton
            return
        for v in skeleton.values():
            _collect_array_descs(v, out)
    elif isinstance(skeleton, (list, tuple)):
        for v in skeleton:
            _collect_array_descs(v, out)


# ----------------------------------------------------------------------
# checkpointer
# ----------------------------------------------------------------------

class EngineCheckpointer:
    """Keep-last-k rotating full-engine checkpoints in one directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)

    def _stem(self, episode: int, step: int) -> str:
        return os.path.join(self.directory,
                            f"ep{episode:04d}_step{step:08d}")

    def save(self, state: Any, meta: Dict[str, Any]) -> str:
        episode = int(meta.get("episode", 0))
        step = int(meta["step"])
        stem = self._stem(episode, step)
        skeleton, arrays = encode_state(state)
        save_pytree(stem + ".ckpt", arrays)
        manifest = {"format": FORMAT, "version": MANIFEST_VERSION,
                    "meta": dict(meta),
                    "arrays_file": os.path.basename(stem) + ".ckpt",
                    "skeleton": skeleton}
        tmp = stem + ".manifest.json.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, stem + ".manifest.json")
        self._rotate()
        return stem + ".manifest.json"

    def _manifests(self) -> List[Tuple[Tuple[int, int], str]]:
        out = []
        if not os.path.isdir(self.directory):
            return out
        for name in os.listdir(self.directory):
            m = _NAME_RE.match(name)
            if m:
                out.append(((int(m.group(1)), int(m.group(2))),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def latest(self) -> Optional[str]:
        ms = self._manifests()
        return ms[-1][1] if ms else None

    def _rotate(self) -> None:
        ms = self._manifests()
        for _, path in ms[:-self.keep]:
            ckpt = path[:-len(".manifest.json")] + ".ckpt"
            for p in (path, ckpt):
                try:
                    os.remove(p)
                except OSError:
                    pass

    def load(self, path: Optional[str] = None) -> Tuple[Any, Dict[str, Any]]:
        """(state, meta) of ``path`` (default: the latest manifest); the
        returned meta also names the manifest's ``format``, this port's
        :data:`FORMAT` or the JAX package's :data:`JAX_FORMAT`."""
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError(
                f"no engine checkpoint found in {self.directory!r}")
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("format") not in (FORMAT, JAX_FORMAT):
            raise ValueError(f"{path!r} is not an engine checkpoint manifest")
        if manifest.get("version") != MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {manifest.get('version')} unsupported "
                f"(this build reads version {MANIFEST_VERSION})")
        descs: Dict[str, dict] = {}
        _collect_array_descs(manifest["skeleton"], descs)
        template = {k: ArraySpec(tuple(d["shape"]), d["dtype"])
                    for k, d in descs.items()}
        arrays_path = os.path.join(os.path.dirname(path),
                                   manifest["arrays_file"])
        arrays = load_pytree(arrays_path, template)
        state = decode_state(manifest["skeleton"], arrays)
        return state, dict(manifest["meta"], format=manifest["format"])
