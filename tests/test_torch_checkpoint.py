"""The port's checkpoint substrate (``repro_torch.checkpoint``), the mirror
of ``tests/test_checkpoint.py`` plus the format's ties to the JAX package.

The io layer: every dtype round-trips, a dtype mismatch, a duplicate leaf
path, truncated or garbage files and a payload without ``__meta__`` raise,
``latest_step`` skips tmp and foreign files, the port writes zlib and
reads it always, a zstd frame without ``zstandard`` raises the
reference's ``RuntimeError``.  The engine manifests: the exact skeleton
round trip (torch leaves and a ``torch.Generator`` state included),
keep-last-k rotation, an orphaned arrays file, the version gate, the RNG
snapshots, the config fingerprint.  Then the format itself: the port's
MessagePack codec writes ``msgpack.packb(use_bin_type=True)``'s bytes and
reads msgpack's; ``repro_torch.checkpoint`` imports with ``jax``,
``msgpack`` and ``zstandard`` absent; ``FLEET_CHECKPOINT_FIELDS`` covers
the port's ``FleetState``; the selectors' ``state_dict`` round trips
continue their decisions bit for bit; a JAX-written checkpoint loads in
the port and a port-written arrays file in the JAX package, which refuses
the port's manifests; both packages fingerprint a config alike.  jax and
msgpack are imported only by the tests that need them.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (FLEET_CHECKPOINT_FIELDS,
                                    EngineCheckpointer, config_fingerprint,
                                    decode_state, encode_state, latest_step,
                                    load_pytree, read_payload, rng_state,
                                    save_pytree, set_rng_state)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fleet import FleetState, make_fleet_state
from repro_torch.device import set_torch_rng_state, torch_rng_state
from repro_torch.core.selection import (GreedySelector, MarlSelector,
                                        RandomSelector, StaticTierSelector)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("bool", "int32", "int64", "float32", "float64")


def _random_array(dt, seed):
    rng = np.random.default_rng(seed)
    if dt == "bool":
        return rng.integers(0, 2, size=(3, 4)).astype(bool)
    if dt.startswith("int"):
        return rng.integers(-1000, 1000, size=(3, 4)).astype(dt)
    return rng.standard_normal((3, 4)).astype(dt)


# ----------------------------------------------------------------------
# io layer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 16])
@pytest.mark.parametrize("dt", DTYPES)
def test_save_load_round_trips_every_dtype(tmp_path, dt, seed):
    arr = _random_array(dt, seed)
    p = save_pytree(str(tmp_path / "x.ckpt"),
                    {"a": arr, "t": torch.from_numpy(arr.copy())})
    out = load_pytree(p, {"a": np.zeros_like(arr),
                          "t": torch.zeros(arr.shape, dtype=torch.from_numpy(
                              arr).dtype)})
    for got in (out["a"], out["t"]):
        assert isinstance(got, np.ndarray) and got.dtype == arr.dtype
        assert got.tobytes() == arr.tobytes()
        got[...] = 0                 # returned arrays must be writable
    back = torch.from_numpy(load_pytree(p, {"t": np.zeros_like(arr)})["t"])
    assert back.numpy().tobytes() == arr.tobytes()


def test_bfloat16_leaf_keeps_its_dtype_and_bits(tmp_path):
    t = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    p = save_pytree(str(tmp_path / "x.ckpt"), {"w": t})
    rec = read_payload(p)["w"]
    assert rec["dtype"] == "bfloat16" and len(rec["data"]) == 2 * t.numel()
    back = load_pytree(p, {"w": torch.zeros_like(t)})["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_dtype_mismatch_raises(tmp_path):
    p = save_pytree(str(tmp_path / "x.ckpt"),
                    {"a": np.ones((2, 2), np.float32)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_pytree(p, {"a": np.ones((2, 2), np.int32)})


def test_duplicate_leaf_path_raises(tmp_path):
    tree = {"a": {"b": np.ones(2)}, "a/b": np.zeros(2)}
    with pytest.raises(ValueError, match="duplicate leaf path"):
        save_pytree(str(tmp_path / "x.ckpt"), tree)


def test_truncated_and_garbage_files_raise_valueerror(tmp_path):
    p = save_pytree(str(tmp_path / "x.ckpt"), {"a": np.arange(100.0)})
    blob = open(p, "rb").read()
    trunc = tmp_path / "trunc.ckpt"
    trunc.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        read_payload(str(trunc))
    garbage = tmp_path / "garbage.ckpt"
    garbage.write_bytes(b"\x00\x01definitely not a checkpoint")
    with pytest.raises(ValueError, match="corrupt or truncated"):
        read_payload(str(garbage))
    # a whole zlib frame around a cut MessagePack map
    cut = tmp_path / "cut.ckpt"
    raw = _msgpack.packb({"__meta__": {"version": 1}, "a": b"x" * 64})
    cut.write_bytes(zlib.compress(raw[:-10]))
    with pytest.raises(ValueError, match="corrupt or truncated"):
        read_payload(str(cut))


def test_payload_without_meta_raises(tmp_path):
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(zlib.compress(_msgpack.packb({"a": 1})))
    with pytest.raises(ValueError, match="missing __meta__"):
        read_payload(str(bad))


def test_latest_step_ignores_tmp_and_foreign_files(tmp_path):
    d = tmp_path / "ck"
    p = save_pytree(str(d), {"a": np.ones(2)}, step=3)
    (d / "step_00000009.ckpt.tmp").write_bytes(b"partial")
    (d / "notes.txt").write_text("hi")
    assert latest_step(str(d)) == p
    assert latest_step(str(tmp_path / "absent")) is None


def test_zlib_always_written_and_loaded(tmp_path):
    arr = np.arange(6.0).reshape(2, 3)
    p = save_pytree(str(tmp_path / "z.ckpt"), {"a": arr})
    blob = open(p, "rb").read()
    assert blob[:4] != ckpt_io._ZSTD_MAGIC
    zlib.decompress(blob)                       # a plain zlib stream
    out = load_pytree(p, {"a": np.zeros_like(arr)})
    assert out["a"].tobytes() == arr.tobytes()


def test_zstd_frame_without_library_raises_runtimeerror(tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    p = tmp_path / "z.ckpt"
    p.write_bytes(ckpt_io._ZSTD_MAGIC + b"\x00" * 16)
    with pytest.raises(RuntimeError, match="zstandard"):
        read_payload(str(p))


def test_zstd_frame_loads_where_zstandard_exists(tmp_path):
    zstd = pytest.importorskip("zstandard")
    arr = np.arange(6.0)
    raw = _msgpack.packb({"__meta__": {"version": 1}, "a": {
        "dtype": "float64", "shape": [6], "data": arr.tobytes()}})
    p = tmp_path / "z.ckpt"
    p.write_bytes(zstd.ZstdCompressor(level=3).compress(raw))
    out = load_pytree(str(p), {"a": np.zeros_like(arr)})
    assert out["a"].tobytes() == arr.tobytes()


# ----------------------------------------------------------------------
# engine manifest codec
# ----------------------------------------------------------------------

def _gnarly_state():
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    return {
        "none": None,
        "flags": (True, False),
        "big_int": 2 ** 80 + 3,
        "exact_float": 0.1 + 0.2,
        "label": "ep0",
        "int_keys": {0: "a", 7: {"nested": [1, 2.5, None]}},
        "np_scalar": np.float64(1.0 / 3.0),
        "np_f64": np.linspace(0, 1, 7),
        "np_bool": np.array([True, False, True]),
        "tensor": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "tensor_i32": torch.tensor([3, -4], dtype=torch.int32),
        "gen": torch_rng_state(gen),
        "heap": [(0.5, 1, "done", 0), (0.75, 2, "fault", {"kind": "crash"})],
    }


def test_skeleton_roundtrip_is_exact(tmp_path):
    state = _gnarly_state()
    ck = EngineCheckpointer(str(tmp_path))
    ck.save(state, {"episode": 0, "step": 1})
    out, meta = ck.load()
    assert meta["format"] == "drfl-engine-torch"
    skeleton, _ = encode_state(state)
    json.dumps(skeleton)                          # JSON-able
    assert out["none"] is None
    assert out["flags"] == (True, False) and isinstance(out["flags"], tuple)
    assert out["big_int"] == 2 ** 80 + 3
    assert out["exact_float"] == 0.1 + 0.2
    assert out["int_keys"][7]["nested"] == [1, 2.5, None]
    assert isinstance(out["np_scalar"], np.float64)
    assert out["np_scalar"] == np.float64(1.0 / 3.0)
    assert out["np_f64"].dtype == np.float64
    assert out["np_f64"].tobytes() == state["np_f64"].tobytes()
    assert out["np_bool"].dtype == bool
    for k in ("tensor", "tensor_i32"):
        assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu"
        assert out[k].dtype == state[k].dtype and torch.equal(out[k], state[k])
    assert out["heap"][0] == (0.5, 1, "done", 0)
    assert out["heap"][1][3] == {"kind": "crash"}
    # the generator continues its stream after the round trip
    gen = torch.Generator()
    set_torch_rng_state(gen, out["gen"])
    want = torch.Generator()
    want.set_state(state["gen"]["state"])
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=want))
    skel, arrays = encode_state(state)
    again = decode_state(skel, arrays)
    assert torch.equal(again["tensor"], state["tensor"])


def test_generator_state_refuses_another_device_type():
    gen = torch.Generator()
    state = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    with pytest.raises(ValueError, match="'cuda' device"):
        set_torch_rng_state(gen, state)


def test_engine_checkpointer_save_load_rotate(tmp_path):
    ck = EngineCheckpointer(str(tmp_path), keep=2)
    for step in (2, 4, 6):
        ck.save({"step": step, "arr": np.full(3, float(step))},
                {"episode": 0, "step": step})
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.endswith(".manifest.json")] == [
        "ep0000_step00000004.manifest.json",
        "ep0000_step00000006.manifest.json"]
    assert [n for n in names if n.endswith(".ckpt")] == [
        "ep0000_step00000004.ckpt", "ep0000_step00000006.ckpt"]
    state, meta = ck.load()
    assert meta["step"] == 6 and state["step"] == 6
    assert state["arr"].tolist() == [6.0, 6.0, 6.0]


def test_orphaned_arrays_file_is_invisible(tmp_path):
    ck = EngineCheckpointer(str(tmp_path), keep=3)
    good = ck.save({"x": 1}, {"episode": 0, "step": 1})
    (tmp_path / "ep0000_step00000002.ckpt").write_bytes(b"partial")
    assert ck.latest() == good
    _, meta = ck.load()
    assert meta["step"] == 1


def test_manifest_version_gate(tmp_path):
    ck = EngineCheckpointer(str(tmp_path))
    path = ck.save({"x": 1}, {"episode": 0, "step": 1})
    manifest = json.load(open(path))
    manifest["version"] = 999
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError, match="version 999"):
        ck.load(path)
    manifest.update(version=1, format="something-else")
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError, match="not an engine checkpoint"):
        ck.load(path)


def test_rng_state_roundtrip():
    gen = np.random.default_rng(42)
    gen.standard_normal(5)
    snap = rng_state(gen)
    want = gen.standard_normal(8)
    fresh = np.random.default_rng(0)
    set_rng_state(fresh, snap)
    assert np.array_equal(fresh.standard_normal(8), want)
    assert rng_state(None) is None


def test_config_fingerprint_ignores_process_knobs(tmp_path):
    from repro_torch.fl import FLConfig
    a = FLConfig(seed=3)
    b = FLConfig(seed=3, checkpoint_dir=str(tmp_path), checkpoint_every=5,
                 checkpoint_keep=7, resume=True)
    c = FLConfig(seed=4)
    assert config_fingerprint(a) == config_fingerprint(b)
    assert config_fingerprint(a) != config_fingerprint(c)


# ----------------------------------------------------------------------
# the format: MessagePack, imports, fleet fields
# ----------------------------------------------------------------------

def _payload(rng: random.Random, depth=0):
    """A seeded nest of every covered type, small enough to pack fast."""
    kind = rng.randrange(9 if depth < 3 else 6)
    if kind == 0:
        return None
    if kind == 1:
        return rng.random() < 0.5
    if kind == 2:
        bits = rng.choice([4, 5, 7, 8, 15, 16, 31, 32, 63, 64])
        v = rng.randrange(2 ** bits) * rng.choice([1, -1])
        return max(min(v, 2 ** 64 - 1), -2 ** 63)
    if kind == 3:
        return rng.uniform(-1e10, 1e10)
    if kind == 4:
        return "é" * rng.choice([0, 1, 15, 16, 127, 128])
    if kind == 5:
        return bytes(rng.randrange(256)
                     for _ in range(rng.choice([0, 1, 255, 256])))
    n = rng.choice([0, 1, 15, 16, 17])
    if kind == 6:
        return [_payload(rng, depth + 1) for _ in range(n)]
    if kind == 7:
        return tuple(_payload(rng, depth + 1) for _ in range(n))
    return {f"k{i}": _payload(rng, depth + 1) for i in range(n)}


#: every length boundary of str, bin, array and map (8/16/32-bit heads)
BOUNDARIES = ([s * "a" for s in (31, 32, 255, 256, 65535, 65536)]
              + [s * b"b" for s in (255, 256, 65535, 65536)]
              + [[None] * s for s in (15, 16, 65535, 65536)]
              + [{str(i): i for i in range(s)} for s in (15, 16, 65536)]
              + [0, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16, 2 ** 32 - 1,
                 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15,
                 -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1, -2 ** 63])


@pytest.mark.parametrize("seed", range(4))
def test_packb_equals_msgpack_byte_for_byte(seed):
    msgpack = pytest.importorskip("msgpack")
    rng = random.Random(seed)
    payloads = [_payload(rng) for _ in range(40)]
    # and the reference's own arrays-file payload
    arr = np.random.default_rng(seed).standard_normal((33, 7))
    payloads.append({"__meta__": {"version": 1}, **{
        f"a{i:06d}": {"dtype": "float32", "shape": [33, 7],
                      "data": arr.astype(np.float32).tobytes()}
        for i in range(20)}})
    if seed == 0:
        payloads += BOUNDARIES
    for obj in payloads:
        assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("seed", range(4))
def test_unpackb_reads_msgpacks_bytes(seed):
    msgpack = pytest.importorskip("msgpack")
    rng = random.Random(100 + seed)
    objs = [_payload(rng) for _ in range(40)]
    for obj in objs + (BOUNDARIES if seed == 0 else []):
        raw = msgpack.packb(obj, use_bin_type=True)
        assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)
    single = msgpack.packb(1.5, use_single_float=True)
    assert _msgpack.unpackb(single) == 1.5
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


def test_checkpoint_imports_without_jax_msgpack_or_zstandard():
    code = (
        "import sys\n"
        "for m in ('jax', 'msgpack', 'zstandard'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.from_jax\n"
        "import numpy as np, os, tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "ck = repro_torch.checkpoint.EngineCheckpointer(d)\n"
        "ck.save({'a': np.arange(3.0)}, {'episode': 0, 'step': 1})\n"
        "s, _ = ck.load()\n"
        "assert s['a'].tolist() == [0.0, 1.0, 2.0]\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'msgpack',"
        " 'zstandard', 'repro.')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=""),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_fleet_checkpoint_fields_cover_the_fleet_state():
    fields = {f.name for f in dataclasses.fields(FleetState)}
    assert set(FLEET_CHECKPOINT_FIELDS) == fields - {"tiers", "modes"}
    assert len(FLEET_CHECKPOINT_FIELDS) == len(set(FLEET_CHECKPOINT_FIELDS))


# ----------------------------------------------------------------------
# selectors
# ----------------------------------------------------------------------

SIZES, FRACS = (2.8e6, 8.4e6, 22.5e6, 44.8e6), (0.11, 0.3, 0.72, 1.0)


def _make(kind):
    if kind == "marl":
        return MarlSelector(10, 4, 6, seed=2, device="cpu")
    if kind == "marl-set":
        return MarlSelector(10, 4, 6, seed=2, state_mode="factored",
                            mixer_mode="set", agent_budget=4, device="cpu")
    return {"random": lambda: RandomSelector(2),
            "static": lambda: StaticTierSelector(2),
            "greedy": GreedySelector}[kind]()


def _decisions(sel, fleet, rounds):
    out = []
    for t in rounds:
        s = sel.select(fleet, t, 4, SIZES, FRACS, local_epochs=1)
        sel.observe_reward(0.25 * t)
        out.append((s.participants, s.model_choice))
    return out


@pytest.mark.parametrize("kind",
                         ["marl", "marl-set", "random", "static", "greedy"])
def test_selector_state_dict_round_trips(tmp_path, kind):
    """A selector saved mid-episode and restored into a fresh one of the
    same config decides as the original goes on deciding."""
    fleet = make_fleet_state(10, seed=1, device="cpu")
    sel = _make(kind)
    _decisions(sel, fleet, range(3))
    ck = EngineCheckpointer(str(tmp_path))
    ck.save(sel.state_dict(), {"episode": 0, "step": 3})
    state, _ = ck.load()
    fresh = _make(kind)
    fresh.load_state_dict(state)
    assert _decisions(fresh, fleet, range(3, 6)) == \
        _decisions(sel, fleet, range(3, 6))
    if kind.startswith("marl"):
        assert np.array_equal(fresh.ep_actions[-1], sel.ep_actions[-1])
        assert torch.equal(fresh.hidden, sel.hidden)
        assert fresh.total_rounds == sel.total_rounds == 6
        assert (fresh._ep_idx is None) == (kind == "marl")
        if fresh._ep_idx is not None:
            assert np.array_equal(fresh._ep_idx, sel._ep_idx)
        other = _make("random")
        with pytest.raises(ValueError, match="marl"):
            other.load_state_dict(state)
    else:
        with pytest.raises(ValueError):
            _make("marl").load_state_dict(state)


def test_learner_state_dict_round_trips_an_update(tmp_path):
    sel = _make("marl")
    fleet = make_fleet_state(10, seed=1, device="cpu")
    _decisions(sel, fleet, range(6))
    obs, state, actions, rewards = sel.episode_arrays(fleet, 6)
    batch = {"obs": obs[None], "state": state[None], "actions":
             actions[None], "rewards": rewards[None],
             "mask": np.ones((1, len(rewards)), np.float32)}
    sel.learner.update(batch)
    ck = EngineCheckpointer(str(tmp_path))
    ck.save(sel.learner.state_dict(), {"episode": 0, "step": 1})
    fresh = _make("marl").learner
    fresh.load_state_dict(ck.load()[0])
    assert fresh.opt["step"] == sel.learner.opt["step"] == 1
    a, b = sel.learner.update(batch), fresh.update(batch)
    assert a == b
    from repro_torch.tree import tree_leaves
    for x, y in zip(tree_leaves(fresh.params),
                    tree_leaves(sel.learner.params)):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------
# the format across packages
# ----------------------------------------------------------------------

def test_jax_written_checkpoint_loads_in_the_port(tmp_path):
    import jax.numpy as jnp
    from repro.checkpoint import EngineCheckpointer as JaxCheckpointer
    state = {"int_keys": {0: "a", 3: [1, 2.5, None]}, "big": 2 ** 70,
             "np_f64": np.linspace(0, 1, 5), "np_i8": np.int64(7),
             "jax_arr": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "jax_bool": jnp.array([True, False]),
             "rng": np.random.default_rng(3).bit_generator.state}
    path = JaxCheckpointer(str(tmp_path)).save(state, {"episode": 1,
                                                       "step": 4})
    ours, meta = EngineCheckpointer(str(tmp_path)).load(path)
    theirs, jmeta = JaxCheckpointer(str(tmp_path)).load(path)
    assert meta["format"] == "drfl-engine"
    assert {k: v for k, v in meta.items() if k != "format"} == jmeta
    assert ours["int_keys"] == theirs["int_keys"] and ours["big"] == 2 ** 70
    assert ours["rng"] == theirs["rng"]
    assert isinstance(ours["np_i8"], np.int64) and ours["np_i8"] == 7
    for k in ("np_f64", "jax_arr", "jax_bool"):
        a, b = ours[k], np.asarray(theirs[k])
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    # the whole decoded structure: the same keys, containers and values,
    # JAX arrays as numpy with their dtypes and bytes
    def canon(x):
        if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "dtype"):
            a = np.asarray(x)
            return ("arr", str(a.dtype), a.shape, a.tobytes())
        if isinstance(x, dict):
            return ("dict", [(k, canon(v)) for k, v in x.items()])
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, [canon(v) for v in x])
        return x
    assert canon(ours) == canon(theirs)
    skeleton = json.load(open(path))["skeleton"]
    assert encode_state(ours)[0]["k"] == skeleton["k"]


def test_port_arrays_file_loads_in_the_reference(tmp_path):
    import jax.numpy as jnp
    from repro.checkpoint import load_pytree as jax_load
    from repro.checkpoint import read_payload as jax_read
    tree = {"w": torch.randn((4, 3), generator=torch.Generator()
                             .manual_seed(1)),
            "b": [np.arange(3, dtype=np.int32), np.array([True, False])],
            "h": torch.randn(5).to(torch.bfloat16),
            "s": {"x": np.float64(2.5)}}
    p = save_pytree(str(tmp_path / "x.ckpt"), tree)
    payload = jax_read(p)
    assert payload["__meta__"] == {"version": 1}
    assert list(payload) == ["__meta__", "b/0", "b/1", "h", "s/x", "w"]
    tmpl = {"w": jnp.zeros((4, 3), jnp.float32),
            "b": [np.zeros(3, np.int32), np.zeros(2, bool)],
            "h": jnp.zeros(5, jnp.bfloat16), "s": {"x": np.float64(0)}}
    out = jax_load(p, tmpl, backend="numpy")
    assert out["w"].tobytes() == tree["w"].numpy().tobytes()
    assert out["b"][0].tobytes() == tree["b"][0].tobytes()
    assert out["b"][1].tolist() == [True, False]
    assert out["h"].tobytes() == tree["h"].view(torch.int16).numpy().tobytes()
    assert out["s"]["x"] == 2.5


def test_reference_refuses_a_port_manifest(tmp_path):
    from repro.checkpoint import EngineCheckpointer as JaxCheckpointer
    path = EngineCheckpointer(str(tmp_path)).save(
        {"w": torch.ones(2)}, {"episode": 0, "step": 1})
    with pytest.raises(ValueError, match="not an engine checkpoint"):
        JaxCheckpointer(str(tmp_path)).load(path)


@pytest.mark.parametrize("kw", [dict(), dict(seed=3, engine_mode="async"),
                                dict(reward_weights=(1.0, 2.0, 3.0),
                                     checkpoint_dir="x", resume=True)])
def test_config_fingerprint_equal_in_both_packages(kw):
    from repro.checkpoint import config_fingerprint as jax_fingerprint
    from repro.fl.simulation import FLConfig as JaxFLConfig
    from repro_torch.fl import FLConfig
    assert config_fingerprint(FLConfig(**kw)) == \
        jax_fingerprint(JaxFLConfig(**kw))
