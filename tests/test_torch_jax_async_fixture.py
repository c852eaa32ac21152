"""The committed async JAX checkpoint (``tests/data/jax_async_ckpt/``,
written by ``scripts/make_jax_async_checkpoint.py``) resumed in the port
on the CPU, with no jax, and held to the record of the uninterrupted JAX
run beside it: DR-FL, greedy, the async engine and the bucketed executor,
the ``mlp`` family at n 8 on 8x8 inputs, killed after its first virtual
round's save with two ``delta1`` rows in flight.  Picks, model choices,
staleness and the task log must equal the record's (times at rtol 1e-4),
every row's accuracy must be within one validation sample of it, and the
final weights must agree with the JAX run's at rtol 1e-4, atol 1e-5,
read through the record's probe digest (each leaf's dot product with a
fixed gaussian probe, held to the same tolerance carried through the
probe): the rows after the resume aggregate the converted delta rows.
``chip_smoke.py``'s ``[checkpoint from jax async]`` resumes the same
files on the card.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import EngineCheckpointer
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "jax_async_ckpt"
RECORD = json.loads((FIXTURE / "record.json").read_text())
_spec = importlib.util.spec_from_file_location(
    "make_jax_async_checkpoint",
    Path(__file__).parents[1] / "scripts" / "make_jax_async_checkpoint.py")
SCRIPT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SCRIPT)


def probe_misfit(params, record, rtol=1e-4, atol=1e-5):
    """Per leaf, the distance of ``params``' probe from the record's over
    the bound that weights at ``rtol``/``atol`` of it allow (a misfit
    above 1 is a weight out of tolerance)."""
    rng = np.random.default_rng(0)
    out = []
    for leaf, ref in zip(tree_leaves(params), record["weights_probe"],
                         strict=True):
        w = leaf.detach().cpu().double().numpy()
        g = rng.standard_normal(w.shape)
        got = float(np.sum(w * g))
        out.append(abs(got - ref) / float(np.sum(np.abs(g)
                                                 * (atol + rtol * np.abs(w)))))
    return out


def assert_matches_record(hist, record):
    for key in ("participants", "model_choices", "staleness", "n_tasks",
                "n_aggregations"):
        assert hist[key] == record[key], key
    n_val = max(64, int(0.04 * record["config"]["n_train"]))
    np.testing.assert_allclose(hist["acc_mean"], record["acc_mean"], rtol=0,
                               atol=1.0 / n_val + 1e-6)
    assert len(hist["task_log"]) == len(record["task_log"])
    for got, ref in zip(hist["task_log"] + [hist["terminated"]],
                        record["task_log"] + [record["terminated"]]):
        assert set(got) == set(ref)
        for k, v in ref.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
            else:
                assert got[k] == v, (k, got, ref)


def test_record_is_the_bucketed_greedy_async_config():
    cfg = FLConfig(**RECORD["config"])
    assert (cfg.engine_mode, cfg.selector, cfg.client_executor,
            cfg.model_family) == ("async", "greedy", "batched", "mlp")
    assert RECORD["n_tasks"] == len(RECORD["task_log"]) > 2
    assert sum(f.stat().st_size for f in FIXTURE.iterdir()) < 200_000
    manifest = json.loads(next(FIXTURE.glob("*.manifest.json")).read_text())
    assert manifest["format"] == "drfl-engine"      # the JAX package's


def test_port_resumed_run_equals_the_jax_record(tmp_path):
    ck = tmp_path / "ck"
    shutil.copytree(FIXTURE, ck)
    saved, _ = EngineCheckpointer(str(ck)).load()
    assert saved["mode"] == "async"
    assert sum(t.get("delta1") is not None
               for t in saved["tasks"].values()) == 2
    hist = run_simulation(FLConfig(**RECORD["config"], checkpoint_dir=str(ck),
                                   resume=True), device="cpu")
    assert hist["phase_s"][0] == {}           # the JAX package's own row
    assert_matches_record(hist, RECORD)
    misfit = probe_misfit(hist["params"], RECORD)
    assert max(misfit) <= 1.0, misfit


def test_weights_probe_is_the_script_s():
    """The test's probe is the script's on the same weights."""
    leaves = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.ones(4, np.float32)]
    params = {"a": torch.tensor(leaves[0]), "b": torch.tensor(leaves[1])}
    record = {"weights_probe": SCRIPT.weights_probe(leaves)}
    assert probe_misfit(params, record) == [0.0, 0.0]
