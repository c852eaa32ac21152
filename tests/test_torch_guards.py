"""Guards of the port's boundaries: it imports with jax absent and imports
nothing of the JAX package; its entry points run on the card unless the
caller asks for the CPU, with no fallback; every setting the reference
rejects raises its ``ValueError``, and every setting a slice ported runs
(since the fleet mesh, every setting the reference accepts: none raises
``NotImplementedError``; since the MoE family, every LM family builds)."""
import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.selection import resolve_mixer_mode
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.fl.engine import check_supported

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "drfl_e2e_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "serve_lm_torch.py"]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s]|$)",
                       re.M)


def test_port_imports_with_jax_absent():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith(('repro.', 'jax.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_port_sources(path):
    assert path.exists(), path
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_run_simulation_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    cfg = FLConfig(n_devices=64, n_rounds=1, width_mult=0.125, hw=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_simulation(cfg)


BASE = dict(n_devices=64, n_rounds=1, width_mult=0.125, hw=8, n_train=640)


ASYNC = dict(engine_mode="async")


@pytest.mark.parametrize("change,item", [
    (dict(fault_corrupts=1, fault_horizon=100.0), ValueError),
    (dict(model_family="resnet9000"), ValueError),
    (dict(engine_mode="sync", fault_crashes=1, fault_horizon=100.0),
     ValueError),
])
def test_unported_settings_raise(change, item):
    """A setting the reference rejects (a fault plan on the sync engine:
    faults need the timeline; a family nobody registered) raises the
    reference's ``ValueError``, message for message, before any device
    work.  No setting the reference accepts is outside the port any more
    (the fleet mesh, the last, runs: below)."""
    cfg = dataclasses.replace(FLConfig(**BASE), **change)
    if item is ValueError:
        from repro.fl.simulation import FLConfig as JaxFLConfig
        from repro.fl.spec import ensure_flat_config as jax_ensure
        with pytest.raises(ValueError) as ref:
            jax_ensure(JaxFLConfig(**dataclasses.asdict(cfg)))
        with pytest.raises(ValueError) as got:
            run_simulation(cfg, device="cpu")
        assert str(got.value) == str(ref.value)
        return
    with pytest.raises(NotImplementedError, match=item):
        run_simulation(cfg, device="cpu")


#: a fleet above the 256 devices at which "auto" takes the factored QMIX
#: state and the set mixer, kept tiny: about 3 samples a device, 6 picks
FLEET_SCALE = dict(n_devices=300, participation=0.02, n_train=900)


#: checkpoints every round, into a directory the test makes
CHECKPOINTS = dict(checkpoint_dir="ckpt", checkpoint_every=1)


@pytest.mark.parametrize("change", [
    dict(n_devices=40), dict(client_executor="perclient"),
    dict(method="heterofl"), dict(selector="greedy"),
    dict(mixer_mode="set"), FLEET_SCALE, dict(ASYNC, mixer_mode="set"),
    dict(ASYNC, **FLEET_SCALE), CHECKPOINTS, dict(ASYNC, **CHECKPOINTS),
    dict(fleet_mesh=2), dict(ASYNC, fleet_mesh=-1)],
    ids=["n_devices=40", "perclient", "heterofl", "greedy", "mixer_mode=set",
         "n_devices=300", "async-mixer_mode=set", "async-n_devices=300",
         "checkpoints", "async-checkpoints", "fleet_mesh=2",
         "async-fleet_mesh=-1"])
def test_formerly_unported_settings_run(change, tmp_path):
    """The per-client executor, the baseline arms, the other selectors,
    MARL at fleet scale (the set mixer; above 256 devices the factored
    state too), checkpoints and the fleet mesh (a no-op with no process
    group, as the reference on one device) are ported: these settings,
    once refused, run on the CPU, a sync round aggregating once, an async
    run at most once a task and its QMIX learner trained at the episode's
    end; a checkpointed run leaves its manifest."""
    kw = dict(BASE, n_devices=8, n_train=400, participation=0.5,
              local_epochs=1)
    kw.update(change)
    if "checkpoint_dir" in change:
        kw["checkpoint_dir"] = str(tmp_path / change["checkpoint_dir"])
    cfg = FLConfig(**kw)
    hist = run_simulation(cfg, device="cpu")
    if cfg.checkpoint_dir:
        names = os.listdir(cfg.checkpoint_dir)
        assert "ep0000_step00000001.manifest.json" in names
    assert len(hist["acc"]) == 1
    assert hist["executor"] == ("perclient" if cfg.n_devices < 64
                                else "batched")
    if cfg.engine_mode == "sync":
        assert hist["n_aggregations"] == 1
    else:
        # a device without samples completes its task with no delta
        assert 1 <= hist["n_aggregations"] <= hist["n_tasks"]
        assert hist["qmix"]["mixer_mode"] == resolve_mixer_mode(
            cfg.mixer_mode, cfg.n_devices)
        assert hist["qmix"]["updates"] >= 1


@pytest.mark.parametrize("change", [
    dict(ASYNC, availability_profile="diurnal"),
    dict(availability_profile="diurnal"),
    dict(ASYNC, hotplug_n=4, global_budget_j=1e5),
    dict(charge_profile="solar", charge_rate=0.1),
    dict(global_budget_j=1e5)],
    ids=["async-diurnal", "diurnal", "async-hotplug-budget", "solar",
         "budget"])
def test_energy_scenario_settings_run(change):
    """The energy scenarios are ported: these settings, once refused, pass
    ``check_supported`` and run on the CPU, a budget with its record."""
    kw = dict(BASE, n_devices=8, n_train=400, participation=0.5,
              local_epochs=1, selector="greedy")
    kw.update(change)
    cfg = FLConfig(**kw)
    check_supported(cfg)
    hist = run_simulation(cfg, device="cpu")
    assert hist["n_aggregations"] >= 1
    assert ("budget" in hist) == (cfg.global_budget_j > 0)
    if "budget" in hist:
        assert 0 < hist["budget"]["spent"] <= cfg.global_budget_j


def test_unknown_energy_profile_raises_the_references_error():
    for change, what in ((dict(charge_profile="fusion"), "charge"),
                         (dict(availability_profile="sometimes"),
                          "availability")):
        cfg = dataclasses.replace(FLConfig(**BASE), **change)
        with pytest.raises(ValueError, match=f"unknown {what} profile"):
            check_supported(cfg)


def test_flconfig_fields_and_defaults_equal_the_jax_config():
    from repro.fl.simulation import FLConfig as JaxFLConfig
    ours = {f.name: f.default for f in dataclasses.fields(FLConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxFLConfig)}
    assert ours == theirs


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_lm_launchers_default_to_cuda_and_never_fall_back(entry):
    """``repro_torch.launch.serve`` and ``.train`` run on the card unless
    ``--device cpu`` is passed; without a card their default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.launch import serve, train
    main = {"serve": serve.main, "train": train.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "1"]
             if entry == "train" else ["--smoke"])


@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_family_builds_and_launches_on_cpu(arch, entry):
    """mixtral-8x22b and qwen3-moe-235b-a22b (``moe``, once refused with
    ``NotImplementedError``) build, mixtral as ``sub_quadratic`` (its
    window) and qwen3 not, as in the reference, and the serve and train
    mains run their smoke configs on ``--device cpu``: the server decodes
    through the gather path, the trainer's loss carries the router's aux
    term."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.api import build
    model = build(get_config(arch))
    assert model.sub_quadratic == (arch == "mixtral-8x22b")
    assert model.cfg.num_experts and model.cfg.name == arch
    common = ["--arch", arch, "--smoke", "--device", "cpu"]
    if entry == "serve":
        out = serve.main(common + ["--slots", "2", "--requests", "3",
                                   "--prompt-len", "4", "--max-new", "3"])
        assert [len(o) for o in out["outputs"]] == [3, 3, 3]
    else:
        out = train.main(common + ["--steps", "2", "--batch", "2", "--seq",
                                   "32"])
        assert len(out["losses"]) == 2
        assert all(math.isfinite(l) for l in out["losses"])


@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_cross_attention_families_build_and_launch_on_cpu(arch, entry):
    """llama-3.2-vision-11b (``vlm``) and whisper-medium (``audio``) build,
    not as ``sub_quadratic`` models, and the serve and train mains run
    their smoke configs on ``--device cpu``: the server attends to its
    drawn stub embeddings, the trainer feeds zeros, as the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.api import build, extra_inputs
    model = build(get_config(arch))
    assert not model.sub_quadratic and model.cfg.name == arch
    assert list(extra_inputs(model.cfg, 1, 1)) == [
        {"vlm": "image_embeds", "audio": "audio_frames"}[model.cfg.family]]
    common = ["--arch", arch, "--smoke", "--device", "cpu"]
    if entry == "serve":
        out = serve.main(common + ["--slots", "2", "--requests", "3",
                                   "--prompt-len", "4", "--max-new", "3"])
        assert [len(o) for o in out["outputs"]] == [3, 3, 3]
    else:
        out = train.main(common + ["--steps", "2", "--batch", "2", "--seq",
                                   "32"])
        assert len(out["losses"]) == 2
        assert all(math.isfinite(l) for l in out["losses"])


@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_sub_quadratic_families_build_and_launch_on_cpu(arch, entry):
    """xlstm-1.3b (``ssm``) and zamba2-1.2b (``mamba-hybrid``) build, as
    ``sub_quadratic`` models, and the serve and train mains run their
    smoke configs on ``--device cpu``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.api import build
    model = build(get_config(arch))
    assert model.sub_quadratic and model.cfg.name == arch
    common = ["--arch", arch, "--smoke", "--device", "cpu"]
    if entry == "serve":
        out = serve.main(common + ["--slots", "2", "--requests", "3",
                                   "--prompt-len", "4", "--max-new", "3"])
        assert [len(o) for o in out["outputs"]] == [3, 3, 3]
    else:
        out = train.main(common + ["--steps", "2", "--batch", "2", "--seq",
                                   "32"])
        assert len(out["losses"]) == 2
        assert all(math.isfinite(l) for l in out["losses"])
