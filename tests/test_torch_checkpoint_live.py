"""A JAX run continued in the port: the JAX package's sync engine is
killed right after its first checkpoint save (``RoundEngine(...,
halt_counter=)``), the manifest is loaded by the port and carried into its
resume state (:mod:`repro_torch.checkpoint.from_jax`), and the port runs
the rest.  The result is held to the JAX package's uninterrupted run by
``tests/torch_live.py``'s checks: picks and model choices identical,
weights, energy and reward at ``TOL``.

Arms, at the live tests' size (``torch_live.BASE``: n 8, width 0.125, 8x8,
3 rounds, the per-client executor): greedy, through the port's own
``run_simulation(resume=True)``, which finds the JAX manifest by itself;
MARL with ε = 0 on both sides (the JAX act key has no torch counterpart),
whose QMIX update after the resume starts from the carried learner and
replay; and the transformer family's DR-FL, whose blocks run ``rmsnorm``
(its plain version on the CPU) after the resume.  An async JAX checkpoint
is carried too (``tests/test_torch_checkpoint_async*.py``); a manifest of
any other mode raises ``ValueError``.
"""
import dataclasses

import pytest
import torch

from repro.checkpoint import CheckpointHalt as JaxCheckpointHalt
from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro_torch.checkpoint.from_jax import resume_state_from_jax
from repro_torch.fl import simulation as tsim
from repro_torch.fl.engine import RoundEngine
from torch_live import BASE, _eps_zero, assert_runs_agree

torch.set_num_threads(1)

ARMS = {
    "drfl-greedy": dict(selector="greedy"),
    "drfl-marl": dict(),
    "transformer-drfl-greedy": dict(selector="greedy",
                                    model_family="transformer",
                                    width_mult=0.25),
}


def _jax_run(cfg, halt=None):
    """One JAX engine run from a fresh selector (and buffer), ε = 0."""
    sel, buf = jsim._make_selector(cfg, 4), None
    if cfg.selector == "marl":
        buf = jsim._make_buffer(cfg)
        _eps_zero(sel)
        sel.reset_episode()
    return JaxRoundEngine(cfg, sel, buf, halt_counter=halt).run(), sel


@pytest.mark.parametrize("arm", list(ARMS))
def test_jax_checkpoint_resumes_in_the_port(arm, tmp_path):
    kw = dict(BASE, **ARMS[arm])
    jh, jsel = _jax_run(jsim.FLConfig(**kw))
    ck = dict(kw, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    with pytest.raises(JaxCheckpointHalt):
        _jax_run(jsim.FLConfig(**ck), halt={"remaining": 1})
    tcfg = tsim.FLConfig(**ck, resume=True)
    if arm == "drfl-greedy":
        th = tsim.run_simulation(tcfg, device="cpu")
        tsel = None
    else:
        state, meta = tsim.load_resume_state(tcfg)
        assert meta["format"] == "drfl-engine" and state["next_round"] == 1
        tsel = tsim._make_selector(tcfg, 4, device="cpu")
        buf = None
        if tcfg.selector == "marl":
            _eps_zero(tsel)
            buf = tsim._make_buffer(tcfg)
        th = RoundEngine(tcfg, tsel, buf, device="cpu",
                         resume_state=state).run()
    assert th["phase_s"][0] == {} and th["phase_s"][-1]
    assert_runs_agree(kw, jh, th, jsel, tsel, "perclient")
    if arm == "drfl-marl":
        assert th["qmix"]["updates"] == jsel.learner.updates >= 1


def test_unknown_jax_checkpoint_mode_raises():
    """Both engine modes are carried (the async arms are in
    ``tests/test_torch_checkpoint_async*.py``); any other mode raises."""
    cfg = tsim.FLConfig(**dict(BASE, engine_mode="async"))
    for mode in ("pipelined", None):
        with pytest.raises(ValueError, match="unknown engine_mode"):
            resume_state_from_jax({"mode": mode}, cfg)
        with pytest.raises(ValueError, match="expected 'sync' or 'async'"):
            resume_state_from_jax({"mode": mode},
                                  dataclasses.replace(cfg, engine_mode="sync"))
