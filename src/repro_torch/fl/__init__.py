from repro_torch.fl.simulation import FLConfig, run_simulation  # noqa: F401
