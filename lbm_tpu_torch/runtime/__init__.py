from lbm_tpu_torch.runtime.driver import SimulationResult, run_simulation

__all__ = ["SimulationResult", "run_simulation"]
