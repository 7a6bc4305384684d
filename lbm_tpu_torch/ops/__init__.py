from lbm_tpu_torch.ops.reference import (
    accelerate_flow,
    collide,
    lbm_step_reference,
    stream,
)

__all__ = ["accelerate_flow", "stream", "collide", "lbm_step_reference"]
