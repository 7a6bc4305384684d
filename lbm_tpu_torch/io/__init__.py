from lbm_tpu_torch.io.files import (
    read_obstacles,
    read_params,
    write_av_vels,
    write_final_state,
)

__all__ = [
    "read_params",
    "read_obstacles",
    "write_av_vels",
    "write_final_state",
]
