from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams

__all__ = ["D2Q9", "LBMParams"]
