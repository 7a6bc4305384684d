"""Utility subpackage: checker and geometry.

Submodules are imported lazily so ``python -m lbm_tpu_torch.utils.checker``
runs without the double-import runpy warning.
"""

__all__ = ["CheckResult", "check_files"]


def __getattr__(name):
    if name in __all__:
        from lbm_tpu_torch.utils import checker

        return getattr(checker, name)
    raise AttributeError(name)
