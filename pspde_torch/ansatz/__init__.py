from .nets import ScalarParam, TanhMLP

__all__ = ["ScalarParam", "TanhMLP"]
