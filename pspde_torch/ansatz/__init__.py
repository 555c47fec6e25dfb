from .nets import DenseNet, ScalarParam, TanhMLP

__all__ = ["DenseNet", "ScalarParam", "TanhMLP"]
