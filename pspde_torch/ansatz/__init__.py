from .nets import DenseNet, LinearLQ, LinearLQTime, ScalarParam, TanhMLP

__all__ = ["DenseNet", "LinearLQ", "LinearLQTime", "ScalarParam", "TanhMLP"]
