from .nets import (Affine, BatchNormMLP, ConcatSkipNet, ConstantVector,
                   DenseNet, DenseNetRelu, DenseNetTanh, DenseNetTanh2,
                   LinearLQ, LinearLQTime, ReluMLP1d, ScalarParam, Sines,
                   TanhMLP)

__all__ = ["Affine", "BatchNormMLP", "ConcatSkipNet", "ConstantVector",
           "DenseNet", "DenseNetRelu", "DenseNetTanh", "DenseNetTanh2",
           "LinearLQ", "LinearLQTime", "ReluMLP1d", "ScalarParam", "Sines",
           "TanhMLP"]
