import torch

#: the operand policy module names the bf16 dtype: no finding here
MATMUL_DTYPES = (torch.bfloat16,)


def matmul_operands(a, b, dtype=None):
    if dtype is None:
        return a, b
    return a.to(dtype).to(a.dtype), b.bfloat16().to(b.dtype)


def kernel_float64(x):
    # the blessed dispatch test: it may name float64
    return x.dtype == torch.float64


def elsewhere(x):
    return x.dtype == torch.float64  # VIOLATION
