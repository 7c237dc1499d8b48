import torch


def f(x):
    a = x.to(torch.float64)  # VIOLATION
    b = x.double()  # VIOLATION
    c = torch.tensor(0.5)  # VIOLATION
    d = torch.tensor([1.0, 2.0], device=x.device)  # VIOLATION
    e = torch.tensor(0.5, dtype=x.dtype)  # clean: the computation dtype
    g = torch.tensor(3)  # clean: an integer literal
    h = x.double()  # graftlint: disable=dtype-drift -- the suppressed twin
    return a, b, c, d, e, g, h


def g(x, matmul_dtype=None):
    a = x.to(torch.bfloat16)  # VIOLATION
    b = x.bfloat16()  # VIOLATION
    c = x.to(matmul_dtype)  # clean: the threaded operand dtype
    return a, b, c
