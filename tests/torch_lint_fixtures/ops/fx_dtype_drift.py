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
