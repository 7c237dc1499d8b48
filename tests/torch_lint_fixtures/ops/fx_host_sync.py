import torch


def hot(x: torch.Tensor, exag, n):
    a = x.sum().item()  # VIOLATION
    b = x.tolist()  # VIOLATION
    c = x.cpu()  # VIOLATION
    d = x.numpy()  # VIOLATION
    torch.cuda.synchronize()  # VIOLATION
    s = torch.sum(x)
    e = float(s)  # VIOLATION
    f = int(torch.max(x))  # VIOLATION
    g = float(exag)  # clean: a Python scalar passed to a launch
    h = int(x.shape[0])  # clean: a shape is a host value
    k = float(n * 2)  # clean: host arithmetic
    t = x.sum().item()  # graftlint: disable=host-sync -- the suppressed twin
    return a, b, c, d, e, f, g, h, k, t
