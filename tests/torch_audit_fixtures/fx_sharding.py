import torch


def extra_collective(axis):
    x = torch.ones(2)
    axis.all_gather(x)
    if axis.index == 1:
        axis.all_gather(x)  # VIOLATION
    return x


def shape_mismatch(axis):
    x = torch.ones(2 + axis.index)
    return axis.all_gather(x)  # VIOLATION


def matched(axis):
    x = torch.ones(2)
    return axis.psum(axis.all_gather(x).sum())
