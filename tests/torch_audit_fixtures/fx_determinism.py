import torch


def shard_fn(axis):
    x = torch.ones(4)
    acc = torch.zeros(2)
    acc.index_add_(0, torch.tensor([0, 0, 1, 1]), x)  # VIOLATION
    total = axis.psum(torch.sum(x))  # VIOLATION
    count = axis.psum(torch.tensor(4, dtype=torch.int32))  # clean: exact
    top = axis.pmax(torch.max(x))  # clean: a maximum is order-free
    ordered = torch.segment_reduce(x, "sum", lengths=torch.tensor([2, 2]))
    return acc, total, count, top, ordered
