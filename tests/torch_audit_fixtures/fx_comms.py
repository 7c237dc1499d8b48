import torch


def gather_rows(axis):
    return axis.all_gather(torch.ones(64, 2))  # VIOLATION


def scalar_psum(axis):
    return axis.psum(torch.ones(()))  # clean: no N-scaling payload
