import torch
import torch.distributed as dist

from tsne_flink_tpu_torch.parallel.mesh import MeshAxis, ProcessAxis


def f(rv):
    if dist.is_initialized():  # VIOLATION
        dist.barrier()  # VIOLATION
    torch.distributed.all_reduce(torch.ones(1))  # VIOLATION
    ax = MeshAxis(rv, 0)  # VIOLATION
    pa = ProcessAxis()  # VIOLATION
    d = dist.astype("float32")  # clean: not the torch.distributed API
    r = dist.get_rank()  # graftlint: disable=mesh-hygiene -- the suppressed twin
    return ax, pa, d, r
