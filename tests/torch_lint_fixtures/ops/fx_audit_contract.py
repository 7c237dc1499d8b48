from tsne_flink_tpu_torch.kernels.build import KERNELS


def launches_b2(y):  # VIOLATION
    KERNELS["B2"](y.data_ptr())


def cuda_exact_repulsion(y):  # clean: the port's registry declares it
    KERNELS["B2"](y.data_ptr())


# graftlint: disable=audit-contract -- the suppressed twin
def launches_b5(y):
    KERNELS["B5"].entry("tsne_attraction_forces_f32", y.data_ptr())


def main_path_op(x):  # VIOLATION
    return x


def helper(x):  # clean: no kernel, not on the main path
    return x
