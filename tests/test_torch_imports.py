"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
entry points that run on the card unless the caller asks for the CPU."""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.fast

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsne_flink_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tsne_flink_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    # exact module or a submodule of it: tsne_flink_tpu_torch is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exact_names_only():
    assert _forbidden("tsne_flink_tpu") and _forbidden("tsne_flink_tpu.ops")
    assert _forbidden("jax.numpy")
    assert not _forbidden("tsne_flink_tpu_torch.ops.knn")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_imports_without_a_toolkit():
    for path in sorted(PORT.rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))


def test_entry_points_default_to_the_card():
    """With no device given, the entry points run on CUDA — and with no
    card they raise instead of falling back to the CPU."""
    from tsne_flink_tpu_torch import TSNE, convert, tsne_embed
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    from tsne_flink_tpu_torch.utils.cli import main
    from tsne_flink_tpu_torch.utils.device import resolve_device

    from tsne_flink_tpu_torch.serve.model import PlanConfig, from_arrays
    x = np.zeros((20, 3), np.float32)
    calls = [lambda: tsne_embed(x),
             lambda: from_arrays(x, x[:, :2], PlanConfig(n=20, d=3, k=5)),
             lambda: prepare(x, neighbors=5, perplexity=2.0),
             lambda: convert.state_from_numpy(x[:, :2]),
             lambda: TSNE().fit(x),
             lambda: main(["--input", "in.csv", "--output", "o.csv",
                           "--dimension", "3", "--knnMethod", "auto"]),
             lambda: main(["--input", "in.csv", "--output", "o.csv",
                           "--dimension", "3", "--knnMethod", "auto",
                           "--model", "m.npz", "--transform", "q.csv"])]
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert convert.state_from_numpy(x[:, :2]).y.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert resolve_device("cpu").type == "cpu"
