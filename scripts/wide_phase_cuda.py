"""``chip_smoke.py``'s ``[wide]`` phase alone, on the card.

Embeddings wider than 8: B2w-B5w (the wide forms of B2-B5) and their
float64 forms at m = 9 .. 256 against their plain versions; then at
60,000 x 784 and n_components = 16 ``tsne_embed``, ``TSNE(dtype=
"float64")`` with one serving bucket, the project estimator against
config 2's command line at ``--nComponents 16``, a serving bucket of
that model (1 x 256 = 4 x 64 bit for bit) and the test mesh of 2 against
the mesh of 1; each form held against its plain version (and, at
float32, B4w / B5w against float64) at the m = 16 runs' final y on
[full]'s CSR and timed there; and, unlike the smoke, each form timed at
60k at m = 64 on a spread y (B2w's plain version there is not timed: it
takes seconds).  About two minutes on one H100.  ``--gates`` runs the
kernel checks at m = 9 .. 256 alone.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/wide_phase_cuda.py [--gates]

The card's name and power limit head the output; the last line is the
phase's records as JSON.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def full_csr(x_np):
    """[full]'s CSR layout of the blobs (k = 90, perplexity 30), built on
    the card as ``phase_kernels`` builds it."""
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import _plan_layout
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    prep = prepare(x_np, neighbors=cs.K, perplexity=cs.PERPLEXITY)
    _, csr = _plan_layout(prep.jidx, prep.jval,
                          TsneConfig(perplexity=cs.PERPLEXITY,
                                     attraction="csr"))
    return csr


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    try:
        if "--gates" in sys.argv[1:]:
            rec = cs.wide_kernel_gates()
        else:
            x, labels = cs.make_data()
            errs, times, bnds, launches, at_run, vs64, at64 = cs.phase_wide(
                x, labels, full_csr(x), m64=True)
            rec = {kid: {"launches": launches[kid], "max_abs_err": errs[kid],
                         "max_abs_err_at_run": at_run[kid],
                         "against_f64_at_run": vs64.get(kid),
                         "ms": times[kid][0], "plain_ms": times[kid][1],
                         "bound_ms": bnds[kid][0], "bound_by": bnds[kid][1],
                         "m64": at64[kid]} for kid in cs.WIDE_FORMS}
    except cs.SmokeFailure as e:
        print(f"wide_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    print("wide_phase_cuda: OK")
    print(cs.json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
