"""K3 (``kernels/csrc/sw.cu`` ``wave_kernel``, the re-rank's Smith-Waterman
sweep) against its roofline: the least time the work of the profiled
batches needs (``bench/roofline.py``) over K3's device time there (%)."""
from bench.readers import kernel_s
from bench.roofline import sw_wave_bound_s


def _k3(name):
    return "wave_kernel" in name and "rowwave" not in name


def read(ctx):
    k3 = kernel_s(ctx, _k3)
    if k3 <= 0:
        return None
    bound = 0.0
    for r in ctx.profiled:
        if r.out is not None:
            q, ref = ctx.driver.rerank_pairs(r.spec, r.out)
            if q.size:
                bound += sw_wave_bound_s(q, ref, ctx.driver.cfg.gap_mode)[0]
    return 100.0 * bound / k3 if bound > 0 else None
