"""mfu: the operations the window's requests' mathematics needs (the
entry's work counts, ``h100bench.lib.work``) over their wall-clock times
the H100's published peak of the configuration's dtype, in %: float32 67
TFLOP/s (outside the tensor cores; TF32 stays off), float64 67 TFLOP/s
(its tensor-core rate, the highest it has)."""

from h100bench.lib.work import H100_FP32_FLOPS, H100_FP64_TC_FLOPS


def read(ctx, variant):
    if not ctx.records:
        return None
    ops = sum(ctx.work(r)[0] for r in ctx.records)
    wall = sum(r["wall_s"] for r in ctx.records)
    peak = H100_FP32_FLOPS if ctx.cfg["dtype"] == "float32" else H100_FP64_TC_FLOPS
    return 100.0 * ops / (wall * peak)
