"""linalg_ms: device milliseconds per profiled request in cuSOLVER and
cuBLAS kernels (factorisations, triangular solves, matrix products),
matched by name."""

import re

#: Kernel-name fragments of cuSOLVER's and cuBLAS's kernels.
PATTERNS = re.compile(r"potrf|trsm|trsv|gemm|gemv|syrk|herk|xmma|cutlass|getrf|cholesky|"
                      r"dot_kernel|trmm|symm|lascl|laswp|larf", re.I)
#: The program's own Gram kernels, which are not linear algebra here.
GRAM = re.compile(r"gram_", re.I)


def read(ctx, variant):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(lambda name: bool(PATTERNS.search(name)) and not GRAM.search(name))
    return 1e3 * s / len(ctx.traced)
