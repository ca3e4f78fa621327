"""Core library: the paper's accumulation-of-sub-sampling sketching framework
(the ported slice: sketches, structural and matrix-free applies, KRR)."""
from repro_torch.core.sketch import (
    AccumSketch,
    make_accum_sketch,
    make_gaussian_sketch,
    make_nystrom_sketch,
)
from repro_torch.core.apply import (
    gram_sketch,
    sketch_both,
    sketch_kernel_cols,
    sketch_left,
    sketch_right,
    sketch_vec,
    unsketch_mat,
    unsketch_vec,
)
from repro_torch.core.kernel_op import KernelOperator, stream_cols
from repro_torch.core.krr import (
    SketchedKRR,
    insample_error,
    krr_exact_fit,
    krr_exact_fitted,
    krr_sketched_fit,
    krr_sketched_fit_dense,
    krr_sketched_fit_matfree,
    krr_sketched_fit_pcg,
)
from repro_torch.core.kernels_math import (
    gaussian_kernel,
    get_kernel,
    laplacian_kernel,
    matern_kernel,
)

__all__ = [n for n in dir() if not n.startswith("_")]
