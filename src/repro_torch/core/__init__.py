"""Core library: the paper's accumulation-of-sub-sampling sketching framework
(the ported slices: sketches and schemes, structural and matrix-free
applies, the progressive engine, KRR and spectral clustering)."""
from repro_torch.core.sketch import (
    AccumSketch,
    AccumState,
    append_subsample,
    make_accum_sketch,
    make_gaussian_sketch,
    make_nystrom_sketch,
)
from repro_torch.core.apply import (
    accum_grow,
    accum_grow_adaptive,
    accum_grow_batched,
    accum_grow_doubling,
    accum_init,
    accum_step,
    doubling_schedule,
    gram_sketch,
    grow_sketch_both,
    make_holdout_estimator,
    make_hutchinson_estimator,
    sketch_both,
    sketch_kernel_cols,
    sketch_left,
    sketch_right,
    sketch_vec,
    unsketch_mat,
    unsketch_vec,
)
from repro_torch.core.kernel_op import KernelOperator, stream_cols, stream_cols_slabs
from repro_torch.core.krr import (
    SketchedKRR,
    insample_error,
    krr_exact_fit,
    krr_exact_fitted,
    krr_sketched_fit,
    krr_sketched_fit_adaptive,
    krr_sketched_fit_dense,
    krr_sketched_fit_matfree,
    krr_sketched_fit_pcg,
    krr_sketched_fit_pcg_adaptive,
)
from repro_torch.core.spectral import (
    SpectralResult,
    kmeans,
    nystrom_eigh,
    sketched_degrees,
    sketched_spectral_embedding,
    spectral_cluster,
)
from repro_torch.core.kernels_math import (
    gaussian_kernel,
    get_kernel,
    laplacian_kernel,
    matern_kernel,
)

__all__ = [n for n in dir() if not n.startswith("_")]
