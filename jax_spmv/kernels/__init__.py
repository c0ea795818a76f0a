from .csr_vector import VectorCSR, spmv_csr_vector
from .ell_kernel import spmv_ell_device
from .scalar import spmv_csr_scalar

__all__ = [
    "spmv_csr_scalar",
    "VectorCSR",
    "spmv_csr_vector",
    "spmv_ell_device",
]
