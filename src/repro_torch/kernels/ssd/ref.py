"""Plain oracle of the SSD op: the same scan with the intra-chunk step's
plain version, on whatever device the tensors lie (never the kernel)."""
from repro_torch.kernels.ssd.kernel import ssd_intra_plain
from repro_torch.kernels.ssd.ops import ssd_scan


def ssd_chunked(x, dt, A, B_, C_, D, *, chunk: int = 128, bf16_intra: bool = False):
    """As :func:`repro_torch.kernels.ssd.ops.ssd_chunked`, through
    :func:`~repro_torch.kernels.ssd.kernel.ssd_intra_plain`."""
    return ssd_scan(x, dt, A, B_, C_, D, chunk=chunk, bf16_intra=bf16_intra,
                    intra=ssd_intra_plain)
