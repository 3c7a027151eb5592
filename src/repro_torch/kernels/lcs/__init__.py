from repro_torch.kernels.lcs.ops import lcs
from repro_torch.kernels.lcs.fused import fused_gather_score, fused_score
