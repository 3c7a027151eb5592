"""Plain oracle for the minhash kernel: the plain version on the same
``(a, b)`` table the op builds, on whatever device the tensors lie."""
import torch

from repro_torch.core.minhash import hash_table
from repro_torch.kernels.minhash.kernel import minhash_plain


def minhash_signatures(types: torch.Tensor, lengths: torch.Tensor, *,
                       num_perm: int = 16, seed: int = 0) -> torch.Tensor:
    """int32 [N, L] + [N] -> int32 [N, num_perm], never through the kernel."""
    return minhash_plain(types, lengths, hash_table(num_perm, seed, types.device))
