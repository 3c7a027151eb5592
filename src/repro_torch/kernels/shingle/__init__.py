"""k-sequential shingle keys: the Hopper kernel and its public op."""
