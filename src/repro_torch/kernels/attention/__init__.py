"""Flash attention: the Hopper kernel and its public op."""
