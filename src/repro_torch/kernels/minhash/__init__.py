"""MinHash signatures: the Hopper kernel and its public op."""
