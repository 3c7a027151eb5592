"""Mamba-2 SSD: the Hopper intra-chunk kernel and the chunked scan op."""
