"""Primitives built on the ops layer: sponges, CRHs, Merkle trees."""
