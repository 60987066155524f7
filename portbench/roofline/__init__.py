"""Least times of the kernels on the chip: what each call's inputs need,
in bytes and in operations, against the chip's published peaks."""
